"""Rooflines of the port's hand kernels, from a configuration's shapes.

The arithmetic is ``chip_smoke.py``'s (``bound``, ``table_bounds``,
``k2_fwd_flops``, ``k2_bwd_flops`` and its K3 bound), copied so that a
change to the port cannot move it: a kernel's least time is the larger of
its bytes (each input read once, each output written once) over 3.35 TB/s
and its flops over 67 TFLOP/s of f32 on the CUDA cores (the one precision
these kernels compute in).  The numbers are of one NVIDIA H100 SXM at its
700 W limit (data sheet, dense rates).

``LAUNCH_BOUNDS[wrapper](settings, bags)`` is the bound in seconds of one
launch of a wrapper of ``ops/launches.py`` at the cell's shapes;
``KERNEL_NAMES[wrapper]`` are the CUDA functions that launch issues, as
the profiler names them.  A wrapper without an entry has no roofline here.
"""

from __future__ import annotations

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from .shapes import CPB_HID, GROUPS, KNN_K, attn_shape


def bound(nbytes: float, flops: float) -> float:
    """The least time of the card for the work, seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def table_bounds(table_numel: int, rows: int, side: int,
                 out_bytes: int = 4) -> tuple:
    """``(forward, backward)`` of a table kernel (K1, K5): the forward
    reads the table, taps and fractions once and writes the windows, 9
    flops a value; the backward reads the window cotangent, the table, taps
    and fractions and writes the table and fraction cotangents, 16 flops a
    value."""
    values = rows * side * side
    small = 4 * table_numel + 16 * rows
    return (bound(small + out_bytes * values, 9 * values),
            bound(small + 4 * table_numel + 8 * rows + out_bytes * values,
                  16 * values))


def k2_fwd_flops(points: int, o: int = 1, hid: int = CPB_HID) -> int:
    """The exact CPB MLP 2 -> hid -> hid -> o at ``points`` pairs."""
    return points * 2 * (2 * hid + hid * hid + hid * o)


def k2_bwd_flops(points: int, o: int = 1, hid: int = CPB_HID) -> int:
    """The forward recomputed, then the cotangents through w3, w2 (and its
    outer product) and w1."""
    return k2_fwd_flops(points, o, hid) + points * 2 * (
        hid * o + 2 * hid * hid + 2 * hid)


def _rows(settings, bags):
    a = attn_shape(settings)
    return a, bags * GROUPS * a.k


def _out_bytes(settings):
    return 2 if settings.get("cpb_table_bf16") else 4


def k1_fwd(settings, bags):
    a, rows = _rows(settings, bags)
    return table_bounds(a.tn * a.tn, rows, a.side, _out_bytes(settings))[0]


def k1_bwd(settings, bags):
    a, rows = _rows(settings, bags)
    return table_bounds(a.tn * a.tn, rows, a.side, _out_bytes(settings))[1]


def k2_fwd(settings, bags):
    a, rows = _rows(settings, bags)
    points = rows * a.n
    return bound(4 * (points + 2 * a.n + 2 * rows), k2_fwd_flops(points))


def k2_bwd(settings, bags):
    a, rows = _rows(settings, bags)
    points = rows * a.n
    return bound(4 * (points + 4 * rows + 2 * a.n), k2_bwd_flops(points))


def _k3(settings, bags, out_words):
    """K3: every distance an f32 FMA chain over the token width."""
    n, c = int(settings["fixdim"]), int(settings["path_dim"])
    x_bytes = 4 * (bags * n * c + bags * n)
    return bound(x_bytes + 4 * bags * n * out_words, 2 * bags * n * n * c)


def k3_knn(settings, bags):
    return _k3(settings, bags, KNN_K + 1)


def k3_parent(settings, bags):
    return _k3(settings, bags, 2)


LAUNCH_BOUNDS = {"k1_fwd": k1_fwd, "k1_bwd": k1_bwd, "k2_fwd": k2_fwd,
                 "k2_bwd": k2_bwd, "k3_knn": k3_knn, "k3_parent": k3_parent}
# K3-knn and K3-parent are instances of the same two functions, and so are
# K1-bwd and K5-bwd: where two wrappers share names, their times are read
# together and so are their bounds
KERNEL_NAMES = {
    "k1_fwd": ("cpb_table_interp_fwd_kernel",),
    "k1_bwd": ("table_bwd_tile_kernel", "table_bwd_finish_kernel"),
    "k2_fwd": ("cpb_exact_fwd_kernel",),
    "k2_bwd": ("cpb_exact_bwd_partial_kernel", "sum_partials_kernel"),
    "k3_knn": ("dpc_split_kernel", "dpc_finish_kernel"),
    "k3_parent": ("dpc_split_kernel", "dpc_finish_kernel"),
}

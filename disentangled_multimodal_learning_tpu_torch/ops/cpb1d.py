"""The 1-D table CPB of ``DeformCrossAttention1D``: the counterpart of
``cpb_bias_table_1d`` in
``disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py`` (:2759).

The 1-coordinate relu MLP (``w1 [1, 32]``, ``w2 [32, 32]``, ``w3 [32, O]``,
the JAX layout) runs once on a lattice whose spacing is the query spacing
``2 / (n_q - 1)`` (:func:`cpb_table_1d`, plain torch in full f32), and each
kv row's bias over the ``n_q`` queries is a linear blend of two adjacent
offsets of each channel's table row (:func:`table1d_interp`, kernel K4 in
``csrc/cpb_table_1d.cu``, its backward in ``csrc/cpb_table_1d_bwd.cu``).
The bias comes out kv-major, ``[B*G, O, K, n_q]`` = ``[B, H, K, N]``, the
layout the attention consumes; JAX builds ``[R, O, n_q]`` and transposes.
Autograd carries the table cotangent back to the MLP weights, and the
shift cotangent back to ``grid_kv`` (``-dshift / s``).

Wrapper rule, as in ``ops/cpb.py``: a tensor on the CPU goes to the plain
PyTorch version (``*_reference``, also what the card's kernels are checked
against); a CUDA tensor launches the kernel or raises.  There is no
fallback.  :func:`table1d_interp` counts forward launches in
``table1d_interp.launches``, :func:`table1d_interp_backward` backward
launches in ``table1d_interp_backward.launches``, and nowhere else.  The
backward kernel is deterministic (two calls on the same inputs give
bitwise-equal results).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cpb import _on_card, _stream, table_consts

# K4-bwd (csrc/cpb_table_1d_bwd.cu): a block of 8 warps owns a tile of 1024
# consecutive entries of one channel (each warp 128: 4 strips of 32) and
# one group of rows; the rows split into groups for about this many blocks
# in all (four waves of 4 blocks on each of the H100's 132 SMs: the tiles'
# work differs, and the later waves even it out), a function of the shapes
# alone, so that the groups' partial tables are summed in one fixed order
TABLE1D_BWD_TILE = 1024
TABLE1D_BWD_BLOCKS = 2112
# and at most this many rows a group: a block lists its group's rows that
# meet its tile in shared memory (kMaxRows in csrc/cpb_table_1d_bwd.cu)
TABLE1D_BWD_ROWS_MAX = 1024
GRID_Y_MAX = 65535  # row groups are the grid's y dimension


def cpb_table_1d(w1, b1, w2, b2, w3, b3, *, n_q: int, kv_bound: float):
    """The MLP on the 1-D lattice ``t0 + s * arange(tn)`` (the geometry of
    :func:`~.cpb.table_consts` with ``side = n_q``): sign*log1p of each
    lattice point -> relu MLP -> ``[O, tn]`` f32.  Every bias value
    interpolates from this table, so its matmuls run in full f32 (no TF32
    on the card), as JAX builds it at ``Precision.HIGHEST``."""
    s, t0, tn = table_consts(n_q, kv_bound)
    lattice = t0 + s * torch.arange(tn, dtype=torch.float32, device=w1.device)
    f = torch.sign(lattice) * torch.log1p(torch.abs(lattice))
    hid = torch.relu(f[:, None] * w1[0] + b1)
    hid = torch.relu(hid @ w2 + b2)
    return (hid @ w3 + b3).t().contiguous()


def table1d_shifts(grid_kv, *, n_q: int, kv_bound: float):
    """Each kv row's continuous lattice shift (the lattice index of its
    first query offset, the query sequence starting at -1): ``grid_kv
    [BG, K]`` -> ``[BG*K]``."""
    s, t0, _ = table_consts(n_q, kv_bound)
    return ((-1.0 - grid_kv - t0) / s).reshape(-1)


def table1d_taps(shifts, *, n_q: int, tn: int):
    """Shifts ``[R]`` -> integer taps ``[R]`` int32 and fractions ``[R]``
    f32 (port of ``_tbl1_idx``).  The tap is clipped to ``tn - n_q - 2`` so
    that the window and its +1 neighbour lie inside the table, and the
    fraction is taken against the CLIPPED tap: a clipped row extrapolates
    (fraction outside [0, 1]), as on the TPU."""
    i0 = torch.clamp(torch.floor(shifts), 0.0, float(tn - n_q - 2))
    return i0.to(torch.int32), (shifts - i0).to(torch.float32)


def _windows(table, taps, n_q):
    """``table [O, tn]`` at each row's two taps -> ``a, b [O, R, n_q]``."""
    idx = taps.long()[:, None] + torch.arange(n_q, device=table.device)
    return table[:, idx], table[:, idx + 1]


def table1d_interp_reference(table, taps, fracs, n_q: int, kv: int):
    """Plain version of K4: ``a * (1 - f) + b * f`` (the TPU kernel's
    order), rows ``r = bg * kv + k`` -> ``[BG, O, kv, n_q]``."""
    a, b = _windows(table, taps, n_q)
    f = fracs[None, :, None]
    out = a * (1 - f) + b * f                           # [O, R, n_q]
    return out.unflatten(1, (-1, kv)).transpose(0, 1).contiguous()


def table1d_interp_backward_reference(table, taps, fracs, dout, n_q: int,
                                      kv: int):
    """Plain version of K4-bwd: the cotangents ``(dtable [O, tn], dshifts
    [R])`` of :func:`table1d_interp_reference` for ``dout [BG, O, kv,
    n_q]``, written out (any float dtype).  A clipped row keeps the
    derivative of its extrapolation."""
    O, tn = table.shape
    d = dout.transpose(0, 1).flatten(1, 2)              # [O, R, n_q]
    a, b = _windows(table, taps, n_q)
    f = fracs[None, :, None]
    idx = (taps.long()[:, None] + torch.arange(n_q, device=table.device)
           + tn * torch.arange(O, device=table.device)[:, None, None])
    dtable = torch.zeros_like(table).flatten()
    dtable.index_add_(0, idx.flatten(), (d * (1 - f)).flatten())
    dtable.index_add_(0, idx.flatten() + 1, (d * f).flatten())
    return dtable.view(O, tn), (d * (b - a)).sum(dim=(0, 2))


def _check_shapes(name, table, taps, fracs, n_q, kv):
    R = taps.shape[0]
    if (table.dim() != 2 or taps.shape != (R,) or fracs.shape != (R,)
            or table.shape[1] < n_q + 2 or kv <= 0 or R % kv):
        raise ValueError(f"{name}: bad shapes table {tuple(table.shape)} "
                         f"taps {tuple(taps.shape)} fracs {tuple(fracs.shape)}"
                         f" n_q {n_q} kv {kv}")


class Table1dBwdPlan(NamedTuple):
    """The launch of K4-bwd (``csrc/cpb_table_1d_bwd.cu``): a block owns a
    tile of ``tile`` consecutive entries of one of ``n_out`` channels
    (``tiles_c`` tiles a channel) and one of ``groups`` runs of
    ``rows_per_group`` consecutive rows.  The kernel takes ``groups`` and
    restates the rest from the shapes."""

    groups: int
    rows_per_group: int
    tile: int
    tiles_c: int
    n_out: int

    @property
    def tiles(self) -> int:
        """The blocks of one row group: one per tile of each channel."""
        return self.n_out * self.tiles_c


def table1d_bwd_plan(n_out: int, tn: int, rows: int,
                     groups: int | None = None) -> Table1dBwdPlan:
    """K4-bwd's launch for an ``[n_out, tn]`` table and ``rows`` rows: tiles
    of ``TABLE1D_BWD_TILE`` entries, and row groups for about
    ``TABLE1D_BWD_BLOCKS`` blocks in all (or ``groups``), of at most
    ``TABLE1D_BWD_ROWS_MAX`` rows, none empty.  Raises ``ValueError`` where
    the rows need more than ``GRID_Y_MAX`` groups."""
    tiles_c = -(-tn // TABLE1D_BWD_TILE)
    if groups is None:
        groups = -(-TABLE1D_BWD_BLOCKS // (n_out * tiles_c))
    groups = max(1, min(rows, groups), -(-rows // TABLE1D_BWD_ROWS_MAX))
    per_group = -(-rows // groups)
    groups = -(-rows // per_group)  # none empty; ceil(rows / groups) stays
    if groups > GRID_Y_MAX:
        raise ValueError(f"table1d_interp_backward: {rows} rows need "
                         f"{groups} row groups of at most "
                         f"TABLE1D_BWD_ROWS_MAX = {TABLE1D_BWD_ROWS_MAX} rows,"
                         f" more than GRID_Y_MAX = {GRID_Y_MAX}")
    return Table1dBwdPlan(groups, per_group, TABLE1D_BWD_TILE, tiles_c, n_out)


def table1d_bwd_scratch(plan: Table1dBwdPlan, rows: int, table):
    """The kernels' scratch: the groups' partial table cotangents ``[groups,
    n_out * tn]`` and the (row, tile) shift sums ``[rows, tiles]``, f32."""
    return (torch.empty((plan.groups, table.numel()), dtype=torch.float32,
                        device=table.device),
            torch.empty((rows, plan.tiles), dtype=torch.float32,
                        device=table.device))


def table1d_interp_backward(table, taps, fracs, dout, n_q: int, kv: int):
    """K4-bwd wrapper: the forward's inputs and ``dout [BG, O, kv, n_q]``
    f32 -> ``(dtable [O, tn], dshifts [R])`` f32
    (``csrc/cpb_table_1d_bwd.cu``, replaces ``_tbl1_bwd_kernel``), with
    :func:`table1d_bwd_plan`'s launch."""
    if table.device.type == "cpu":
        return table1d_interp_backward_reference(table, taps, fracs, dout,
                                                 n_q, kv)
    _on_card("table1d_interp_backward", (table, taps, fracs, dout),
             (torch.float32, torch.int32, torch.float32, torch.float32))
    _check_shapes("table1d_interp_backward", table, taps, fracs, n_q, kv)
    O, tn = table.shape
    R = taps.shape[0]
    want = (R // kv, O, kv, n_q)
    if dout.shape != want:
        raise ValueError(f"table1d_interp_backward: dout "
                         f"{tuple(dout.shape)}, want {want}")
    dtable = torch.empty_like(table)
    dshifts = torch.empty_like(fracs)
    if R == 0:  # nothing to launch, so nothing to count
        return dtable.zero_(), dshifts
    from .build import check, kernels

    plan = table1d_bwd_plan(O, tn, R)
    partial, dpart = table1d_bwd_scratch(plan, R, table)
    err = kernels().dmlt_cpb_table_1d_bwd(
        table.data_ptr(), O, tn, taps.data_ptr(), fracs.data_ptr(),
        dout.data_ptr(), dtable.data_ptr(), dshifts.data_ptr(),
        partial.data_ptr(), dpart.data_ptr(), R, kv, n_q, plan.groups,
        _stream(table))
    check(err, "table1d_interp_backward")
    table1d_interp_backward.launches += 1
    return dtable, dshifts


table1d_interp_backward.launches = 0


class _Table1dInterp(torch.autograd.Function):
    """K4-fwd (``csrc/cpb_table_1d.cu``, replaces ``_tbl1_fwd_kernel``),
    counted in ``table1d_interp.launches``; backward
    :func:`table1d_interp_backward`."""

    @staticmethod
    def forward(ctx, table, taps, fracs, n_q, kv):
        ctx.save_for_backward(table, taps, fracs)
        ctx.n_q, ctx.kv = n_q, kv
        if table.device.type == "cpu":
            return table1d_interp_reference(table, taps, fracs, n_q, kv)
        _on_card("table1d_interp", (table, taps, fracs),
                 (torch.float32, torch.int32, torch.float32))
        _check_shapes("table1d_interp", table, taps, fracs, n_q, kv)
        O, tn = table.shape
        R = taps.shape[0]
        out = torch.empty((R // kv, O, kv, n_q), dtype=torch.float32,
                          device=table.device)
        if out.numel() == 0:  # nothing to launch, so nothing to count
            return out
        from .build import check, kernels

        err = kernels().dmlt_cpb_table_1d_fwd(
            table.data_ptr(), O, tn, taps.data_ptr(), fracs.data_ptr(),
            out.data_ptr(), R, kv, n_q, _stream(table))
        check(err, "table1d_interp")
        table1d_interp.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        table, taps, fracs = ctx.saved_tensors
        dtable, dshifts = table1d_interp_backward(
            table, taps, fracs, dout.contiguous(), ctx.n_q, ctx.kv)
        return dtable, None, dshifts, None, None


def table1d_interp(table, taps, fracs, n_q: int, kv: int):
    """K4: ``table [O, tn]`` f32, ``taps [R]`` int32, ``fracs [R]`` f32
    (rows ``bg * kv + k``) -> ``[R / kv, O, kv, n_q]`` f32, differentiable
    with respect to ``table`` and ``fracs``."""
    return _Table1dInterp.apply(table, taps, fracs, n_q, kv)


table1d_interp.launches = 0


def cpb_bias_table_1d(grid_kv, w1, b1, w2, b2, w3, b3, *, n_q: int,
                      kv_bound: float):
    """Divisor-1 table CPB on the normalized query sequence ``2 i / (n_q -
    1) - 1``: ``grid_kv [BG, K]`` -> ``[BG, O, K, n_q]`` (counterpart of
    ``cpb_bias_table_1d``; ``w1`` is the 1-coordinate first layer
    ``[1, HID]``)."""
    table = cpb_table_1d(w1, b1, w2, b2, w3, b3, n_q=n_q, kv_bound=kv_bound)
    taps, fracs = table1d_taps(
        table1d_shifts(grid_kv, n_q=n_q, kv_bound=kv_bound),
        n_q=n_q, tn=table.shape[1])
    return table1d_interp(table, taps, fracs, n_q, grid_kv.shape[1])


__all__ = ["cpb_bias_table_1d", "cpb_table_1d", "table1d_bwd_plan",
           "table1d_interp", "table1d_interp_backward",
           "table1d_interp_backward_reference",
           "table1d_interp_reference", "table1d_shifts", "table1d_taps"]

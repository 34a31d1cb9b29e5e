"""Continuous-position-bias (CPB) ops of the deformable attention: the
counterpart of ``disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py``
for the teacher's serving and training paths.

Two ways to the same ``[BH, K, N]`` kv-major bias (``[BH, O, K, N]`` for
O > 1 output channels), both from one 2 -> 32 -> 32 -> O relu MLP with its
weights in the JAX layout (``w1 [2, 32]``, ``w2 [32, 32]``, ``w3 [32, O]``):

- **table** (``cpb_table_divisor = d >= 1``; 1 in the presets): the MLP runs
  once on a ``[tn, tn]`` lattice of spacing (query spacing) / d
  (:func:`cpb_table`, plain torch in full f32), and each kv row's
  ``[side, side]`` window, every d-th lattice point, is blended bilinearly
  from it: at divisor 1 by :func:`table_interp` (kernel K1 in
  ``csrc/cpb_table.cu``, its backward in ``csrc/cpb_table_bwd.cu``), at
  d >= 2 by :func:`table_interp_strided` (kernel K5 in
  ``csrc/cpb_table_strided.cu``, its backward in
  ``csrc/cpb_table_strided_bwd.cu``).  Same arithmetic as
  ``cpb_bias_table``, on the full lattice, without the TPU's lane-split
  (divisor 1) table layout; at d >= 3 K5's forward first writes the
  table's x-phase planes (the TPU's phase decomposition in x, each entry
  paired with its right neighbour) into a scratch of its wrapper's.  Both
  kernels
  can store the windows in bf16 (``out_dtype``; ``cpb_table_bf16``): the
  blend stays f32 and only the store rounds, and the backward reads a bf16
  cotangent and sums in f32.  Autograd carries the table cotangent back to
  the MLP weights, and the fraction cotangent back to ``grid_kv``.
- **exact** (``cpb_table_divisor = 0``, the ``Config`` default): the MLP at
  every (row, query) pair (:func:`cpb_bias_transposed`, kernel K2 in
  ``csrc/cpb_exact.cu``, its backward in ``csrc/cpb_exact_bwd.cu``; JAX
  ``cpb_bias_transposed`` :1534, ``_cpbt_fwd_kernel`` :1422 and
  ``_cpbt_bwd_kernel`` :1443).

The "nk" attention layout takes the exact CPB query-major, ``[BH, N, K]``
(``[BH, O, N, K]``): :func:`cpb_bias_nk`, kernel K2-nk, the same sources
with a layout flag (the forward kernel's "nk" instance stores along k; the
backward reads its cotangent in that layout).  It is the counterpart of
JAX's four TPU layouts of that function, each at its grid entry: v1
``cpb_bias_from_grids`` (:810, ``_cpb_wide_*`` :640/:668, what JAX's "nk"
runs on a TPU), v5 ``cpb_bias_grids_fused`` (:1314, ``_cpb5_*``
:1196/:1205, under ``CPB_KERNEL_VERSION = "v5"``), v2 ``cpb_bias`` (:601,
``_cpb_flat_*`` :428/:447) and wide4 ``cpb_bias_from_grids_w4`` (:1121,
``_w4_*`` :912/:931).  Their other inputs (pre-transformed flat offsets,
pre-expanded pair rows, ``[R, 4, CH]`` blocks) are TPU layouts and are not
carried over.  K2-nk gives K2's bias transposed, and its backward K2's
gradients, bitwise.

All are ``torch.autograd.Function``s whose forward and backward go
through the wrappers below.  Wrapper rule: a tensor on the CPU goes to the
plain PyTorch version (``*_reference``, also what the card's kernels are
checked against); a CUDA tensor launches the kernel or raises.  There is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches`` (a
plain int), and nowhere else: :func:`table_interp`,
:func:`table_interp_strided`, :func:`cpb_bias_transposed` and
:func:`cpb_bias_nk` count forward launches, :func:`table_interp_backward`,
:func:`table_interp_strided_backward`,
:func:`cpb_bias_transposed_backward` and :func:`cpb_bias_nk_backward`
backward launches.  The backward kernels are deterministic (two calls on
the same inputs give bitwise-equal results).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

HID = 32  # CPB hidden width (dim // 4 at dim 128); the K2 kernels' constant
MAX_OUT_CHANNELS = 64  # K2 keeps w3 [HID, O] in shared memory
# K1-bwd and K5-bwd (csrc/table_bwd_tiles.cuh): one block per tile of the
# table and group of rows; the rows split into enough groups for about this
# many warps in all (64 on each of the H100's 132 SMs), a function of the
# shapes alone, so that the groups' partial tables are summed in one fixed
# order
TABLE_BWD_WARPS = 8448
# and at most this many rows a group: a block lists its group's rows that
# meet its tile in shared memory (kMaxRows in csrc/table_bwd_tiles.cuh)
TABLE_BWD_ROWS_MAX = 512
# K2-bwd: 128-thread blocks of 72-73 KB at O <= 2, three per SM (396 on the
# H100's 132 SMs); each takes ceil(rows / 396) whole kv rows
# (exact_bwd_parts), a function of the shapes alone, so that the partials
# and the order of their sum are fixed
EXACT_BWD_BLOCKS = 396
SMEM_LIMIT = 227 * 1024  # shared memory one block may opt in to (H100)


# ---------------------------------------------------------------------------
# table CPB (divisor d >= 1)
# ---------------------------------------------------------------------------

def table_consts(side: int, kv_bound: float,
                 divisor: int = 1) -> tuple[float, float, int]:
    """Lattice geometry (``_tbl_consts``): spacing ``h`` (the query spacing
    over ``divisor``), origin ``t0`` and size ``tn`` (a multiple of
    ``divisor``) of a lattice that covers every query-minus-kv offset when
    ``|grid_kv| <= kv_bound``."""
    h = (2.0 / (side - 1)) / divisor
    n_lo = int(-(-(1.0 + kv_bound) // h)) + 2  # ceil + 2 cells of margin
    rn = -(-(2 * n_lo + 1) // divisor)
    return h, -n_lo * h, rn * divisor


def cpb_table(w1, b1, w2, b2, w3, b3, *, side: int, kv_bound: float,
              divisor: int = 1):
    """The MLP on the lattice: ``T[a, b] = MLP(fx=f[b], fy=f[a])`` with
    ``f`` the sign*log1p lattice coordinates -> ``[tn, tn]`` f32 (port of
    ``cpb_bias_table_parts`` and of ``cpb_bias_table``'s divisor-d build,
    without the phase decomposition).  Every bias value interpolates from
    this table, so its matmuls must run in full f32 (no TF32 on the card)."""
    if w3.shape[1] != 1:
        raise ValueError("table CPB supports one output channel")
    h, t0, tn = table_consts(side, kv_bound, divisor)
    lattice = t0 + h * torch.arange(tn, dtype=torch.float32, device=w1.device)
    f = torch.sign(lattice) * torch.log1p(torch.abs(lattice))
    hid = torch.relu(f[None, :, None] * w1[0] + f[:, None, None] * w1[1] + b1)
    hid = torch.relu(hid @ w2 + b2)
    return (hid @ w3 + b3)[..., 0].contiguous()


def table_shifts(grid_kv, *, side: int, kv_bound: float, divisor: int = 1):
    """Each kv row's continuous lattice shift ``(ty, tx)``: the lattice index
    of its first query offset.  ``grid_kv [BH, K, 2]`` (x, y) -> ``[BH*K, 2]``."""
    h, t0, _ = table_consts(side, kv_bound, divisor)
    ty = (-1.0 - grid_kv[..., 1] - t0) / h
    tx = (-1.0 - grid_kv[..., 0] - t0) / h
    return torch.stack([ty, tx], dim=-1).reshape(-1, 2)


def table_taps(shifts, *, side: int, tn: int, divisor: int = 1):
    """Shifts ``[R, 2]`` -> integer taps ``[R, 2]`` int32 (first window row
    and column on the full lattice) and fractions ``[R, 2]`` f32 (port of
    ``_tbl_idx``).  The tap is clipped so that the window, lattice rows
    ``tap + divisor*i`` and their +1 neighbours, lies inside the table, and
    the fraction is taken against the CLIPPED tap: a clipped row
    extrapolates (fraction outside [0, 1]), as on the TPU."""
    rn = tn // divisor
    hi = (rn - side) * divisor + divisor - 2  # tn - side - 1 at divisor 1
    i0 = torch.clamp(torch.floor(shifts), 0.0, float(hi))
    return i0.to(torch.int32), (shifts - i0).to(torch.float32)


def _window_lines(taps, side: int, divisor: int):
    """The lattice rows ``[R, n, 1]`` and columns ``[R, 1, n]`` that each
    window reads, lines ``divisor*i`` and ``divisor*i + 1`` past its tap
    (``n = side + 1`` at divisor 1, where neighbouring window points share
    a tap, else ``2*side``), and the slices of those lines that are the
    first and the second taps."""
    if divisor == 1:
        off = torch.arange(side + 1, device=taps.device)
    else:
        i = torch.arange(2 * side, device=taps.device)
        off = divisor * (i // 2) + i % 2
    rows = taps[:, 0:1].long() + off
    cols = taps[:, 1:2].long() + off
    step = 1 if divisor == 1 else 2
    return (rows[:, :, None], cols[:, None, :], slice(0, -1, step),
            slice(1, None, step))


def table_interp_reference(table, taps, fracs, side: int, divisor: int = 1,
                           out_dtype=torch.float32):
    """Plain version of K1 (divisor 1) and K5 (divisor >= 2): ``[R, side,
    side]`` windows blended from the four taps, y first, then x (the TPU
    kernels' order), in the table's dtype, then stored as ``out_dtype``."""
    rows, cols, t0, t1 = _window_lines(taps, side, divisor)
    win = table[rows, cols]                            # one gather [R, n, n]
    fy = fracs[:, 0, None, None]
    fx = fracs[:, 1, None, None]
    ty = win[:, t0] * (1 - fy) + win[:, t1] * fy       # [R, side, n]
    return (ty[:, :, t0] * (1 - fx) + ty[:, :, t1] * fx).to(out_dtype)


def table_interp_backward_reference(table, taps, fracs, dout, side: int,
                                    divisor: int = 1):
    """Plain version of K1-bwd and K5-bwd: the cotangents ``(dtable,
    dfracs)`` of :func:`table_interp_reference` for the window cotangent
    ``dout [R, side, side]`` (a bf16 one is upcast), written out in the
    table's dtype.  ``dfracs[:, 0]`` is d/dfy, ``[:, 1]`` d/dfx; a clipped
    row keeps the derivative of its extrapolation."""
    dout = dout.to(table.dtype)
    rows, cols, t0, t1 = _window_lines(taps, side, divisor)
    win = table[rows, cols]                            # one gather [R, n, n]
    fy = fracs[:, 0, None, None]
    fx = fracs[:, 1, None, None]
    m = dout.new_zeros(win.shape[:1] + (side,) + win.shape[2:])
    m[:, :, t0] += dout * (1 - fx)   # cotangent of the y-blend [R, side, n]
    m[:, :, t1] += dout * fx
    dwin = torch.zeros_like(win)
    dwin[:, t0] += m * (1 - fy)
    dwin[:, t1] += m * fy
    dtable = torch.zeros_like(table).index_put_(
        (rows.expand_as(dwin), cols.expand_as(dwin)), dwin, accumulate=True)
    # d/dfx = the x-difference of the y-blend, taken as a y-blend of table
    # differences: the blended values are O(1) and their difference O(h),
    # so subtracting them would leave their rounding error relative to O(h)
    # (3e-5 at divisor 2, 6e-5 at 4, against float64), where neighbouring
    # entries subtract with no error
    dx = win[:, :, t1] - win[:, :, t0]                 # [R, n, side]
    dfx = (dout * (dx[:, t0] * (1 - fy) + dx[:, t1] * fy)).sum(dim=(1, 2))
    dfy = (m * (win[:, t1] - win[:, t0])).sum(dim=(1, 2))
    return dtable, torch.stack([dfy, dfx], dim=1)


_OUT_DTYPES = (torch.float32, torch.bfloat16)


def table_interp_backward(table, taps, fracs, dout, side: int):
    """K1-bwd wrapper: the forward's inputs and ``dout [R, side, side]`` f32
    or bf16 -> ``(dtable [tn_r, tn_c], dfracs [R, 2])`` f32
    (``csrc/cpb_table_bwd.cu``, replaces ``_tbl_d1_bwd_kernel``)."""
    if table.device.type == "cpu":
        return table_interp_backward_reference(table, taps, fracs, dout, side)
    _check_table_args("table_interp_backward", table, taps, fracs, side, 1,
                      dout)
    dtable = torch.empty_like(table)
    dfracs = torch.empty_like(fracs)
    if taps.shape[0] == 0:  # nothing to launch, so nothing to count
        return dtable.zero_(), dfracs
    table_scatter_launch(table, taps, fracs, dout, side, dtable, dfracs)
    table_interp_backward.launches += 1
    return dtable, dfracs


table_interp_backward.launches = 0


def table_scatter_launch(table, taps, fracs, dout, side, dtable, dfracs):
    """Launches the K1-bwd kernels on checked CUDA arguments, counting
    nothing: the K1-bwd wrapper above counts its launches, and the fused
    table attention's backward (``ops/fused_table.py``) hands its ``ds`` to
    these kernels as part of K6-bwd."""
    table_bwd_launch("table_interp_backward", table, taps, fracs, dout, side,
                     1, dtable, dfracs)


class TableBwdPlan(NamedTuple):
    """The launch of K1-bwd and K5-bwd (``csrc/table_bwd_tiles.cuh``): a
    block owns a ``tile_h x tile_w`` tile of the table, ``phases`` of its
    ``divisor**2`` phases (entries ``T[py + d*oy, px + d*ox]``; the phases
    split over ``nz`` blocks) and one of ``groups`` runs of
    ``rows_per_group`` rows; a warp owns ``strip`` rows of one phase, 32
    columns wide (``warps_per_phase`` strips a phase; at divisor 1 lane 0
    reads the column left of the tile and owns none, so 31).  A window spans
    ``reach`` table lines a side.  The kernels take the first five numbers
    and restate the rest from them."""

    strip: int
    warps_per_phase: int
    phases: int
    groups: int
    divisor: int
    rows_per_group: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    nz: int
    reach: int

    @property
    def tiles(self) -> int:
        """The blocks of one row group: one per tile and phase subset."""
        return self.nz * self.tiles_y * self.tiles_x


def table_bwd_plan(tn_rows: int, tn_cols: int, rows: int, side: int,
                   divisor: int) -> TableBwdPlan:
    """K1-bwd's (divisor 1) or K5-bwd's launch for a ``[tn_rows, tn_cols]``
    table and ``rows`` windows of ``side``: at divisor 1, 8 warps of 4-row
    strips (a tile 32 rows high and 31 columns wide); at d >= 2, all d^2 phases in one block (at most
    16, else split over blocks) with 8-row strips, 16 warps at d = 2; then
    row groups for about ``TABLE_BWD_WARPS`` warps in all, of at most
    ``TABLE_BWD_ROWS_MAX`` rows."""
    d = divisor
    if d == 1:
        strip, wpp, phases = 4, 8, 1
    else:
        nz = -(-d * d // 16)
        strip, phases = 8, -(-d * d // nz)
        wpp = max(1, 16 // phases)
    # at divisor 1 lane 0 reads the column left of the tile: 31 columns
    tile_h, tile_w = d * strip * wpp, 31 if d == 1 else 32 * d
    tiles_y, tiles_x = -(-tn_rows // tile_h), -(-tn_cols // tile_w)
    nz = -(-d * d // phases)
    blocks = -(-TABLE_BWD_WARPS // (phases * wpp))
    groups = max(1, min(rows, -(-blocks // (nz * tiles_y * tiles_x))),
                 -(-rows // TABLE_BWD_ROWS_MAX))
    per_group = -(-rows // groups)
    groups = -(-rows // per_group)  # none empty; ceil(rows / groups) stays
    return TableBwdPlan(strip, wpp, phases, groups, d, per_group,
                        tile_h, tile_w, tiles_y, tiles_x, nz,
                        side + 1 if d == 1 else d * (side - 1) + 2)


def table_bwd_scratch(plan: TableBwdPlan, rows: int, table):
    """The kernels' scratch: the groups' partial table cotangents ``[groups,
    tn_rows * tn_cols]`` and the (row, tile) shift sums ``[rows, tiles, 2]``,
    f32."""
    return (torch.empty((plan.groups, table.numel()), dtype=torch.float32,
                        device=table.device),
            torch.empty((rows, plan.tiles, 2), dtype=torch.float32,
                        device=table.device))


def table_bwd_launch(name, table, taps, fracs, dout, side, divisor, dtable,
                     dfracs):
    """Launches K1-bwd (divisor 1) or K5-bwd on checked CUDA arguments, with
    :func:`table_bwd_plan`'s launch, counting nothing."""
    from .build import check, kernels

    R = taps.shape[0]
    plan = table_bwd_plan(table.shape[0], table.shape[1], R, side, divisor)
    partial, dpart = table_bwd_scratch(plan, R, table)
    entry = (kernels().dmlt_cpb_table_interp_bwd if divisor == 1
             else kernels().dmlt_cpb_table_strided_bwd)
    err = entry(table.data_ptr(), table.shape[0], table.shape[1],
                taps.data_ptr(), fracs.data_ptr(), dout.data_ptr(),
                int(dout.dtype == torch.bfloat16), dtable.data_ptr(),
                dfracs.data_ptr(), partial.data_ptr(), dpart.data_ptr(), R,
                side, divisor, plan.strip, plan.warps_per_phase, plan.phases,
                plan.groups, _stream(table))
    check(err, name)


def table_interp_strided_backward(table, taps, fracs, dout, side: int,
                                  divisor: int):
    """K5-bwd wrapper: the forward's inputs and ``dout [R, side, side]`` f32
    or bf16 -> ``(dtable [tn_r, tn_c], dfracs [R, 2])`` f32
    (``csrc/cpb_table_strided_bwd.cu``, replaces ``_tbl_bwd_kernel``)."""
    if table.device.type == "cpu":
        return table_interp_backward_reference(table, taps, fracs, dout, side,
                                               divisor)
    _check_table_args("table_interp_strided_backward", table, taps, fracs,
                      side, divisor, dout)
    dtable = torch.empty_like(table)
    dfracs = torch.empty_like(fracs)
    if taps.shape[0] == 0:  # nothing to launch, so nothing to count
        return dtable.zero_(), dfracs
    table_bwd_launch("table_interp_strided_backward", table, taps, fracs,
                     dout, side, divisor, dtable, dfracs)
    table_interp_strided_backward.launches += 1
    return dtable, dfracs


table_interp_strided_backward.launches = 0


class _TableInterp(torch.autograd.Function):
    """K1-fwd (divisor 1, ``csrc/cpb_table.cu``, replaces
    ``_tbl_d1_fwd_kernel``), counted in ``table_interp.launches``, backward
    :func:`table_interp_backward`; K5-fwd (divisor >= 2,
    ``csrc/cpb_table_strided.cu``, replaces ``_tbl_fwd_kernel``), counted in
    ``table_interp_strided.launches``, backward
    :func:`table_interp_strided_backward`."""

    @staticmethod
    def forward(ctx, table, taps, fracs, side, divisor, out_dtype):
        ctx.save_for_backward(table, taps, fracs)
        ctx.side, ctx.divisor = side, divisor
        if table.device.type == "cpu":
            return table_interp_reference(table, taps, fracs, side, divisor,
                                          out_dtype)
        name = "table_interp" if divisor == 1 else "table_interp_strided"
        _check_table_args(name, table, taps, fracs, side, divisor)
        if out_dtype not in _OUT_DTYPES:
            raise ValueError(f"{name}: out_dtype {out_dtype}, want one of "
                             f"{_OUT_DTYPES}")
        R = taps.shape[0]
        out = torch.empty((R, side, side), dtype=out_dtype,
                          device=table.device)
        if R == 0:  # nothing to launch, so nothing to count
            return out
        from .build import check, kernels

        bf16 = int(out_dtype == torch.bfloat16)
        if divisor == 1:
            err = kernels().dmlt_cpb_table_interp_fwd(
                table.data_ptr(), table.shape[0], table.shape[1],
                taps.data_ptr(), fracs.data_ptr(), out.data_ptr(), bf16, R,
                side, _stream(table))
            check(err, name)
            table_interp.launches += 1
        else:
            # the x-phase pair planes (d >= 3; the kernel's first launch)
            scratch = torch.empty(
                kernels().dmlt_cpb_table_strided_fwd_scratch(
                    table.shape[0], table.shape[1], divisor),
                dtype=torch.uint8, device=table.device)
            err = kernels().dmlt_cpb_table_strided_fwd(
                table.data_ptr(), table.shape[0], table.shape[1],
                taps.data_ptr(), fracs.data_ptr(), out.data_ptr(), bf16, R,
                side, divisor, scratch.data_ptr(), _stream(table))
            check(err, name)
            table_interp_strided.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        table, taps, fracs = ctx.saved_tensors
        if ctx.divisor == 1:
            dtable, dfracs = table_interp_backward(table, taps, fracs,
                                                   dout.contiguous(), ctx.side)
        else:
            dtable, dfracs = table_interp_strided_backward(
                table, taps, fracs, dout.contiguous(), ctx.side, ctx.divisor)
        return dtable, None, dfracs, None, None, None


def table_interp(table, taps, fracs, side: int, out_dtype=torch.float32):
    """K1: ``table [tn_r, tn_c]`` f32, ``taps [R, 2]`` int32, ``fracs
    [R, 2]`` f32 -> ``[R, side, side]`` of ``out_dtype`` (f32 or bf16),
    differentiable with respect to ``table`` and ``fracs``."""
    return _TableInterp.apply(table, taps, fracs, side, 1, out_dtype)


table_interp.launches = 0


def table_interp_strided(table, taps, fracs, side: int, divisor: int,
                         out_dtype=torch.float32):
    """K5: as :func:`table_interp` on a lattice ``divisor`` (>= 2) times
    finer than the queries: window value ``(y, x)`` blends the taps at
    lattice rows ``taps[:, 0] + divisor*y`` (+1) and columns ``taps[:, 1] +
    divisor*x`` (+1)."""
    if divisor < 2:
        raise ValueError(f"table_interp_strided: divisor {divisor}; the "
                         "divisor-1 windows are table_interp's (K1)")
    return _TableInterp.apply(table, taps, fracs, side, divisor, out_dtype)


table_interp_strided.launches = 0


def cpb_bias_table(grid_kv, w1, b1, w2, b2, w3, b3, *, side: int,
                   kv_bound: float, divisor: int = 1,
                   out_dtype=torch.float32):
    """Table CPB on the normalized ``side x side`` query grid: ``grid_kv
    [BH, K, 2]`` -> ``[BH, K, side*side]`` of ``out_dtype`` (counterpart of
    ``cpb_bias_table(..., divisor)``, whose ``TBL_BF16_OUT`` is
    ``out_dtype=torch.bfloat16``); K1 at divisor 1, K5 above."""
    bh, k, _ = grid_kv.shape
    table = cpb_table(w1, b1, w2, b2, w3, b3, side=side, kv_bound=kv_bound,
                      divisor=divisor)
    taps, fracs = table_taps(
        table_shifts(grid_kv, side=side, kv_bound=kv_bound, divisor=divisor),
        side=side, tn=table.shape[0], divisor=divisor)
    if divisor == 1:
        wins = table_interp(table, taps, fracs, side, out_dtype)
    else:
        wins = table_interp_strided(table, taps, fracs, side, divisor,
                                    out_dtype)
    return wins.reshape(bh, k, side * side)


# ---------------------------------------------------------------------------
# exact CPB
# ---------------------------------------------------------------------------

def cpb_bias_transposed_reference(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """Plain version of K2: ``grid_q [N, 2]``, ``grid_kv [BH, K, 2]`` ->
    ``[BH, K, N]`` (O = 1) or ``[BH, O, K, N]``."""
    pos = grid_q[None, None, :, :] - grid_kv[:, :, None, :]  # [BH, K, N, 2]
    f = torch.sign(pos) * torch.log1p(torch.abs(pos))
    h = torch.relu(f @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    out = (h @ w3 + b3).permute(0, 3, 1, 2)                  # [BH, O, K, N]
    return (out[:, 0] if out.shape[1] == 1 else out).contiguous()


def cpb_bias_transposed_backward_reference(grid_q, grid_kv, w1, b1, w2, b2,
                                           w3, b3, dbias):
    """Plain version of K2-bwd: ``dbias`` (the bias cotangent, shaped as the
    forward's output) -> ``(dgrid_kv, dw1, db1, dw2, db2, dw3, db3)``,
    written out (any float dtype).  ``grid_q`` gets no cotangent, as in
    ``_cpbt_vjp_bwd``.  d/dp of ``sign(p) log1p|p|`` is ``1 / (1 + |p|)``,
    also at p = 0, as in the TPU kernel."""
    O = w3.shape[-1]
    pos = grid_q[None, None, :, :] - grid_kv[:, :, None, :]  # [BH, K, N, 2]
    f = torch.sign(pos) * torch.log1p(torch.abs(pos))
    z1 = f @ w1 + b1
    h1 = torch.relu(z1)
    z2 = h1 @ w2 + b2
    db = dbias[..., None] if O == 1 else dbias.permute(0, 2, 3, 1)
    dz2 = (db @ w3.t()) * (z2 > 0)                           # [BH, K, N, HID]
    dz1 = (dz2 @ w2.t()) * (z1 > 0)

    def outer(a, b):  # sum over every point of a[p] b[p]^T
        return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])

    dpos = (dz1 @ w1.t()) / (1 + torch.abs(pos))
    return (-dpos.sum(dim=2), outer(f, dz1), dz1.sum(dim=(0, 1, 2)),
            outer(h1, dz2), dz2.sum(dim=(0, 1, 2)), outer(torch.relu(z2), db),
            db.sum(dim=(0, 1, 2)))


def cpb_bias_nk_reference(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """Plain version of K2-nk: ``grid_q [N, 2]``, ``grid_kv [BH, K, 2]`` ->
    ``[BH, N, K]`` (O = 1) or ``[BH, O, N, K]``, the MLP evaluated point by
    point in the query-major order (JAX ``_cpb_mlp``, :151-163)."""
    pos = grid_q[None, :, None, :] - grid_kv[:, None, :, :]  # [BH, N, K, 2]
    f = torch.sign(pos) * torch.log1p(torch.abs(pos))
    h = torch.relu(f @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    out = (h @ w3 + b3).permute(0, 3, 1, 2)                  # [BH, O, N, K]
    return (out[:, 0] if out.shape[1] == 1 else out).contiguous()


def cpb_bias_nk_backward_reference(grid_q, grid_kv, w1, b1, w2, b2, w3, b3,
                                   dbias):
    """Plain version of K2-nk-bwd: ``dbias`` shaped as K2-nk's output ->
    the cotangents of :func:`cpb_bias_transposed_backward_reference`, from
    the same points with the cotangent transposed to kv-major."""
    return cpb_bias_transposed_backward_reference(
        grid_q, grid_kv, w1, b1, w2, b2, w3, b3, dbias.transpose(-1, -2))


def _exact_backward(name, args, dbias, nk: bool):
    """K2-bwd (``nk`` False) or K2-nk-bwd (True) on the card, uncounted:
    ``(dgrid_kv, dw1, db1, dw2, db2, dw3, db3)`` f32."""
    _on_card(name, args + (dbias,), (torch.float32,) * 9)
    BH, K, N, O = _check_exact_shapes(name, args)
    want = _exact_shape(BH, K, N, O, nk)
    if dbias.shape != want:
        raise ValueError(f"{name}: dbias {tuple(dbias.shape)}, want {want}")
    grid_q = args[0]
    n_params = HID * (2 + 1 + HID + 1) + (HID + 1) * O
    grads = torch.empty(n_params, dtype=torch.float32, device=grid_q.device)
    dgrid_kv = torch.empty_like(args[1])
    if dbias.numel() == 0:  # nothing to launch
        grads.zero_()
        dgrid_kv.zero_()
    else:
        from .build import check, kernels

        nparts = exact_bwd_parts(BH * K)
        partial = torch.empty((nparts, n_params), dtype=torch.float32,
                              device=grid_q.device)
        err = kernels().dmlt_cpb_exact_bwd(
            *(t.data_ptr() for t in args[:7]), dbias.data_ptr(),
            dgrid_kv.data_ptr(), grads.data_ptr(), partial.data_ptr(),
            BH * K, K, N, O, nparts, int(nk), _stream(grid_q))
        check(err, name)
    shapes = [(2, HID), (HID,), (HID, HID), (HID,), (HID, O), (O,)]
    pieces = torch.split(grads, [math.prod(sh) for sh in shapes])
    return (dgrid_kv, *(p.view(sh) for p, sh in zip(pieces, shapes)))


def exact_bwd_parts(rows: int) -> int:
    """K2-bwd's blocks (partial results) for ``rows`` kv rows: at most
    ``EXACT_BWD_BLOCKS``, each with ``ceil(rows / EXACT_BWD_BLOCKS)`` rows
    (the last one fewer)."""
    per_block = -(-rows // EXACT_BWD_BLOCKS)
    return -(-rows // per_block)


def cpb_bias_transposed_backward(grid_q, grid_kv, w1, b1, w2, b2, w3, b3,
                                 dbias):
    """K2-bwd wrapper: the forward's inputs and ``dbias`` (its output's
    shape) f32 -> ``(dgrid_kv, dw1, db1, dw2, db2, dw3, db3)`` f32
    (``csrc/cpb_exact_bwd.cu``, replaces ``_cpbt_bwd_kernel``)."""
    args = (grid_q, grid_kv, w1, b1, w2, b2, w3, b3)
    if grid_q.device.type == "cpu":
        return cpb_bias_transposed_backward_reference(*args, dbias)
    grads = _exact_backward("cpb_bias_transposed_backward", args, dbias, False)
    if dbias.numel():
        cpb_bias_transposed_backward.launches += 1
    return grads


cpb_bias_transposed_backward.launches = 0


def cpb_bias_nk_backward(grid_q, grid_kv, w1, b1, w2, b2, w3, b3, dbias):
    """K2-nk-bwd wrapper: as :func:`cpb_bias_transposed_backward` for a
    ``dbias`` in K2-nk's layout (``csrc/cpb_exact_bwd.cu`` with its nk flag;
    replaces ``_cpb_wide_bwd_kernel``, ``_cpb5_bwd_kernel``,
    ``_cpb_flat_bwd_kernel`` and ``_w4_bwd_kernel``).  The same gradients
    as K2-bwd on the transposed cotangent, bitwise."""
    args = (grid_q, grid_kv, w1, b1, w2, b2, w3, b3)
    if grid_q.device.type == "cpu":
        return cpb_bias_nk_backward_reference(*args, dbias)
    grads = _exact_backward("cpb_bias_nk_backward", args, dbias, True)
    if dbias.numel():
        cpb_bias_nk_backward.launches += 1
    return grads


cpb_bias_nk_backward.launches = 0


def _exact_shape(BH, K, N, O, nk: bool) -> tuple:
    plane = (N, K) if nk else (K, N)
    return (BH, *plane) if O == 1 else (BH, O, *plane)


class _CpbExact(torch.autograd.Function):
    """K2-fwd (``csrc/cpb_exact.cu``): "kn" replaces ``_cpbt_fwd_kernel``,
    counted in ``cpb_bias_transposed.launches``, backward
    :func:`cpb_bias_transposed_backward`; "nk" (``nk`` True) replaces the
    four TPU layouts of the same function, counted in
    ``cpb_bias_nk.launches``, backward :func:`cpb_bias_nk_backward`."""

    @staticmethod
    def forward(ctx, nk, *args):
        ctx.save_for_backward(*args)
        ctx.nk = nk
        grid_q = args[0]
        if grid_q.device.type == "cpu":
            return (cpb_bias_nk_reference if nk
                    else cpb_bias_transposed_reference)(*args)
        name = "cpb_bias_nk" if nk else "cpb_bias_transposed"
        _on_card(name, args, (torch.float32,) * 8)
        BH, K, N, O = _check_exact_shapes(name, args)
        out = torch.empty(_exact_shape(BH, K, N, O, nk), dtype=torch.float32,
                          device=grid_q.device)
        if out.numel() == 0:  # nothing to launch, so nothing to count
            return out
        if N * K >= 2 ** 31 - 512 or BH > 65535:
            raise ValueError(f"{name}: N * K = {N * K} and BH = {BH}; the "
                             "kernel takes N * K < 2^31 - 512 and "
                             "BH <= 65535")
        from .build import check, kernels

        err = kernels().dmlt_cpb_exact_fwd(
            *(t.data_ptr() for t in args), out.data_ptr(), BH * K, K, N, O,
            int(nk), _stream(grid_q))
        check(err, name)
        if nk:
            cpb_bias_nk.launches += 1
        else:
            cpb_bias_transposed.launches += 1
        return out

    @staticmethod
    def backward(ctx, dbias):
        bwd = (cpb_bias_nk_backward if ctx.nk
               else cpb_bias_transposed_backward)
        grads = bwd(*ctx.saved_tensors, dbias.contiguous())
        return (None, None, *grads)


def cpb_bias_transposed(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """K2: exact CPB in the kv-major layout, ``grid_q [N, 2]``, ``grid_kv
    [BH, K, 2]`` -> ``[BH, K, N]`` (O = 1) or ``[BH, O, K, N]``,
    differentiable with respect to ``grid_kv`` and the MLP weights."""
    return _CpbExact.apply(False, grid_q, grid_kv, w1, b1, w2, b2, w3, b3)


cpb_bias_transposed.launches = 0


def cpb_bias_nk(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """K2-nk: exact CPB in the query-major layout of the "nk" attention,
    ``grid_q [N, 2]``, ``grid_kv [BH, K, 2]`` -> ``[BH, N, K]`` (O = 1) or
    ``[BH, O, N, K]``, differentiable with respect to ``grid_kv`` and the
    MLP weights (``grid_q`` is a constant grid and gets no gradient).  The
    counterpart of JAX's grid entries ``cpb_bias_from_grids`` (v1, :810),
    ``cpb_bias_grids_fused`` (v5, :1314), ``cpb_bias`` (v2, :601) and
    ``cpb_bias_from_grids_w4`` (wide4, :1121); on the card the "kn" bias
    transposed, bitwise."""
    return _CpbExact.apply(True, grid_q, grid_kv, w1, b1, w2, b2, w3, b3)


cpb_bias_nk.launches = 0


# ---------------------------------------------------------------------------
# wrapper checks
# ---------------------------------------------------------------------------

def _on_card(name, tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype on
    one device."""
    dev = tensors[0].device
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"want the CUDA device {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name}: argument {i} is {t.dtype}, want {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


def _check_table_args(name, table, taps, fracs, side, divisor, dout=None):
    """Raise unless the table kernels (K1, K5 and their backwards) take
    these arguments: contiguous CUDA tensors of their dtypes, a table that
    holds a window (``divisor * (side - 1) + 2`` lattice points a side), and
    a window cotangent ``[R, side, side]`` in f32 or bf16."""
    _on_card(name, (table, taps, fracs),
             (torch.float32, torch.int32, torch.float32))
    R = taps.shape[0]
    if (table.dim() != 2 or taps.shape != (R, 2) or fracs.shape != (R, 2)
            or min(table.shape) < divisor * (side - 1) + 2):
        raise ValueError(f"{name}: bad shapes table {tuple(table.shape)}"
                         f" taps {tuple(taps.shape)} fracs {tuple(fracs.shape)}"
                         f" side {side} divisor {divisor}")
    if dout is None:
        return
    if dout.dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: dout is {dout.dtype}, want one of "
                         f"{_OUT_DTYPES}")
    _on_card(name, (table, dout), (torch.float32, dout.dtype))
    if dout.shape != (R, side, side):
        raise ValueError(f"{name}: dout {tuple(dout.shape)}, want "
                         f"{(R, side, side)}")


def _check_exact_shapes(name, args):
    """-> (BH, K, N, O) of the exact CPB's inputs, or raise."""
    grid_q, grid_kv, w3 = args[0], args[1], args[6]
    N = grid_q.shape[0]
    BH, K = grid_kv.shape[:2]
    O = w3.shape[-1]
    want = ((N, 2), (BH, K, 2), (2, HID), (HID,), (HID, HID), (HID,), (HID, O),
            (O,))
    got = tuple(tuple(t.shape) for t in args)
    if got != want or not 1 <= O <= MAX_OUT_CHANNELS:
        raise ValueError(f"{name}: shapes {got}, want {want} "
                         f"with 1 <= O <= {MAX_OUT_CHANNELS}")
    return BH, K, N, O


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kv_bound_2d(offset_scale: float, gh: int, gw: int) -> float:
    """Static bound on ``|grid_kv|``: the tanh offsets of at most
    ``offset_scale`` small-grid cells, normalized by ``(g - 1)`` per axis."""
    g = min(gh, gw)
    return 1.0 + 2.0 * offset_scale / (g - 1) if g > 1 else 0.0


__all__ = ["HID", "cpb_bias_nk", "cpb_bias_nk_backward",
           "cpb_bias_nk_backward_reference", "cpb_bias_nk_reference",
           "cpb_bias_table", "cpb_bias_transposed",
           "cpb_bias_transposed_backward",
           "cpb_bias_transposed_backward_reference",
           "cpb_bias_transposed_reference", "cpb_table", "kv_bound_2d",
           "table_consts", "table_interp", "table_interp_backward",
           "table_interp_backward_reference", "table_interp_reference",
           "table_interp_strided", "table_interp_strided_backward",
           "table_shifts", "table_taps"]

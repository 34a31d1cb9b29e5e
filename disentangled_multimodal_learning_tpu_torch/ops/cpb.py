"""Continuous-position-bias (CPB) ops of the deformable attention: the
counterpart of ``disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py``
for the teacher's serving and training paths.

Two ways to the same ``[BH, K, N]`` kv-major bias (``[BH, O, K, N]`` for
O > 1 output channels), both from one 2 -> 32 -> 32 -> O relu MLP with its
weights in the JAX layout (``w1 [2, 32]``, ``w2 [32, 32]``, ``w3 [32, O]``):

- **table** (``cpb_table_divisor = 1``, the presets): the MLP runs once on a
  ``[tn, tn]`` lattice with the query spacing (:func:`cpb_table`, plain torch
  in full f32), and each kv row's ``[side, side]`` window is blended
  bilinearly from it (:func:`table_interp`, kernel K1 in
  ``csrc/cpb_table.cu``, its backward in ``csrc/cpb_table_bwd.cu``).  Same
  arithmetic as ``cpb_bias_table`` at divisor 1, without the TPU's
  lane-split table layout.  Autograd carries the table cotangent back to
  the MLP weights, and the fraction cotangent back to ``grid_kv``.
- **exact** (``cpb_table_divisor = 0``, the ``Config`` default): the MLP at
  every (row, query) pair (:func:`cpb_bias_transposed`, kernel K2 in
  ``csrc/cpb_exact.cu``, its backward in ``csrc/cpb_exact_bwd.cu``).

Both are ``torch.autograd.Function``s whose forward and backward go
through the wrappers below.  Wrapper rule: a tensor on the CPU goes to the
plain PyTorch version (``*_reference``, also what the card's kernels are
checked against); a CUDA tensor launches the kernel or raises.  There is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches`` (a
plain int), and nowhere else: :func:`table_interp` and
:func:`cpb_bias_transposed` count forward launches,
:func:`table_interp_backward` and :func:`cpb_bias_transposed_backward`
backward launches.  The backward kernels are deterministic (two calls on
the same inputs give bitwise-equal results).
"""

from __future__ import annotations

import math

import torch

import torch.nn.functional as F

HID = 32  # CPB hidden width (dim // 4 at dim 128); the K2 kernels' constant
MAX_OUT_CHANNELS = 64  # K2 keeps w3 [HID, O] in shared memory
# partial results of the backward kernels (one per block, summed in block
# order by csrc/fixed_order_sum.cuh; fixed counts, so the sum order and the
# result are fixed).  The table kernels, K1-bwd and K4-bwd (ops/cpb1d.py):
# two 108 KB (K4: 80 KB) blocks per SM on the H100's 132 SMs (K1-bwd 0.196
# ms at production shapes, against 0.345 ms with 128 blocks); K2-bwd: its
# 255-register, 128-thread blocks also fit two per SM
TABLE_BWD_PARTS = 264
EXACT_BWD_PARTS = 256
SMEM_LIMIT = 227 * 1024  # shared memory one block may opt in to (H100)


# ---------------------------------------------------------------------------
# table CPB (divisor 1)
# ---------------------------------------------------------------------------

def table_consts(side: int, kv_bound: float) -> tuple[float, float, int]:
    """Divisor-1 lattice geometry (``_tbl_consts`` at divisor 1): spacing
    ``h`` (the query spacing), origin ``t0`` and size ``tn`` of a lattice
    that covers every query-minus-kv offset when ``|grid_kv| <= kv_bound``."""
    h = 2.0 / (side - 1)
    n_lo = int(-(-(1.0 + kv_bound) // h)) + 2  # ceil + 2 cells of margin
    return h, -n_lo * h, 2 * n_lo + 1


def cpb_table(w1, b1, w2, b2, w3, b3, *, side: int, kv_bound: float):
    """The MLP on the divisor-1 lattice: ``T[a, b] = MLP(fx=f[b], fy=f[a])``
    with ``f`` the sign*log1p lattice coordinates -> ``[tn, tn]`` f32
    (port of ``cpb_bias_table_parts``).  Every bias value interpolates from
    this table, so its matmuls must run in full f32 (no TF32 on the card)."""
    if w3.shape[1] != 1:
        raise ValueError("table CPB supports one output channel")
    h, t0, tn = table_consts(side, kv_bound)
    lattice = t0 + h * torch.arange(tn, dtype=torch.float32, device=w1.device)
    f = torch.sign(lattice) * torch.log1p(torch.abs(lattice))
    hid = torch.relu(f[None, :, None] * w1[0] + f[:, None, None] * w1[1] + b1)
    hid = torch.relu(hid @ w2 + b2)
    return (hid @ w3 + b3)[..., 0].contiguous()


def table_shifts(grid_kv, *, side: int, kv_bound: float):
    """Each kv row's continuous lattice shift ``(ty, tx)``: the lattice index
    of its first query offset.  ``grid_kv [BH, K, 2]`` (x, y) -> ``[BH*K, 2]``."""
    h, t0, _ = table_consts(side, kv_bound)
    ty = (-1.0 - grid_kv[..., 1] - t0) / h
    tx = (-1.0 - grid_kv[..., 0] - t0) / h
    return torch.stack([ty, tx], dim=-1).reshape(-1, 2)


def table_taps(shifts, *, side: int, tn: int):
    """Shifts ``[R, 2]`` -> integer taps ``[R, 2]`` int32 (first window row
    and column) and fractions ``[R, 2]`` f32 (port of ``_tbl_idx`` at
    divisor 1).  The tap is clipped so that the window (and its +1
    neighbour) lies inside the table, and the fraction is taken against the
    CLIPPED tap: a clipped row extrapolates (fraction outside [0, 1]), as
    on the TPU."""
    hi = tn - side - 1
    i0 = torch.clamp(torch.floor(shifts), 0.0, float(hi))
    return i0.to(torch.int32), (shifts - i0).to(torch.float32)


def table_interp_reference(table, taps, fracs, side: int):
    """Plain version of K1: ``[R, side, side]`` windows blended from the four
    taps, y first, then x (the TPU kernel's order)."""
    ar = torch.arange(side + 1, device=table.device)
    rows = taps[:, 0:1].long() + ar                       # [R, side+1]
    cols = taps[:, 1:2].long() + ar
    win = table[rows[:, :, None], cols[:, None, :]]      # [R, side+1, side+1]
    fy = fracs[:, 0, None, None]
    fx = fracs[:, 1, None, None]
    ty = win[:, :-1, :] * (1 - fy) + win[:, 1:, :] * fy  # [R, side, side+1]
    return ty[:, :, :-1] * (1 - fx) + ty[:, :, 1:] * fx


def table_interp_backward_reference(table, taps, fracs, dout, side: int):
    """Plain version of K1-bwd: the cotangents ``(dtable, dfracs)`` of
    :func:`table_interp_reference` for the window cotangent ``dout
    [R, side, side]``, written out (any float dtype).  ``dfracs[:, 0]`` is
    d/dfy, ``[:, 1]`` d/dfx; a clipped row keeps the derivative of its
    extrapolation."""
    ar = torch.arange(side + 1, device=table.device)
    rows = (taps[:, 0:1].long() + ar)[:, :, None]         # [R, side+1, 1]
    cols = (taps[:, 1:2].long() + ar)[:, None, :]         # [R, 1, side+1]
    win = table[rows, cols]                               # [R, side+1, side+1]
    fy = fracs[:, 0, None, None]
    fx = fracs[:, 1, None, None]
    # x-blended cotangent of the y-blended window [R, side, side+1]
    m = F.pad(dout * (1 - fx), (0, 1)) + F.pad(dout * fx, (1, 0))
    dwin = F.pad(m * (1 - fy), (0, 0, 0, 1)) + F.pad(m * fy, (0, 0, 1, 0))
    dtable = torch.zeros_like(table).index_put_(
        (rows.expand_as(dwin), cols.expand_as(dwin)), dwin, accumulate=True)
    ty = win[:, :-1, :] * (1 - fy) + win[:, 1:, :] * fy   # [R, side, side+1]
    dfx = (dout * (ty[:, :, 1:] - ty[:, :, :-1])).sum(dim=(1, 2))
    dfy = (m * (win[:, 1:, :] - win[:, :-1, :])).sum(dim=(1, 2))
    return dtable, torch.stack([dfy, dfx], dim=1)


def table_interp_backward(table, taps, fracs, dout, side: int):
    """K1-bwd wrapper: the forward's inputs and ``dout [R, side, side]`` f32
    -> ``(dtable [tn_r, tn_c], dfracs [R, 2])`` f32
    (``csrc/cpb_table_bwd.cu``, replaces ``_tbl_d1_bwd_kernel``)."""
    if table.device.type == "cpu":
        return table_interp_backward_reference(table, taps, fracs, dout, side)
    _on_card("table_interp_backward", (table, taps, fracs, dout),
             (torch.float32, torch.int32, torch.float32, torch.float32))
    R = taps.shape[0]
    _check_table_shapes("table_interp_backward", table, taps, fracs, side)
    if dout.shape != (R, side, side):
        raise ValueError(f"table_interp_backward: dout {tuple(dout.shape)}, "
                         f"want {(R, side, side)}")
    tsize = table.shape[0] * table.shape[1]
    smem = 4 * (tsize + (side + 1) ** 2 + side * side + side * (side + 1) + 16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"table_interp_backward: table {tuple(table.shape)} "
                         f"at side {side} needs {smem} B of shared memory per "
                         f"block, more than {SMEM_LIMIT}")
    dtable = torch.empty_like(table)
    dfracs = torch.empty_like(fracs)
    if R == 0:  # nothing to launch, so nothing to count
        return dtable.zero_(), dfracs
    from .build import check, kernels

    nparts = min(R, TABLE_BWD_PARTS)
    partial = torch.empty((nparts, tsize), dtype=torch.float32,
                          device=table.device)
    err = kernels().dmlt_cpb_table_interp_bwd(
        table.data_ptr(), table.shape[0], table.shape[1], taps.data_ptr(),
        fracs.data_ptr(), dout.data_ptr(), dtable.data_ptr(),
        dfracs.data_ptr(), partial.data_ptr(), R, side, nparts,
        _stream(table))
    check(err, "table_interp_backward")
    table_interp_backward.launches += 1
    return dtable, dfracs


table_interp_backward.launches = 0


class _TableInterp(torch.autograd.Function):
    """K1-fwd (``csrc/cpb_table.cu``, replaces ``_tbl_d1_fwd_kernel``),
    counted in ``table_interp.launches``; backward
    :func:`table_interp_backward`."""

    @staticmethod
    def forward(ctx, table, taps, fracs, side):
        ctx.save_for_backward(table, taps, fracs)
        ctx.side = side
        if table.device.type == "cpu":
            return table_interp_reference(table, taps, fracs, side)
        _on_card("table_interp", (table, taps, fracs),
                 (torch.float32, torch.int32, torch.float32))
        R = taps.shape[0]
        _check_table_shapes("table_interp", table, taps, fracs, side)
        if (side + 1) ** 2 * 4 > 48 * 1024:
            raise ValueError(f"table_interp: side {side} needs more than "
                             "48 KB of shared memory per window")
        out = torch.empty((R, side, side), dtype=torch.float32,
                          device=table.device)
        if R == 0:  # nothing to launch, so nothing to count
            return out
        from .build import check, kernels

        err = kernels().dmlt_cpb_table_interp_fwd(
            table.data_ptr(), table.shape[0], table.shape[1],
            taps.data_ptr(), fracs.data_ptr(), out.data_ptr(), R, side,
            _stream(table))
        check(err, "table_interp")
        table_interp.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        table, taps, fracs = ctx.saved_tensors
        dtable, dfracs = table_interp_backward(table, taps, fracs,
                                               dout.contiguous(), ctx.side)
        return dtable, None, dfracs, None


def table_interp(table, taps, fracs, side: int):
    """K1: ``table [tn_r, tn_c]`` f32, ``taps [R, 2]`` int32, ``fracs
    [R, 2]`` f32 -> ``[R, side, side]`` f32, differentiable with respect to
    ``table`` and ``fracs``."""
    return _TableInterp.apply(table, taps, fracs, side)


table_interp.launches = 0


def cpb_bias_table(grid_kv, w1, b1, w2, b2, w3, b3, *, side: int,
                   kv_bound: float):
    """Divisor-1 table CPB on the normalized ``side x side`` query grid:
    ``grid_kv [BH, K, 2]`` -> ``[BH, K, side*side]`` (counterpart of
    ``cpb_bias_table(..., divisor=1)``)."""
    bh, k, _ = grid_kv.shape
    table = cpb_table(w1, b1, w2, b2, w3, b3, side=side, kv_bound=kv_bound)
    taps, fracs = table_taps(
        table_shifts(grid_kv, side=side, kv_bound=kv_bound),
        side=side, tn=table.shape[0])
    return table_interp(table, taps, fracs, side).reshape(bh, k, side * side)


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


def cpb_bias_transposed_backward(grid_q, grid_kv, w1, b1, w2, b2, w3, b3,
                                 dbias):
    """K2-bwd wrapper: the forward's inputs and ``dbias`` (its output's
    shape) f32 -> ``(dgrid_kv, dw1, db1, dw2, db2, dw3, db3)`` f32
    (``csrc/cpb_exact_bwd.cu``, replaces ``_cpbt_bwd_kernel``)."""
    if grid_q.device.type == "cpu":
        return cpb_bias_transposed_backward_reference(
            grid_q, grid_kv, w1, b1, w2, b2, w3, b3, dbias)
    args = (grid_q, grid_kv, w1, b1, w2, b2, w3, b3)
    _on_card("cpb_bias_transposed_backward", args + (dbias,),
             (torch.float32,) * 9)
    BH, K, N, O = _check_exact_shapes("cpb_bias_transposed_backward", args)
    want = (BH, K, N) if O == 1 else (BH, O, K, N)
    if dbias.shape != want:
        raise ValueError(f"cpb_bias_transposed_backward: dbias "
                         f"{tuple(dbias.shape)}, want {want}")
    n_params = HID * (2 + 1 + HID + 1) + (HID + 1) * O
    grads = torch.empty(n_params, dtype=torch.float32, device=grid_q.device)
    dgrid_kv = torch.empty_like(grid_kv)
    if dbias.numel() == 0:  # nothing to launch, so nothing to count
        grads.zero_()
        dgrid_kv.zero_()
    else:
        from .build import check, kernels

        nparts = min(BH * K, EXACT_BWD_PARTS)
        partial = torch.empty((nparts, n_params), dtype=torch.float32,
                              device=grid_q.device)
        err = kernels().dmlt_cpb_exact_bwd(
            *(t.data_ptr() for t in args[:7]), dbias.data_ptr(),
            dgrid_kv.data_ptr(), grads.data_ptr(), partial.data_ptr(),
            BH * K, K, N, O, nparts, _stream(grid_q))
        check(err, "cpb_bias_transposed_backward")
        cpb_bias_transposed_backward.launches += 1
    shapes = [(2, HID), (HID,), (HID, HID), (HID,), (HID, O), (O,)]
    pieces = torch.split(grads, [math.prod(sh) for sh in shapes])
    return (dgrid_kv, *(p.view(sh) for p, sh in zip(pieces, shapes)))


cpb_bias_transposed_backward.launches = 0


class _CpbExact(torch.autograd.Function):
    """K2-fwd (``csrc/cpb_exact.cu``, replaces ``_cpbt_fwd_kernel``),
    counted in ``cpb_bias_transposed.launches``; backward
    :func:`cpb_bias_transposed_backward`."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        grid_q = args[0]
        if grid_q.device.type == "cpu":
            return cpb_bias_transposed_reference(*args)
        _on_card("cpb_bias_transposed", args, (torch.float32,) * 8)
        BH, K, N, O = _check_exact_shapes("cpb_bias_transposed", args)
        shape = (BH, K, N) if O == 1 else (BH, O, K, N)
        out = torch.empty(shape, dtype=torch.float32, device=grid_q.device)
        if out.numel() == 0:  # nothing to launch, so nothing to count
            return out
        from .build import check, kernels

        err = kernels().dmlt_cpb_exact_fwd(
            *(t.data_ptr() for t in args), out.data_ptr(), BH * K, K, N, O,
            _stream(grid_q))
        check(err, "cpb_bias_transposed")
        cpb_bias_transposed.launches += 1
        return out

    @staticmethod
    def backward(ctx, dbias):
        grads = cpb_bias_transposed_backward(*ctx.saved_tensors,
                                             dbias.contiguous())
        return (None, *grads)


def cpb_bias_transposed(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """K2: exact CPB in the kv-major layout, ``grid_q [N, 2]``, ``grid_kv
    [BH, K, 2]`` -> ``[BH, K, N]`` (O = 1) or ``[BH, O, K, N]``,
    differentiable with respect to ``grid_kv`` and the MLP weights."""
    return _CpbExact.apply(grid_q, grid_kv, w1, b1, w2, b2, w3, b3)


cpb_bias_transposed.launches = 0


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


def _check_table_shapes(name, table, taps, fracs, side):
    R = taps.shape[0]
    if (table.dim() != 2 or taps.shape != (R, 2) or fracs.shape != (R, 2)
            or min(table.shape) < side + 1):
        raise ValueError(f"{name}: bad shapes table {tuple(table.shape)}"
                         f" taps {tuple(taps.shape)} fracs {tuple(fracs.shape)}"
                         f" side {side}")


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


__all__ = ["HID", "cpb_bias_table", "cpb_bias_transposed",
           "cpb_bias_transposed_backward",
           "cpb_bias_transposed_backward_reference",
           "cpb_bias_transposed_reference", "cpb_table", "kv_bound_2d",
           "table_consts", "table_interp", "table_interp_backward",
           "table_interp_backward_reference", "table_interp_reference",
           "table_shifts", "table_taps"]

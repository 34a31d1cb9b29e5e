"""The fused divisor-1 table attention of ``DeformCrossAttention2D``
(``fused_table_attention``): the counterpart of ``fused_table_attention``
in ``disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py``
(:3135, the "v10" kernels).

One call computes, per ``bh`` of ``q [BH, N, D]`` (pre-scaled) and ``k, v
[BH, K, D]``: the divisor-1 table CPB windows of the ``BH*K`` kv rows
(``ops/cpb.py``, K1's arithmetic) as the bias, ``sim = k q^T + bias``, the
softmax over the K kv points, dropout at ``rate`` and ``out = drop(attn)^T
v``; it returns ``out [BH, N, D]`` and the map before dropout ``attn [BH,
K, N]``, both f32, and is differentiable with respect to q, k, v, the table
and the shifts (the map's own cotangent joins ``dp`` before the softmax
backward, as JAX's ``with_gattn=True`` does).  On the card that is kernel
K6-fwd (``csrc/fused_table.cu``) and K6-bwd (``csrc/fused_table_bwd.cu``,
whose ``ds`` goes through K1-bwd's kernels for the table scatter and the
shift cotangents); the bias never exists in device memory.

Dropout draws no random tensor: the kept elements are a counter-based hash
of ``(seed, (bh*K + k)*N + n)`` (:func:`dropout_keep_mask`, the same bits as
``csrc/fused_table.cuh``), so the forward and the backward regenerate the
same mask and the card's kernels and the plain version drop the same
elements.  The caller draws the seed from torch's RNG per call; JAX draws
it from its ``dropout`` RNG stream, whose bits this cannot match.

Wrapper rule, as in ``ops/cpb.py``: a tensor on the CPU goes to the plain
PyTorch version (:func:`fused_table_attention_reference`, the composition
that JAX's ``_v10_ref`` writes, with dropout, and
:func:`fused_table_attention_backward_reference`, autograd through it);
a CUDA tensor launches the kernels or raises.  There is no fallback.
:func:`fused_table_attention` counts forward launches in
``fused_table_attention.launches``, :func:`fused_table_attention_backward`
backward launches in ``fused_table_attention_backward.launches``, and
nowhere else.  The backward is deterministic.  JAX's ``v10_supported``
gate (the last 256-lane query group at least one window row wide) is a
TPU layout rule: the card's kernels take any ``N = side^2``.
"""

from __future__ import annotations

import torch

from .cpb import (SMEM_LIMIT, _on_card, _stream, table_interp_reference,
                  table_scatter_launch, table_taps)

MAX_KV = 160     # K of one block (csrc/fused_table.cuh kMaxK)
MAX_HEAD_DIM = 64  # D, a multiple of 4 (kMaxD)
# blocks that share one bh in K6-bwd, so that BH x splits fills the H100's
# 132 SMs (128 blocks at BH = 32); a function of BH alone, so the partial
# sums keep one order
BWD_BLOCKS = 132
_M32 = 0xFFFFFFFF


def _mix32_int(x: int) -> int:
    """``mix32`` of ``csrc/fused_table.cuh`` on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for an int64 tensor ``x`` in [0, 2^32), in
    16-bit halves of ``c`` so that no product leaves int64."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """An element is kept when the top 24 bits of its hash are at least
    ``round(rate * 2^24)``."""
    return int(round(rate * (1 << 24)))


def dropout_keep_mask(seed: int, shape, rate: float, device=None):
    """Bool ``[BH, K, N]``: the elements K6 keeps at ``rate`` for ``seed``
    (``dropout_keep`` of ``csrc/fused_table.cuh``, in int64 tensor ops
    masked to 32 bits)."""
    idx = torch.arange(shape[0] * shape[1] * shape[2], dtype=torch.int64,
                       device=device).reshape(shape)
    h = _mix32((idx & _M32) ^ _mix32((idx >> 32) ^ _mix32_int(seed)))
    return (h >> 8) >= dropout_threshold(rate)


def fused_table_attention_reference(q, k, v, table, shifts, side: int,
                                    seed: int = 0, rate: float = 0.0):
    """Plain version of K6: the table windows (K1's plain version), ``k
    q^T + bias``, the softmax over K, the dropout mask of
    :func:`dropout_keep_mask` scaled by ``1 / (1 - rate)``, then PV;
    ``(out [BH, N, D], attn [BH, K, N])``, autograd for its backward."""
    taps, fracs = table_taps(shifts, side=side, tn=table.shape[0])
    return _attend_reference(q, k, v, table, taps, fracs, side, seed, rate)


def _attend_reference(q, k, v, table, taps, fracs, side, seed, rate):
    BH, N, _ = q.shape
    K = k.shape[1]
    bias = table_interp_reference(table, taps, fracs, side).reshape(BH, K, N)
    attn = torch.softmax(torch.matmul(k, q.transpose(1, 2)) + bias, dim=1)
    p = attn
    if rate > 0.0:
        keep = dropout_keep_mask(seed, attn.shape, rate, attn.device)
        p = attn * keep * (1.0 / (1.0 - rate))
    return torch.matmul(p.transpose(1, 2), v), attn


def fused_table_attention_backward_reference(q, k, v, table, taps, fracs,
                                             g_out, g_attn, side: int,
                                             seed: int = 0, rate: float = 0.0):
    """Plain version of K6-bwd: autograd through the plain forward (from the
    taps and fractions of ``table_taps``) for the cotangents ``g_out`` and
    ``g_attn`` (None: the map was not used) -> ``(dq, dk, dv, dtable,
    dfracs)`` in the inputs' dtype."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v, table, fracs)]
    out, attn = _attend_reference(*leaves[:4], taps, leaves[4], side, seed,
                                  rate)
    return torch.autograd.grad(
        (out, attn), leaves,
        (g_out, torch.zeros_like(attn) if g_attn is None else g_attn))


def _check_fused_args(name, q, k, v, table, taps, fracs, side):
    """-> (BH, K, N, D), or raise unless K6's kernels take these tensors."""
    _on_card(name, (q, k, v, table, taps, fracs),
             (torch.float32,) * 4 + (torch.int32, torch.float32))
    BH, N, D = q.shape
    K = k.shape[1]
    if (k.shape != (BH, K, D) or v.shape != (BH, K, D) or N != side * side
            or table.dim() != 2 or min(table.shape) < side + 1
            or taps.shape != (BH * K, 2) or fracs.shape != (BH * K, 2)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} table "
                         f"{tuple(table.shape)} taps {tuple(taps.shape)} "
                         f"side {side}")
    if not 1 <= K <= MAX_KV or D % 4 or not 4 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: K {K} and D {D}: the kernels take "
                         f"K <= {MAX_KV} and D a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}")
    return BH, K, N, D


def _dropout_args(rate: float) -> tuple[int, float]:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate}: want 0 <= rate < 1")
    return dropout_threshold(rate), 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _forward_launch(q, k, v, table, taps, fracs, side, seed, rate):
    """K6-fwd on the card: ``(out, attn)``, counted."""
    from .build import check, kernels

    BH, K, N, D = _check_fused_args("fused_table_attention", q, k, v, table,
                                    taps, fracs, side)
    smem = kernels().dmlt_fused_table_fwd_smem(table.shape[0], table.shape[1],
                                               K, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_table_attention: table {tuple(table.shape)}, "
                         f"K {K} and D {D} need {smem} B of shared memory per "
                         f"block, more than {SMEM_LIMIT}")
    out = torch.empty_like(q)
    attn = torch.empty((BH, K, N), dtype=torch.float32, device=q.device)
    if BH == 0:  # nothing to launch, so nothing to count
        return out, attn
    threshold, scale = _dropout_args(rate)
    err = kernels().dmlt_fused_table_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        table.shape[0], table.shape[1], taps.data_ptr(), fracs.data_ptr(),
        out.data_ptr(), attn.data_ptr(), BH, K, N, D, side, seed, threshold,
        scale, _stream(q))
    check(err, "fused_table_attention")
    fused_table_attention.launches += 1
    return out, attn


def fused_table_attention_backward(q, k, v, table, taps, fracs, attn, g_out,
                                   g_attn, side: int, seed: int = 0,
                                   rate: float = 0.0):
    """K6-bwd wrapper: the forward's inputs (taps and fractions from
    ``table_taps``), its ``attn`` and the cotangents ``g_out [BH, N, D]``
    and ``g_attn [BH, K, N]`` (None: the map was not used) -> ``(dq, dk,
    dv, dtable, dfracs)``, f32 (``csrc/fused_table_bwd.cu`` then K1-bwd's
    kernels on its ``ds``; replaces ``_v10_bwd_kernel``)."""
    if q.device.type == "cpu":
        return fused_table_attention_backward_reference(
            q, k, v, table, taps, fracs, g_out, g_attn, side, seed, rate)
    BH, K, N, D = _check_fused_args("fused_table_attention_backward", q, k, v,
                                    table, taps, fracs, side)
    _on_card("fused_table_attention_backward",
             (q, attn, g_out) + (() if g_attn is None else (g_attn,)),
             (torch.float32,) * (3 + (g_attn is not None)))
    if (attn.shape != (BH, K, N) or g_out.shape != q.shape
            or (g_attn is not None and g_attn.shape != (BH, K, N))):
        raise ValueError("fused_table_attention_backward: attn, g_out or "
                         "g_attn has the wrong shape")
    from .build import check, kernels

    smem = kernels().dmlt_fused_table_bwd_smem(K, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_table_attention_backward: K {K} and D {D} "
                         f"need {smem} B of shared memory per block, more "
                         f"than {SMEM_LIMIT}")
    dq = torch.empty_like(q)
    dkv = torch.empty((2, BH, K, D), dtype=torch.float32, device=q.device)
    ds = torch.empty((BH * K, side, side), dtype=torch.float32,
                     device=q.device)
    dtable = torch.empty_like(table)
    dfracs = torch.empty_like(fracs)
    if BH == 0:  # nothing to launch, so nothing to count
        return dq, dkv[0], dkv[1], dtable.zero_(), dfracs
    splits = max(1, min(BWD_BLOCKS // BH, -(-N // 64)))
    partial = torch.empty((splits, 2, BH, K, D), dtype=torch.float32,
                          device=q.device)
    threshold, scale = _dropout_args(rate)
    err = kernels().dmlt_fused_table_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr(),
        g_out.data_ptr(), None if g_attn is None else g_attn.data_ptr(),
        dq.data_ptr(), dkv.data_ptr(), ds.data_ptr(), partial.data_ptr(), BH,
        K, N, D, splits, seed, threshold, scale, _stream(q))
    check(err, "fused_table_attention_backward")
    table_scatter_launch(table, taps, fracs, ds, side, dtable, dfracs)
    fused_table_attention_backward.launches += 1
    return dq, dkv[0], dkv[1], dtable, dfracs


fused_table_attention_backward.launches = 0


class _FusedTableAttention(torch.autograd.Function):
    """K6-fwd (``csrc/fused_table.cu``, replaces ``_v10_fwd_kernel``),
    counted in ``fused_table_attention.launches``; backward
    :func:`fused_table_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, table, shifts, side, seed, rate):
        taps, fracs = table_taps(shifts, side=side, tn=table.shape[0])
        out, attn = _forward_launch(q, k, v, table, taps, fracs, side, seed,
                                    rate)
        ctx.save_for_backward(q, k, v, table, taps, fracs, attn)
        ctx.side, ctx.seed, ctx.rate = side, seed, rate
        ctx.set_materialize_grads(False)
        return out, attn

    @staticmethod
    def backward(ctx, g_out, g_attn):
        q, k, v, table, taps, fracs, attn = ctx.saved_tensors
        g_out = torch.zeros_like(q) if g_out is None else g_out.contiguous()
        if g_attn is not None:
            g_attn = g_attn.contiguous()
        grads = fused_table_attention_backward(
            q, k, v, table, taps, fracs, attn, g_out, g_attn, ctx.side,
            ctx.seed, ctx.rate)
        return (*grads, None, None, None)


def fused_table_attention(q, k, v, table, shifts, side: int, seed: int = 0,
                          rate: float = 0.0):
    """K6: ``q [BH, N, D]`` (pre-scaled), ``k, v [BH, K, D]``, the divisor-1
    ``table [tn, tn]`` and the rows' lattice ``shifts [BH*K, 2]``
    (``ops/cpb.py table_shifts``), all f32, an int dropout ``seed`` and
    ``rate`` -> ``(out [BH, N, D], attn [BH, K, N])`` f32, ``attn`` before
    dropout; differentiable with respect to q, k, v, table and shifts."""
    if q.device.type == "cpu":
        return fused_table_attention_reference(q, k, v, table, shifts, side,
                                               seed, rate)
    return _FusedTableAttention.apply(q, k, v, table, shifts, side, seed,
                                      rate)


fused_table_attention.launches = 0

__all__ = ["dropout_keep_mask", "fused_table_attention",
           "fused_table_attention_backward",
           "fused_table_attention_backward_reference",
           "fused_table_attention_reference"]

"""The fused exact-CPB attention: the counterpart of the public entries of
the JAX Pallas package, ``fused_deform_attention`` (the "nk" tiles,
``disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py:361``) and
``fused_deform_attention_kn`` (v8, :1858).  As in JAX, no module and no
config key reaches it: it is an op.

One call computes, per ``bh`` of ``q [BH, N, D]`` (pre-scaled) and ``k, v
[BH, K, D]``: the exact CPB bias of every (query, kv point) pair from
``grid_q [N, 2]``, ``grid_kv [BH, K, 2]`` and the MLP weights (``ops/cpb.py``,
K2's arithmetic, one output channel), ``sim = q k^T + bias``, the softmax
over the K kv points, dropout at ``rate`` and ``out = drop(attn) v``; it
returns ``out [BH, N, D]`` and the map before dropout, ``attn [BH, N, K]``
in "nk" or ``[BH, K, N]`` in "kn", both f32.  It is differentiable with
respect to q, k, v, grid_kv and the weights (``grid_q`` is a constant grid),
and takes a cotangent on ``attn`` as well as on ``out``, as both JAX VJPs
do.  On the card that is kernel K7-fwd (``csrc/fused_exact.cu``) and K7-bwd
(``csrc/fused_exact_bwd.cu``, whose bias cotangent goes through K2-bwd's
kernels for the grid_kv and weight cotangents).

Dropout draws no random tensor: the mask is K6's counter hash of ``(seed,
(bh*K + k)*N + n)`` (``ops/fused_table.py dropout_keep_mask``), the same
element index in both layouts, so "nk" and "kn" drop the same entries and
the forward and the backward the same ones.  The TPU's PRNG cannot be
matched.  JAX's TPU restrictions (v8's ``K % 8 == 0 or K <= 8``, the nk
kernel's query tiles) are layout rules that the card's kernels do not
have: any N and any K (the kernels take the kv points in chunks of 160).

Wrapper rule, as in ``ops/cpb.py``: a tensor on the CPU goes to the plain
PyTorch version (:func:`fused_exact_attention_reference`, JAX's
``deform_attention_reference`` :390 with this dropout, and
:func:`fused_exact_attention_backward_reference`, autograd through it); a
CUDA tensor launches the kernels or raises.  There is no fallback.
:func:`fused_exact_attention` counts forward launches in
``fused_exact_attention.launches``, :func:`fused_exact_attention_backward`
backward launches in ``fused_exact_attention_backward.launches``, and
nowhere else.  The backward is deterministic.
"""

from __future__ import annotations

import torch

from .cpb import (SMEM_LIMIT, _check_exact_shapes, _exact_backward, _on_card,
                  _stream, cpb_bias_nk_reference)
from .fused_table import (BWD_BLOCKS, MAX_HEAD_DIM, _dropout_args,
                          dropout_keep_mask)

LAYOUTS = ("nk", "kn")


def fused_exact_attention_reference(q, k, v, grid_q, grid_kv, w1, b1, w2, b2,
                                    w3, b3, seed: int = 0, rate: float = 0.0,
                                    layout: str = "nk", bh0: int = 0):
    """Plain version of K7: the bias (K2-nk's plain version), ``q k^T +
    bias``, the softmax over K, the mask of ``dropout_keep_mask`` scaled by
    ``1 / (1 - rate)``, then PV; ``(out [BH, N, D], attn)``, ``attn`` in
    ``layout``; autograd for its backward.  ``bh0``: the index of the first
    batch-head in the mask, so that a slice of the batch-heads from ``bh0``
    on gets the elements of the whole call."""
    _check_layout(layout)
    bias = cpb_bias_nk_reference(grid_q, grid_kv, w1, b1, w2, b2, w3, b3)
    attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) + bias, dim=-1)
    p = attn
    if rate > 0.0:
        BH, N, K = attn.shape
        keep = dropout_keep_mask(seed, (BH, K, N), rate, attn.device,
                                 bh0 * K * N)
        p = attn * keep.transpose(1, 2) * (1.0 / (1.0 - rate))
    return (torch.matmul(p, v),
            attn if layout == "nk" else attn.transpose(1, 2).contiguous())


def fused_exact_attention_backward_reference(q, k, v, grid_q, grid_kv, w1, b1,
                                             w2, b2, w3, b3, g_out, g_attn,
                                             seed: int = 0, rate: float = 0.0,
                                             layout: str = "nk", bh0: int = 0):
    """Plain version of K7-bwd: autograd through the plain forward for the
    cotangents ``g_out`` and ``g_attn`` (in ``layout``; None: the map was
    not used) -> ``(dq, dk, dv, dgrid_kv, dw1, db1, dw2, db2, dw3, db3)``
    in the inputs' dtype (``bh0`` as in the forward)."""
    leaves = [t.detach().requires_grad_()
              for t in (q, k, v, grid_kv, w1, b1, w2, b2, w3, b3)]
    out, attn = fused_exact_attention_reference(
        *leaves[:3], grid_q, *leaves[3:], seed, rate, layout, bh0)
    return torch.autograd.grad(
        (out, attn), leaves,
        (g_out, torch.zeros_like(attn) if g_attn is None else g_attn))


def _check_layout(layout):
    if layout not in LAYOUTS:
        raise ValueError(f"attention layout {layout!r}: want one of {LAYOUTS}")


def _check_fused_args(name, q, k, v, cpb_args):
    """-> (BH, K, N, D), or raise unless K7's kernels take these tensors."""
    _on_card(name, (q, k, v) + cpb_args, (torch.float32,) * 11)
    BH, N, D = q.shape
    K = k.shape[1]
    if (k.shape != (BH, K, D) or v.shape != (BH, K, D)
            or cpb_args[1].shape[:2] != (BH, K) or cpb_args[0].shape[0] != N
            or cpb_args[6].shape[-1] != 1):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} grid_q "
                         f"{tuple(cpb_args[0].shape)} grid_kv "
                         f"{tuple(cpb_args[1].shape)} w3 "
                         f"{tuple(cpb_args[6].shape)}")
    _check_exact_shapes(name, cpb_args)
    if K < 1 or D % 4 or not 4 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: K {K} and D {D}: the kernels take "
                         f"K >= 1 and D a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}")
    if BH > 65535:
        raise ValueError(f"{name}: BH {BH} > 65535")
    return BH, K, N, D


def _forward_launch(q, k, v, cpb_args, seed, rate, layout):
    """K7-fwd on the card: ``(out, attn)``, counted."""
    from .build import check, kernels

    BH, K, N, D = _check_fused_args("fused_exact_attention", q, k, v,
                                    cpb_args)
    smem = kernels().dmlt_fused_exact_fwd_smem(K, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_exact_attention: K {K} and D {D} need {smem}"
                         f" B of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    nk = layout == "nk"
    out = torch.empty_like(q)
    attn = torch.empty((BH, N, K) if nk else (BH, K, N), dtype=torch.float32,
                       device=q.device)
    if BH == 0 or N == 0:  # nothing to launch, so nothing to count
        return out, attn
    threshold, scale = _dropout_args(rate)
    err = kernels().dmlt_fused_exact_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() for t in cpb_args), out.data_ptr(), attn.data_ptr(),
        BH, K, N, D, int(nk), seed, threshold, scale, _stream(q))
    check(err, "fused_exact_attention")
    fused_exact_attention.launches += 1
    return out, attn


def fused_exact_attention_backward(q, k, v, grid_q, grid_kv, w1, b1, w2, b2,
                                   w3, b3, attn, g_out, g_attn, seed: int = 0,
                                   rate: float = 0.0, layout: str = "nk"):
    """K7-bwd wrapper: the forward's inputs, its ``attn`` and the
    cotangents ``g_out [BH, N, D]`` and ``g_attn`` (laid out as ``attn``;
    None: the map was not used) -> ``(dq, dk, dv, dgrid_kv, dw1, db1, dw2,
    db2, dw3, db3)``, f32 (``csrc/fused_exact_bwd.cu``, then K2-bwd's
    kernels on its bias cotangent; replaces ``_bwd_kernel`` and
    ``_kn_bwd_kernel``)."""
    _check_layout(layout)
    cpb_args = (grid_q, grid_kv, w1, b1, w2, b2, w3, b3)
    if q.device.type == "cpu":
        return fused_exact_attention_backward_reference(
            q, k, v, *cpb_args, g_out, g_attn, seed, rate, layout)
    name = "fused_exact_attention_backward"
    BH, K, N, D = _check_fused_args(name, q, k, v, cpb_args)
    _on_card(name, (q, attn, g_out) + (() if g_attn is None else (g_attn,)),
             (torch.float32,) * (3 + (g_attn is not None)))
    want = (BH, N, K) if layout == "nk" else (BH, K, N)
    if (attn.shape != want or g_out.shape != q.shape
            or (g_attn is not None and g_attn.shape != want)):
        raise ValueError(f"{name}: attn, g_out or g_attn has the wrong shape")
    from .build import check, kernels

    smem = kernels().dmlt_fused_exact_bwd_smem(K, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: K {K} and D {D} need {smem} B of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    dq = torch.empty_like(q)
    dkv = torch.empty((2, BH, K, D), dtype=torch.float32, device=q.device)
    ds = torch.empty((BH, K, N), dtype=torch.float32, device=q.device)
    if BH == 0 or N == 0:  # nothing to launch, so nothing to count
        dq.zero_()
        dkv.zero_()
        ds.zero_()
        return (dq, dkv[0], dkv[1],
                *_exact_backward(name, cpb_args, ds, False))
    splits = max(1, min(BWD_BLOCKS // BH, -(-N // 64)))
    partial = torch.empty((splits, 2, BH, K, D), dtype=torch.float32,
                          device=q.device)
    threshold, scale = _dropout_args(rate)
    err = kernels().dmlt_fused_exact_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr(),
        g_out.data_ptr(), None if g_attn is None else g_attn.data_ptr(),
        dq.data_ptr(), dkv.data_ptr(), ds.data_ptr(), partial.data_ptr(), BH,
        K, N, D, splits, int(layout == "nk"), seed, threshold, scale,
        _stream(q))
    check(err, name)
    cpb_grads = _exact_backward(name, cpb_args, ds, False)
    fused_exact_attention_backward.launches += 1
    return (dq, dkv[0], dkv[1], *cpb_grads)


fused_exact_attention_backward.launches = 0


class _FusedExactAttention(torch.autograd.Function):
    """K7-fwd (``csrc/fused_exact.cu``, replaces ``_fwd_kernel`` and
    ``_kn_fwd_kernel``), counted in ``fused_exact_attention.launches``;
    backward :func:`fused_exact_attention_backward`."""

    @staticmethod
    def forward(ctx, seed, rate, layout, q, k, v, *cpb_args):
        out, attn = _forward_launch(q, k, v, cpb_args, seed, rate, layout)
        ctx.save_for_backward(q, k, v, *cpb_args, attn)
        ctx.seed, ctx.rate, ctx.layout = seed, rate, layout
        ctx.set_materialize_grads(False)
        return out, attn

    @staticmethod
    def backward(ctx, g_out, g_attn):
        *inputs, attn = ctx.saved_tensors
        g_out = (torch.zeros_like(inputs[0]) if g_out is None
                 else g_out.contiguous())
        if g_attn is not None:
            g_attn = g_attn.contiguous()
        dq, dk, dv, dgkv, *dw = fused_exact_attention_backward(
            *inputs, attn, g_out, g_attn, ctx.seed, ctx.rate, ctx.layout)
        return (None, None, None, dq, dk, dv, None, dgkv, *dw)


def fused_exact_attention(q, k, v, grid_q, grid_kv, w1, b1, w2, b2, w3, b3,
                          seed: int = 0, rate: float = 0.0,
                          layout: str = "nk"):
    """K7: ``q [BH, N, D]`` (pre-scaled), ``k, v [BH, K, D]``, ``grid_q [N,
    2]``, ``grid_kv [BH, K, 2]``, the CPB weights (``w3 [32, 1]``), all
    f32, an int dropout ``seed`` and ``rate`` -> ``(out [BH, N, D], attn)``
    f32, ``attn`` before dropout, ``[BH, N, K]`` in "nk" (JAX
    ``fused_deform_attention``) or ``[BH, K, N]`` in "kn" (JAX
    ``fused_deform_attention_kn``); differentiable with respect to q, k, v,
    grid_kv and the weights."""
    _check_layout(layout)
    if q.device.type == "cpu":
        return fused_exact_attention_reference(
            q, k, v, grid_q, grid_kv, w1, b1, w2, b2, w3, b3, seed, rate,
            layout)
    return _FusedExactAttention.apply(seed, rate, layout, q, k, v, grid_q,
                                      grid_kv, w1, b1, w2, b2, w3, b3)


fused_exact_attention.launches = 0

__all__ = ["LAYOUTS", "fused_exact_attention",
           "fused_exact_attention_backward",
           "fused_exact_attention_backward_reference",
           "fused_exact_attention_reference"]

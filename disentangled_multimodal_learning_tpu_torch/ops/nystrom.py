"""Nystrom (landmark) attention core and its iterative pseudo-inverse
(counterpart of ``disentangled_multimodal_learning_tpu/ops/nystrom.py`` and
``ops/pinv.py``).  Plain torch: the JAX package computes both outside any
Pallas kernel.

Both run in the inputs' dtype (f32 on the card and the CPU; JAX's bf16
operands are a TPU-only branch, not ported).  On the card the products must
not run in TF32: the pinv's cubic iteration amplifies their rounding, and
``models/factory.py full_f32_matmuls`` pins full f32 before any model runs.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import global_max


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6,
                       group=None) -> torch.Tensor:
    """``x [..., m, m]`` -> its approximate pseudo-inverse: ``z = x^T /
    (max column sum * max row sum)``, then ``iters`` unrolled steps of
    ``z <- 0.25 z (13 I - xz (15 I - xz (7 I - xz)))``.  The two maxima are
    over the WHOLE tensor (every batch row and head), as in JAX and the
    reference (``NystromAttention.py:26``), so a bag's result depends on
    its batch-mates; with a process ``group`` (the data group of a
    sharded step) over the rows of every rank of it
    (``parallel/mesh.py global_max``)."""
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    if group is None:
        z = x.transpose(-1, -2) / (col.max() * row.max())
    else:
        z = x.transpose(-1, -2) / (global_max(col, group)
                                   * global_max(row, group))
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13.0 * eye - (xz @ (15.0 * eye - (xz @ (7.0 * eye
                                                                 - xz)))))
    return z


def nystrom_attention(q, k, v, num_landmarks: int, pinv_iterations: int = 6,
                      pinv_group=None) -> torch.Tensor:
    """``q, k, v [B, H, N, D]`` (q already scaled by ``D**-0.5``) ->
    ``[B, H, N, D]``.  The sequence is zero-padded on the LEFT to a multiple
    of ``num_landmarks`` m; the landmarks are the means of m contiguous
    segments of ``l = n / m`` tokens; then three softmax blocks and
    ``(attn1 @ pinv(attn2)) @ (attn3 @ v)``, cropped back to the last N
    tokens (JAX ``nystrom.py:44-50``, ``:88``); ``pinv_group``: the pinv's
    process group (:func:`moore_penrose_pinv`)."""
    B, H, N, D = q.shape
    m = num_landmarks
    pad = (m - N % m) % m
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, pad, 0))
                   for t in (q, k, v))
    n = N + pad
    l = n // m
    q_land = q.unflatten(2, (m, l)).mean(dim=3)
    k_land = k.unflatten(2, (m, l)).mean(dim=3)
    attn1 = torch.softmax(q @ k_land.transpose(-1, -2), dim=-1)       # [n, m]
    attn2 = torch.softmax(q_land @ k_land.transpose(-1, -2), dim=-1)  # [m, m]
    attn3 = torch.softmax(q_land @ k.transpose(-1, -2), dim=-1)       # [m, n]
    out = ((attn1 @ moore_penrose_pinv(attn2, pinv_iterations, pinv_group))
           @ (attn3 @ v))
    return out[:, :, -N:] if pad else out

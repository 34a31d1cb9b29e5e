"""The Nystrom (landmark) attention core with the token axis sharded over
the ranks of a ``seq`` group (counterpart of
``disentangled_multimodal_learning_tpu/parallel/seq_shard.py``).

Each rank computes one contiguous chunk of the (left-padded) token axis,
which holds whole landmark segments, so the landmark math stays exact with
a few collectives of ``[B, H, m, D]`` or ``[B, H, m]``:

- the landmark means: each segment lies on one rank, which computes its
  mean as the unsharded core does; the ``[B, H, m, D]`` means are gathered
  (JAX's ``psum`` of zero-padded partials);
- ``attn1 = softmax_m(q_loc k_land^T)``: the softmax runs over the
  landmarks, so it is local;
- ``attn2`` and its pinv (``[m, m]``): every rank computes them;
- ``attn3 v``: the softmax runs over the sharded token axis, so the row
  max (no gradient) is a MAX all-reduce, the denominators and the local
  ``[m, D]`` products SUM all-reduces.

The chunk's output ``[B, H, n_loc, D]`` is gathered back into the whole
``[B, H, N, D]``: in JAX the core is the boundary of its ``shard_map``, and
TransMIL's other layers see every token, as here.  Every collective is
differentiable (``parallel/mesh.py``).  Under a ``(data, seq)`` layout the
pinv keeps JAX's normalisation by the maxima of its own data group's rows.
"""

from __future__ import annotations

import torch

from ..ops.nystrom import moore_penrose_pinv
from . import mesh


def check_chunks(n_tokens: int, num_landmarks: int, n_seq: int) -> tuple:
    """``(pad, padded length, tokens per landmark)``; raises where the
    padded length does not split into ``n_seq`` chunks of whole landmark
    segments (JAX ``seq_shard.py:94-103``)."""
    m = num_landmarks
    pad = (m - n_tokens % m) % m
    n = n_tokens + pad
    seg = n // m
    if n % n_seq:
        raise ValueError(f"padded length {n} must divide over {n_seq} ranks")
    if (n // n_seq) % seg:
        raise ValueError(
            f"per-rank chunk {n // n_seq} must hold whole landmark segments "
            f"of {seg} tokens (choose num_landmarks so that n/m divides "
            "n/n_seq)")
    return pad, n, seg


def nystrom_attention_seq_sharded(q, k, v, num_landmarks: int, group,
                                  pinv_iterations: int = 6, pinv_group=None):
    """The core of ``ops/nystrom.py nystrom_attention`` (same inputs ``q, k,
    v [B, H, N, D]``, q pre-scaled, same front padding, same result) with
    this rank computing its chunk of the token axis of ``group``."""
    B, H, N, D = q.shape
    m = num_landmarks
    n_seq, s = mesh.group_size(group), mesh.group_rank(group)
    pad, n, seg = check_chunks(N, m, n_seq)
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, pad, 0))
                   for t in (q, k, v))
    n_loc = n // n_seq
    q_loc, k_loc, v_loc = (t.narrow(2, s * n_loc, n_loc) for t in (q, k, v))
    m_loc = n_loc // seg
    q_land = mesh.gather_over(q_loc.unflatten(2, (m_loc, seg)).mean(dim=3),
                              2, group)
    k_land = mesh.gather_over(k_loc.unflatten(2, (m_loc, seg)).mean(dim=3),
                              2, group)
    attn1 = torch.softmax(q_loc @ k_land.transpose(-1, -2), dim=-1)
    attn2 = torch.softmax(q_land @ k_land.transpose(-1, -2), dim=-1)
    sim3 = q_land @ k_loc.transpose(-1, -2)                  # [B, H, m, n_loc]
    # the shift cancels in the softmax: no gradient through the max
    mx = mesh.all_reduce_(sim3.detach().amax(dim=-1), group,
                          torch.distributed.ReduceOp.MAX)
    e = torch.exp(sim3 - mx[..., None])
    denom = mesh.sum_over(e.sum(dim=-1), group)              # [B, H, m]
    attn3v = mesh.sum_over((e / denom[..., None]) @ v_loc, group)
    out = (attn1 @ moore_penrose_pinv(attn2, pinv_iterations, pinv_group)
           ) @ attn3v
    out = mesh.gather_over(out, 2, group)
    return out[:, :, -N:] if pad else out

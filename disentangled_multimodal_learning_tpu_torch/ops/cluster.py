"""DPC-KNN token clustering and the weighted merge of the student's token
reduction (counterpart of ``disentangled_multimodal_learning_tpu/ops/cluster.py``).

The assignment (:func:`dpc_knn_cluster`) runs the streamed passes of
``ops/dpc_knn.py`` (kernels K3 on the card) under ``torch.no_grad``; the
merge (:func:`merge_tokens`) is a one-hot weighted scatter-mean,
differentiable in the tokens and their weights.

The density tie-break noise (1e-6 x uniform) cannot be JAX's threefry draw
without JAX.  :func:`pinned_density_noise` is the port's fixed draw for eval
and ``deterministic_training``; training draws from the torch RNG.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .dpc_knn import dpc_knn_cluster_streamed


def pairwise_dist(x, y, eps: float = 1e-12):
    """Euclidean distances ``[B, N, C] x [B, M, C] -> [B, N, M]`` from the
    expansion ``|x|^2 + |y|^2 - 2 x.y``."""
    x2 = (x * x).sum(dim=-1, keepdim=True)
    y2 = (y * y).sum(dim=-1, keepdim=True)
    d2 = x2 + y2.transpose(1, 2) - 2.0 * torch.bmm(x, y.transpose(1, 2))
    return torch.sqrt(d2.clamp_min(eps))


@functools.lru_cache(maxsize=8)
def _pinned(shape: tuple, device: torch.device) -> torch.Tensor:
    # made once per shape and device: a copy from pageable host memory
    # would wait for the card at every forward
    g = torch.Generator().manual_seed(0)
    return torch.rand(shape, generator=g).to(device)


def pinned_density_noise(shape, device) -> torch.Tensor:
    """The fixed ``[B, N]`` tie-break draw of eval and
    ``deterministic_training``: ``torch.rand`` from a CPU generator seeded
    with 0, moved to ``device``, so every device sees the same values.
    (JAX draws ``uniform(PRNGKey(0))`` there; the parity tests substitute
    that draw for this function.)  Do not modify the result in place."""
    return _pinned(tuple(shape), torch.device(device))


def dpc_knn_cluster(x, cluster_num: int, k: int = 5, *, density_noise):
    """DPC-KNN assignment of ``x [B, N, C]``: ``(idx_cluster [B, N],
    index_down [B, cluster_num])``; no gradient flows through it."""
    with torch.no_grad():
        return dpc_knn_cluster_streamed(x.detach(), cluster_num, k,
                                        density_noise=density_noise)


def merge_tokens(x, idx_cluster, cluster_num: int, token_weight=None):
    """Weighted scatter-mean of ``x [B, N, C]`` into ``cluster_num`` clusters
    by ``idx_cluster [B, N]``, with ``token_weight [B, N, 1]`` (default
    ones) normalized per cluster (+1e-6) -> ``[B, cluster_num, C]``."""
    B, N, _ = x.shape
    w = (torch.ones((B, N), dtype=x.dtype, device=x.device)
         if token_weight is None else token_weight[..., 0])
    onehot = F.one_hot(idx_cluster, cluster_num).to(x.dtype)       # [B,N,K]
    all_weight = torch.einsum("bnk,bn->bk", onehot, w) + 1e-6
    denom = torch.einsum("bnk,bk->bn", onehot, all_weight)
    norm_w = w / denom
    return torch.einsum("bnk,bnc->bkc", onehot * norm_w[..., None], x)


def cluster_merge(x, cluster_num: int, token_weight=None, k: int = 5, *,
                  density_noise):
    """:func:`dpc_knn_cluster` then :func:`merge_tokens`."""
    idx_cluster, _ = dpc_knn_cluster(x, cluster_num, k,
                                     density_noise=density_noise)
    return merge_tokens(x, idx_cluster, cluster_num, token_weight)


def gene_guided_cluster(x, omic1, omic2):
    """Each token joins the omic stream (tumor 0 / immune 1) with the
    smaller mean distance -> ``[B, N]`` int32."""
    d1 = pairwise_dist(x, omic1).mean(dim=-1)
    d2 = pairwise_dist(x, omic2).mean(dim=-1)
    return (d1 > d2).to(torch.int32)

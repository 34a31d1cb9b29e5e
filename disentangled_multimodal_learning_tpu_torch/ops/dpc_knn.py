"""Streaming DPC-KNN: the counterpart of
``disentangled_multimodal_learning_tpu/ops/pallas/dpc_knn.py``.

Density-peak clustering needs, per token, the k nearest squared distances
(its local density), the row max (the distance scale) and the nearest
squared distance to a token of strictly higher density (its parent).  Two
passes over the token pairs give them, and the ``[B, N, N]`` distance
matrix never exists on the card:

- :func:`knn_stream` (kernel K3-knn, ``csrc/dpc_knn.cu``, replaces
  ``_knn_kernel``): ``x [B, N, C]``, ``x2 = |x|^2 [B, N]`` -> the k <= 8
  smallest ``d2 = (x2[j] + x2[i]) - 2 x_i.x_j`` per token, ascending, with
  duplicates kept (a multiset), ``[B, N, k]``, and the row max ``[B, N]``;
- :func:`parent_stream` (kernel K3-parent, replaces ``_parent_kernel``):
  the same ``d2`` and ``density [B, N]`` -> the min of ``d2`` over the
  tokens of strictly higher density, ``3e38`` where there is none.

Wrapper rule, as in ``ops/cpb.py``: a tensor on the CPU goes to the plain
PyTorch version (``*_reference``: the full ``d2`` by ``torch.bmm``, then
``topk``, ``amax`` and a masked ``amin``; also what the card's kernels are
checked against); a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in ``<wrapper>.launches``.  No gradient flows:
the cluster assignment runs under ``torch.no_grad`` (``ops/cluster.py``).

:func:`dpc_knn_cluster_streamed` does the rest as the JAX function does
(density, parent distance, centres by top-k, nearest-centre assignment).
"""

from __future__ import annotations

import torch

from .cpb import SMEM_LIMIT, _on_card, _stream

KMAX = 8       # the kernels' k-smallest multiset (k <= 8)
BIG = 3.0e38   # "no higher-density token" (the TPU kernel's _BIG)
EPS = 1e-12


def squared_distances(x, x2):
    """``[B, N, N]`` with ``d2[b, i, j] = (x2[j] + x2[i]) - 2 x_i.x_j``, the
    kernels' expression (any float dtype)."""
    return (x2[:, None, :] + x2[:, :, None]) - 2.0 * torch.bmm(
        x, x.transpose(1, 2))


def knn_stream_reference(x, x2, k: int):
    """Plain version of K3-knn -> ``(knn2 [B, N, k], rowmax2 [B, N])``."""
    d2 = squared_distances(x, x2)
    return torch.topk(d2, k, dim=-1, largest=False).values, d2.amax(dim=-1)


def parent_stream_reference(x, x2, density):
    """Plain version of K3-parent -> ``parent2 [B, N]``."""
    d2 = squared_distances(x, x2)
    higher = density[:, None, :] > density[:, :, None]  # [b, i, j]
    return torch.where(higher, d2, torch.full_like(d2, BIG)).amin(dim=-1)


def _check(name, x, x2, density=None, k=None):
    """Shapes (both paths), then, for a CUDA tensor, what the kernels take."""
    if x.dim() != 3 or x2.shape != x.shape[:2] or (
            density is not None and density.shape != x.shape[:2]):
        raise ValueError(f"{name}: x {tuple(x.shape)}, x2 {tuple(x2.shape)}"
                         + ("" if density is None else
                            f", density {tuple(density.shape)}")
                         + "; want [B, N, C], [B, N]")
    B, N, C = x.shape
    if k is not None and not 1 <= k <= min(KMAX, N):
        raise ValueError(f"{name}: k={k}, want 1 <= k <= min({KMAX}, N={N})")
    if x.device.type == "cpu":
        return
    tensors = (x, x2) if density is None else (x, x2, density)
    _on_card(name, tensors, (torch.float32,) * len(tensors))
    if C % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads x as float4 rows: C={C} "
                         "must be a multiple of 4 and x 16-byte aligned")
    from .build import kernels

    smem = kernels().dmlt_dpc_smem_bytes(C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: C={C} needs {smem} B of shared memory per "
                         f"block, more than {SMEM_LIMIT}")


def knn_stream(x, x2, k: int):
    """K3-knn: ``x [B, N, C]``, ``x2 [B, N]`` f32 -> ``(knn2 [B, N, k]``
    ascending, ``rowmax2 [B, N])``."""
    _check("knn_stream", x, x2, k=k)
    if x.device.type == "cpu":
        return knn_stream_reference(x, x2, k)
    B, N, C = x.shape
    knn2 = torch.empty((B, N, k), dtype=torch.float32, device=x.device)
    rmax2 = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if knn2.numel() == 0:  # nothing to launch, so nothing to count
        return knn2, rmax2
    from .build import check, kernels

    err = kernels().dmlt_dpc_knn(x.data_ptr(), x2.data_ptr(), B, N, C, k,
                                 knn2.data_ptr(), rmax2.data_ptr(), _stream(x))
    check(err, "knn_stream")
    knn_stream.launches += 1
    return knn2, rmax2


knn_stream.launches = 0


def parent_stream(x, x2, density):
    """K3-parent: ``x [B, N, C]``, ``x2``, ``density [B, N]`` f32 ->
    ``parent2 [B, N]``."""
    _check("parent_stream", x, x2, density)
    if x.device.type == "cpu":
        return parent_stream_reference(x, x2, density)
    B, N, C = x.shape
    parent2 = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if parent2.numel() == 0:  # nothing to launch, so nothing to count
        return parent2
    from .build import check, kernels

    err = kernels().dmlt_dpc_parent(x.data_ptr(), x2.data_ptr(),
                                    density.data_ptr(), B, N, C,
                                    parent2.data_ptr(), _stream(x))
    check(err, "parent_stream")
    parent_stream.launches += 1
    return parent2


parent_stream.launches = 0


def dpc_knn_cluster_streamed(x, cluster_num: int, k: int = 5, *,
                             density_noise):
    """DPC-KNN assignment of ``x [B, N, C]`` (LayerNormed tokens) into
    ``cluster_num`` clusters, as ``dpc_knn_cluster_streamed`` in JAX:
    density ``exp(-mean(max(knn2, eps)) / C) + 1e-6 * density_noise``, the
    parent distance clipped by the batch's largest distance, the centres
    by top-k of ``parent_dist * density``, every token to its nearest
    centre, each centre to its own cluster.  Returns ``(idx_cluster
    [B, N], index_down [B, cluster_num])`` int64."""
    from .cluster import pairwise_dist

    B, N, C = x.shape
    x = x.float().contiguous()
    x2 = (x * x).sum(dim=-1)
    knn2, rmax2 = knn_stream(x, x2, k)
    density = torch.exp(-knn2.clamp_min(EPS).mean(dim=-1) / C)
    density = density + density_noise * 1e-6
    parent2 = parent_stream(x, x2, density)
    scale = 1.0 / (C ** 0.5)
    dist_max = torch.sqrt(rmax2.amax(dim=1).clamp_min(EPS)) * scale
    parent_dist = torch.minimum(torch.sqrt(parent2.clamp_min(EPS)) * scale,
                                dist_max[:, None])
    score = parent_dist * density
    # top-k with jax.lax.top_k's order: equal scores by ascending index.
    # Equal scores are common: duplicated tokens (padded bags) share one
    # density up to the 1e-6 noise, which f32 resolves into a few levels
    # near 1, and the top level's tokens all get dist_max as their parent
    index_down = torch.sort(score, dim=-1, descending=True,
                            stable=True).indices[:, :cluster_num]  # [B, K]

    # nearest centre; the [B, K, N] rows are recomputed from the centres
    xc = torch.gather(x, 1, index_down[:, :, None].expand(-1, -1, C))
    idx_cluster = (pairwise_dist(xc, x) * scale).argmin(dim=1)     # [B, N]
    # each centre forms its own cluster (reference ClusterMergeNet :124-126)
    ids = torch.arange(cluster_num, device=x.device).expand(B, -1)
    return idx_cluster.scatter(1, index_down, ids), index_down


__all__ = ["BIG", "KMAX", "dpc_knn_cluster_streamed", "knn_stream",
           "knn_stream_reference", "parent_stream", "parent_stream_reference",
           "squared_distances"]

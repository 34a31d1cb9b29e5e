"""The port's DPC-KNN (``ops/dpc_knn.py``, ``ops/cluster.py``) against the
JAX package on the CPU: the plain versions of the two streamed passes
against the Pallas kernels in interpret mode, the cluster assignment against
both JAX paths (the streamed kernels and the XLA path), the weighted merge
and its gradients, and the gene-guided split.

Tolerances: the squared distances are differences of terms up to
``2 max |x|^2``, and the port's ``torch.bmm`` sums the dot in another order
than JAX's ``jnp.dot`` (measured up to 2.6e-7 of that scale), so values
within 1e-6 of it; indices exactly (the 1e-6 density noise is the same
array on both sides); the merge within 1e-6 (f32, other sum orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.ops import cluster as jcluster
from disentangled_multimodal_learning_tpu.ops.pallas import dpc_knn as jdpc
from disentangled_multimodal_learning_tpu_torch.ops import cluster, dpc_knn

REL_TOL = 1e-6
CASES = [(2, 300, 32, 6, 5), (1, 512, 16, 4, 3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(rng, B, N, C):
    return (rng.normal(size=(B, N, C)).astype(np.float32),
            rng.uniform(size=(B, N)).astype(np.float32))


def _duplicates(rng):
    """JAX's stress case: half of each bag is one repeated vector, plus a
    duplicated pair, so that distances tie exactly everywhere."""
    x = rng.normal(size=(2, 280, 16)).astype(np.float32)
    x[:, 140:, :] = 0.25
    x[:, 10, :] = x[:, 11, :]
    return x, rng.uniform(size=(2, 280)).astype(np.float32)


@pytest.mark.parametrize("B,N,C,K,k", CASES)
def test_streamed_passes_match_the_pallas_kernels(rng, B, N, C, K, k):
    x, _ = _tokens(rng, B, N, C)
    density = rng.uniform(size=(B, N)).astype(np.float32)
    knn2, rmax2, parent_fn = jdpc._stream_calls(jnp.asarray(x), k, True)
    parent2 = parent_fn(jnp.asarray(density))
    xt = _t(x)
    x2 = (xt * xt).sum(-1)
    tol = REL_TOL * 2 * x2.max().item()
    before = (dpc_knn.knn_stream.launches, dpc_knn.parent_stream.launches)
    got_knn, got_rmax = dpc_knn.knn_stream(xt, x2, k)
    got_parent = dpc_knn.parent_stream(xt, x2, _t(density))
    # the CPU runs the plain versions and counts no launch
    assert (dpc_knn.knn_stream.launches,
            dpc_knn.parent_stream.launches) == before
    assert got_knn.shape == (B, N, k) and got_rmax.shape == (B, N)
    assert (got_knn[..., 1:] >= got_knn[..., :-1]).all()  # ascending
    for got, want in ((got_knn, knn2), (got_rmax, rmax2),
                      (got_parent, parent2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
    # the densest token of each bag has no parent: the sentinel, exactly
    top = density.argmax(axis=1)
    assert (got_parent[np.arange(B), top] == dpc_knn.BIG).all()


def test_knn_keeps_duplicates_as_a_multiset():
    """Four copies of one token and two of another: each copy's k smallest
    distances repeat the tie as often as it occurs."""
    x = torch.tensor([[[1.0, 0.0]] * 4 + [[0.0, 2.0]] * 2])
    x2 = (x * x).sum(-1)
    knn2, rmax2 = dpc_knn.knn_stream(x, x2, 5)
    assert knn2[0, 0].tolist() == [0.0, 0.0, 0.0, 0.0, 5.0]
    assert knn2[0, 4].tolist() == [0.0, 0.0, 5.0, 5.0, 5.0]
    assert rmax2[0].tolist() == [5.0] * 6
    parent = dpc_knn.parent_stream(
        x, x2, torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5, 0.6]]))
    big = float(np.float32(dpc_knn.BIG))
    assert parent[0].tolist() == [0.0, 0.0, 0.0, 5.0, 0.0, big]


@pytest.mark.parametrize("case", CASES + ["duplicates"])
def test_dpc_knn_cluster_indices_match_both_jax_paths(rng, case):
    if case == "duplicates":
        x, noise = _duplicates(rng)
        K, k = 5, 5
    else:
        B, N, C, K, k = case
        x, noise = _tokens(rng, B, N, C)
    xla = jcluster.dpc_knn_cluster(jnp.asarray(x), K, k=k,
                                   density_noise=jnp.asarray(noise),
                                   use_kernel=False)
    streamed = jdpc.dpc_knn_cluster_streamed(
        jnp.asarray(x), K, k=k, density_noise=jnp.asarray(noise),
        interpret=True)
    idx, centers = cluster.dpc_knn_cluster(_t(x), K, k,
                                           density_noise=_t(noise))
    assert idx.shape == x.shape[:2] and centers.shape == (x.shape[0], K)
    for want_idx, want_centers in (xla, streamed):
        np.testing.assert_array_equal(centers.numpy(),
                                      np.asarray(want_centers))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_assignment_is_outside_autograd(rng):
    x, noise = _tokens(rng, 1, 64, 8)
    xt = _t(x).requires_grad_()
    idx, centers = cluster.dpc_knn_cluster(xt, 3, 5, density_noise=_t(noise))
    assert not idx.requires_grad and not centers.requires_grad
    w = torch.ones(1, 64, 1, requires_grad=True)
    merged = cluster.cluster_merge(xt, 3, w, density_noise=_t(noise))
    merged.sum().backward()
    assert xt.grad is not None and w.grad is not None


@pytest.mark.parametrize("weighted", [True, False])
def test_merge_tokens_values_and_gradients_match_jax(rng, weighted):
    B, N, C, K = 2, 30, 8, 3
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, K, size=(B, N))
    idx[:, :K] = np.arange(K)  # every cluster populated
    w = rng.uniform(0.1, 2.0, size=(B, N, 1)).astype(np.float32)
    r = rng.normal(size=(B, K, C)).astype(np.float32)

    def jloss(xx, ww):
        return jnp.sum(jcluster.merge_tokens(
            xx, jnp.asarray(idx, jnp.int32), K,
            ww if weighted else None) * r)

    want = jcluster.merge_tokens(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                 K, jnp.asarray(w) if weighted else None)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = cluster.merge_tokens(xt, _t(idx), K, wt if weighted else None)
    (got * _t(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6,
                               atol=1e-6)
    if weighted:
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw),
                                   rtol=1e-5, atol=1e-6)


def test_gene_guided_cluster_matches_jax(rng):
    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    omic1 = rng.normal(size=(2, 3, 16)).astype(np.float32)
    omic2 = (rng.normal(size=(2, 5, 16)) + 0.5).astype(np.float32)
    want = jcluster.gene_guided_cluster(*(jnp.asarray(a)
                                          for a in (x, omic1, omic2)))
    got = cluster.gene_guided_cluster(_t(x), _t(omic1), _t(omic2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()  # both streams get tokens


def test_pinned_density_noise_is_one_fixed_draw():
    a = cluster.pinned_density_noise((2, 30), "cpu")
    b = cluster.pinned_density_noise([2, 30], torch.device("cpu"))
    assert a.shape == (2, 30) and torch.equal(a, b)
    assert ((a >= 0) & (a < 1)).all()
    g = torch.Generator().manual_seed(0)
    assert torch.equal(a, torch.rand((2, 30), generator=g))


def test_stream_wrappers_refuse_bad_inputs():
    """Shapes and k are checked on every device; a tensor on neither the
    CPU nor a CUDA device is refused (no fallback to the plain version)."""
    x, x2 = torch.zeros(1, 6, 4), torch.zeros(1, 6)
    with pytest.raises(ValueError, match="k=9"):
        dpc_knn.knn_stream(x, x2, 9)
    with pytest.raises(ValueError, match="k=7"):
        dpc_knn.knn_stream(x, x2, 7)  # more than N
    with pytest.raises(ValueError, match=r"\[B, N, C\]"):
        dpc_knn.parent_stream(x, x2, torch.zeros(1, 5))
    meta = torch.empty(1, 6, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dpc_knn.knn_stream(meta, torch.empty(1, 6, device="meta"), 3)

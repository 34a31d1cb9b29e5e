"""The port's modules that no factory mode builds, against the JAX package
on the CPU: ``GatedABMIL``, ``TrilinearFusion`` (variants A and B, with and
without the bilinear gates and the skip), ``FeedForward``,
``CrossAttLayer`` and a 2-layer ``Nystromformer``, each with JAX's
parameters loaded strictly through ``utils/jax_params.jax_module_state_dict``
(biases drawn off 0 with numpy); and the reference factories
``define_act_layer`` and ``define_bifusion``.  Small shapes; one torch
thread a test.

Tolerances: f32 eval-mode forwards within ``FWD_TOL`` abs (1e-5; other
summation orders), the Nystrom stack within ``NYSTROM_TOL`` (5e-5: its
pinv amplifies f32 rounding, as in ``tests/test_torch_baselines.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models import factory as jfactory
from disentangled_multimodal_learning_tpu.models import fusion as jfusion
from disentangled_multimodal_learning_tpu.models import layers as jlayers
from disentangled_multimodal_learning_tpu.models import mil as jmil
from disentangled_multimodal_learning_tpu_torch.models import factory
from disentangled_multimodal_learning_tpu_torch.models import fusion
from disentangled_multimodal_learning_tpu_torch.models import layers
from disentangled_multimodal_learning_tpu_torch.models import mil
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    jax_module_state_dict)

FWD_TOL, NYSTROM_TOL = 1e-5, 5e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(module, *inputs, seed=0):
    """``module.init`` params with every 1-D leaf (biases, LayerNorm
    scales) moved off its init by N(0, 0.1), so that a bias mapped to the
    wrong place shows."""
    params = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                                 *inputs)["params"])
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                   if v.ndim == 1 else v), params)


def _load(model, params, name):
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_module_state_dict(params, name).items()},
                          strict=True)
    return model.eval()


def _pair(rng, *shapes):
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def test_gated_abmil_matches_jax():
    """GatedABMIL at the reference's width (1024-d patches, D 128): the
    sigmoid probabilities and their argmax."""
    rng = np.random.default_rng(0)
    (jx,), (tx,) = _pair(rng, (2, 10, 1024))
    jm = jmil.GatedABMIL(label_dim=3)
    params = _jax_params(jm, jx)
    jprob, jpred = jax.jit(jm.apply)({"params": params}, jx)
    model = _load(mil.GatedABMIL(label_dim=3), params, "GatedABMIL")
    with torch.no_grad():
        prob, pred = model(tx)
    assert prob.shape == (2, 3) and pred.shape == (2,)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert ((prob >= 0) & (prob <= 1)).all()


@pytest.mark.parametrize("variant,kw", [
    ("A", {}), ("B", {}), ("A", {"use_bilinear": 0, "skip": 0}),
    ("B", {"gate2": 0, "scale_dim1": 2, "scale_dim3": 4})])
def test_trilinear_fusion_matches_jax(variant, kw):
    """TrilinearFusion's gating pairs per variant, the linear gates, no
    skip, a gate off and scaled branch widths, in eval mode."""
    rng = np.random.default_rng(1)
    dims = dict(dim1=8, dim2=12, dim3=16)
    jv, tv = _pair(rng, (3, 8), (3, 12), (3, 16))
    jm = jfusion.TrilinearFusion(variant=variant, mmhid=24, **dims, **kw)
    params = _jax_params(jm, *jv)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *jv))
    model = _load(fusion.TrilinearFusion(variant=variant, mmhid=24, **dims,
                                         **kw), params, "TrilinearFusion")
    with torch.no_grad():
        got = model(*tv).numpy()
    assert got.shape == (3, 24) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_feed_forward_and_cross_att_layer_match_jax():
    """FeedForward (exact GELU) and CrossAttLayer (LayerNorm eps 1e-6, 8
    heads, the residual) in eval mode."""
    rng = np.random.default_rng(2)
    (jx,), (tx,) = _pair(rng, (2, 7, 32))
    jm = jlayers.FeedForward(dim=32)
    params = _jax_params(jm, jx)
    model = _load(layers.FeedForward(32), params, "FeedForward")
    with torch.no_grad():
        got = model(tx).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(
        {"params": params}, jx)), rtol=0, atol=FWD_TOL)
    (j1, j2), (t1, t2) = _pair(rng, (2, 5, 64), (2, 9, 64))
    jm = jlayers.CrossAttLayer(dim=64)
    params = _jax_params(jm, j1, j2)
    model = _load(layers.CrossAttLayer(64), params, "CrossAttLayer")
    with torch.no_grad():
        got = model(t1, t2).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(
        {"params": params}, j1, j2)), rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("residual", [True, False])
def test_nystromformer_matches_jax(residual):
    """A 2-layer Nystromformer (JAX ``tests/test_layers.py``'s shape: 40
    tokens of 32, 4 heads of 8, 8 landmarks) with and without the value
    residual; the port's stack is the pre-norm NystromAttention and
    FeedForward blocks over ``ops/nystrom.py``."""
    rng = np.random.default_rng(3)
    (jx,), (tx,) = _pair(rng, (2, 40, 32))
    kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_landmarks=8,
              attn_values_residual=residual)
    jm = jlayers.Nystromformer(**kw)
    params = _jax_params(jm, jx)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jx))
    model = _load(layers.Nystromformer(**kw), params, "Nystromformer")
    with torch.no_grad():
        got = model(tx).numpy()
    assert got.shape == (2, 40, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=NYSTROM_TOL)
    assert any(k.endswith("res_conv.weight")
               for k in model.state_dict()) == residual


@pytest.mark.parametrize("act", ["Tanh", "ReLU", "Sigmoid", "LSM", "none"])
def test_act_layer_factory_matches_jax(act):
    x = np.random.default_rng(4).normal(size=(2, 3)).astype(np.float32)
    fn, jfn = factory.define_act_layer(act), jfactory.define_act_layer(act)
    if act == "none":
        assert fn is None and jfn is None
        return
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                               np.asarray(jfn(jnp.asarray(x))), rtol=0,
                               atol=1e-6)
    if act == "LSM":
        np.testing.assert_allclose(
            np.exp(fn(torch.from_numpy(x)).numpy()).sum(1), 1.0, atol=1e-5)


def test_act_and_bifusion_factories_refuse_unknown_names():
    with pytest.raises(NotImplementedError):
        factory.define_act_layer("nope")
    with pytest.raises(NotImplementedError):
        factory.define_bifusion("concat")


def test_bifusion_factory_builds_jax_bilinear_fusion():
    """``define_bifusion("pofusion", ...)`` is a BilinearFusion of those
    arguments: with JAX's params and batch statistics its eval output is
    JAX's; a train-mode forward moves the running statistics."""
    rng = np.random.default_rng(5)
    (j1, j2), (t1, t2) = _pair(rng, (4, 16), (4, 16))
    kw = dict(dim1=16, dim2=16, mmhid=32)
    jm = jfactory.define_bifusion("pofusion", **kw)
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)},
                                       j1, j2, deterministic=True))
    want = np.asarray(jm.apply(variables, j1, j2, deterministic=True))
    model = factory.define_bifusion("pofusion", **kw)
    assert isinstance(model, fusion.BilinearFusion)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_module_state_dict(
                               variables["params"], "BilinearFusion",
                               variables["batch_stats"]).items()},
                          strict=True)
    with torch.no_grad():
        got = model.eval()(t1, t2).numpy()
        assert got.shape == (4, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
        before = model.encoder1_bn.running_mean.clone()
        model.train()(t1, t2)
    assert not torch.equal(before, model.encoder1_bn.running_mean)

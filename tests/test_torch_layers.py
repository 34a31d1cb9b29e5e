"""The port's modules (``disentangled_multimodal_learning_tpu_torch/models``)
against their JAX counterparts on the CPU: the same numpy inputs, the JAX
module's own init exported to reference names (``utils/torch_export.py``)
and loaded with ``strict=True``.

Tolerances (f32): 1e-5 abs on module outputs of O(1), which is what
another matmul sum order leaves after a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models import layers as jl
from disentangled_multimodal_learning_tpu.models.maxnet import MaxNet as JMaxNet
from disentangled_multimodal_learning_tpu.utils import torch_export as te
from disentangled_multimodal_learning_tpu_torch.models import layers as tl
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention2D)
from disentangled_multimodal_learning_tpu_torch.models.factory import init_weights
from disentangled_multimodal_learning_tpu_torch.models.maxnet import MaxNet

TOL = 1e-5


def _load(module, export, params):
    """Export one JAX module's params under the prefix ``m`` and load them."""
    out = {}
    export(params, "m", out)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                            for k, v in out.items()}, strict=True)
    return module.eval()


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_maxnet_matches_jax(rng):
    x = rng.normal(size=(3, 59)).astype(np.float32)
    jm = JMaxNet(input_dim=59, omic_dim=128, dropout_rate=0.1, label_dim=4)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    feats, logits, _ = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(MaxNet(59, 128, 0.1, 4), te._maxnet, params)
    with torch.no_grad():
        tf, tlog = tm(torch.from_numpy(x))
    _close(tf, feats)
    _close(tlog, logits)


def test_transfusion_layer_matches_jax(rng):
    x1 = rng.normal(size=(2, 16, 128)).astype(np.float32)
    x2 = rng.normal(size=(2, 1, 128)).astype(np.float32)
    jm = jl.TransFusionLayer(128)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x1),
                     jnp.asarray(x2))["params"]
    want, _ = jm.apply({"params": params}, jnp.asarray(x1), jnp.asarray(x2))
    tm = _load(tl.TransFusionLayer(128), te._transfusion, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (2, 1, 128)
    _close(got, want)
    assert tm.norm.eps == 1e-6


def test_pooler_and_fusionnet_match_jax(rng):
    a = rng.normal(size=(2, 7, 16)).astype(np.float32)
    b = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jp = jl.Pooler(16)
    pp = jp.init(jax.random.PRNGKey(3), jnp.asarray(a))["params"]
    tp = _load(tl.Pooler(16), lambda p, k, o: te._dense(p["dense"],
                                                        f"{k}.dense", o), pp)
    jf = jl.FusionNet(16)
    pf = jf.init(jax.random.PRNGKey(4), jnp.asarray(a), jnp.asarray(b))["params"]
    tf = _load(tl.FusionNet(16), lambda p, k, o: te._dense(
        p["fusion_layer"], f"{k}.fusion_layer", o), pf)
    with torch.no_grad():
        _close(tp(torch.from_numpy(a)), jp.apply({"params": pp}, jnp.asarray(a)))
        _close(tf(torch.from_numpy(a), torch.from_numpy(b)),
               jf.apply({"params": pf}, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("mode", ["average", "weighted", "softmax_average",
                                  "max_confidence"])
def test_combine_logits_matches_jax(rng, mode):
    l1 = rng.normal(size=(6, 4)).astype(np.float32)
    l2 = rng.normal(size=(6, 4)).astype(np.float32)
    got = tl.combine_logits(torch.from_numpy(l1), torch.from_numpy(l2), mode)
    _close(got, jl.combine_logits(jnp.asarray(l1), jnp.asarray(l2), mode),
           atol=1e-6)


def test_combine_logits_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tl.combine_logits(torch.zeros(1, 2), torch.zeros(1, 2), "median")


def test_survival_chain_matches_jax(rng):
    logits = rng.normal(size=(3, 4)).astype(np.float32)
    for got, want in zip(tl.survival_chain(torch.from_numpy(logits)),
                         jl.survival_chain(jnp.asarray(logits))):
        _close(got, want, atol=1e-6)


@pytest.mark.parametrize("divisor", [1, 0, 2, 4])
def test_deform_cross_attention_matches_jax(rng, divisor):
    """The whole 2-D deformable attention in the kn layout [B, H, K, N]:
    divisors 1, 2 and 4 take the table CPB (JAX: jnp interpolation of
    ``cpb_bias_table`` at that divisor), divisor 0 the exact CPB (JAX:
    ``_cpb_mlp``).  fixdim 144 gives a 3x3 deformed kv grid (K = 9)."""
    B, N, C = 2, 144, 128
    x1 = rng.normal(size=(B, N, C)).astype(np.float32)
    x2 = rng.normal(size=(B, N, C)).astype(np.float32)
    jm = jda.DeformCrossAttention2D(
        dim=C, dim_head=64, heads=8, dropout=0.0, downsample_factor=4,
        offset_scale=4, offset_groups=8, offset_kernel_size=6,
        attn_layout="kn", cpb_table_divisor=divisor)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x1),
                     jnp.asarray(x2))["params"]
    want_out, want_attn = jm.apply({"params": params}, jnp.asarray(x1),
                                   jnp.asarray(x2))
    tm = _load(DeformCrossAttention2D(C, cpb_table_divisor=divisor),
               te._attn2d, params)
    with torch.no_grad():
        out, attn = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    assert attn.shape == want_attn.shape == (B, 8, 9, N)
    _close(out, want_out)
    _close(attn, want_attn)


def test_bf16_streams_stay_f32_on_the_cpu(rng):
    """``attn_bf16_streams`` lowers the attention only on the card: on the
    CPU the module computes exactly what it computes without it, in f32."""
    x1 = torch.from_numpy(rng.normal(size=(2, 64, 128)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(2, 64, 128)).astype(np.float32))
    outs = []
    for bf16 in (False, True):
        m = DeformCrossAttention2D(128, cpb_table_divisor=1,
                                   attn_bf16_streams=bf16)
        init_weights(m, 3)
        with torch.no_grad():
            outs.append(m.eval()(x1, x2))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)

"""The port's "nk" attention layout against the JAX package on the CPU: the
plain version of kernel K2-nk (``ops/cpb.py cpb_bias_nk``, the exact CPB in
the query-major layout) against JAX's four grid entries of the TPU layout
kernels (v2 ``cpb_bias``, v1 ``cpb_bias_from_grids``, wide4
``cpb_bias_from_grids_w4``, v5 ``cpb_bias_grids_fused``, in interpret mode)
and the 1-D CPB against JAX's; ``DeformCrossAttention2D`` and
``DeformCrossAttention1D`` with ``attn_layout="nk"`` against JAX's modules
in "nk" and against the port's own "kn"; ``TeachersNet`` in "nk" against the
JAX ``TeachersNet`` as it runs on the CPU with no patch (JAX's "auto" is
"nk" there); and one "nk" teacher train step against JAX's.  The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: the CPB forward 1e-5 abs / 1e-4 rel and its gradients 2e-4 abs /
1e-3 rel (the JAX golden tests' own, ``tests/test_pallas_deform.py``);
modules: out 1e-5, attn 1e-6, parameter gradients 1e-5 of the leaf's
largest entry plus 5e-4 rel (the factored grid-sample backward contracts in
a layout-dependent order, the note of JAX's
``test_attn_layout_kn_matches_nk``; 1-D 1e-4 and 1e-3, as JAX's own 1-D
layout test); logits 1e-4; the train
step's loss 1e-5 relative, its gradients 1e-4 rel-L2, as
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jdam
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils import torch_export as te
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models import (
    deform_attention as tdam)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.ops import cpb
from disentangled_multimodal_learning_tpu_torch.train import losses as tlosses
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

FWD_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
NAMES = ("gkv", "w1", "b1", "w2", "b2", "w3", "b3")


def _inputs(rng, BH, N, K, o=1):
    """grid_q, grid_kv and the CPB weights, drawn as JAX's ``make_inputs``
    draws them (after its q, k and v)."""
    HID = cpb.HID
    for shape in ((BH, N, 16), (BH, K, 16), (BH, K, 16)):
        rng.normal(size=shape)
    gq = rng.uniform(-1, 1, size=(N, 2))
    gkv = rng.uniform(-1.2, 1.2, size=(BH, K, 2))
    w = [rng.normal(size=(2, HID)) * 0.5, rng.normal(size=(HID,)) * 0.1,
         rng.normal(size=(HID, HID)) * 0.2, rng.normal(size=(HID,)) * 0.1,
         rng.normal(size=(HID, o)) * 0.3, rng.normal(size=(o,)) * 0.1]
    return [a.astype(np.float32) for a in [gq, gkv] + w]


def _jax_entry(name):
    """JAX's grid entry ``name`` in interpret mode: grid_q, grid_kv and the
    weights -> ``[BH, N, K]``."""
    if name == "v2_flat":
        return lambda gq, *a: jda.cpb_bias(gq, *a, chunk_t=8, interpret=True)
    fn = {"v1_wide": jda.cpb_bias_from_grids,
          "wide4": jda.cpb_bias_from_grids_w4,
          "v5": jda.cpb_bias_grids_fused}[name]
    return lambda *a: fn(*a, interpret=True)


@pytest.mark.parametrize("entry", ["v2_flat", "v1_wide", "wide4", "v5"])
def test_cpb_nk_matches_each_jax_layout_kernel(monkeypatch, rng, entry):
    """The plain K2-nk against one of the four TPU layout kernels through
    its grid entry: forward, and the seven gradients of ``sum(sin(b) b)``
    (grid_kv and the weights), at the shapes of JAX's golden tests (ports
    of ``test_cpb_bias_flat_*`` :103 and :113, ``test_cpb_bias_wide_*``
    :134 and ``test_cpb_bias_wide4_*`` :167, with their 64-lane chunks;
    v5, which has no golden test, at N = 24 and K = 8, which
    ``_cpb5_qchunk`` takes as one 192-lane chunk)."""
    monkeypatch.setattr(jda, "_WIDE_CHUNK", 64)
    monkeypatch.setattr(jda, "_W4_CHUNK", 64)
    fn = _jax_entry(entry)
    if entry == "v2_flat":  # the flat forward test's shapes and chunk
        gq, gkv, *w = _inputs(np.random.default_rng(1), 3, 40, 12)
        want = jda.cpb_bias(*map(jnp.asarray, [gq, gkv] + w), chunk_t=16,
                            interpret=True)
        got = cpb.cpb_bias_nk(*map(torch.from_numpy, [gq, gkv] + w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if entry == "v5":
        assert jda._cpb5_qchunk(24, 8) == 24
    gq, gkv, *w = _inputs(rng, 2, 24, 8)
    jgq = jnp.asarray(gq)

    def jloss(*a):
        b = fn(jgq, *a)
        return jnp.sum(jnp.sin(b) * b), b

    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True)(
            *map(jnp.asarray, [gkv] + w))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [gkv] + w]
    got = cpb.cpb_bias_nk(torch.from_numpy(gq), *leaves)
    assert got.shape == (2, 24, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    (torch.sin(got) * got).sum().backward()
    for name, leaf, g in zip(NAMES, leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   err_msg=f"{entry} grad {name}", **GRAD_TOL)


@pytest.mark.parametrize("o", [1, 3])
def test_plain_nk_is_plain_kn_transposed(rng, o):
    """K2-nk's plain version is K2's transposed, exactly (the same points,
    each evaluated with the same arithmetic), and the backward wrappers on
    the CPU (the card's oracles) agree with autograd; neither counts."""
    gq, gkv, *w = map(torch.from_numpy, _inputs(rng, 3, 20, 7, o))
    nk = cpb.cpb_bias_nk(gq, gkv, *w)
    kn = cpb.cpb_bias_transposed(gq, gkv, *w)
    assert nk.shape == ((3, 20, 7) if o == 1 else (3, o, 20, 7))
    assert torch.equal(nk, kn.transpose(-1, -2))
    before = (cpb.cpb_bias_nk.launches, cpb.cpb_bias_nk_backward.launches)
    dbias = torch.from_numpy(rng.normal(size=nk.shape).astype(np.float32))
    leaves = [gkv.clone().requires_grad_()] + [
        t.clone().requires_grad_() for t in w]
    want = torch.autograd.grad(cpb.cpb_bias_nk(gq, *leaves), leaves, dbias)
    got = cpb.cpb_bias_nk_backward(gq, gkv, *w, dbias)
    kn_grads = cpb.cpb_bias_transposed_backward(gq, gkv, *w,
                                                dbias.transpose(-1, -2))
    for a, b, c in zip(got, want, kn_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, c)
    assert (cpb.cpb_bias_nk.launches,
            cpb.cpb_bias_nk_backward.launches) == before


def test_1d_cpb_in_nk_matches_jax(rng):
    """The 1-D CPB (one coordinate, two output channels per group) in "nk":
    the port pads the coordinate and runs K2-nk at O = 2, JAX runs its XLA
    MLP; the bias ``[B, H, N, K]`` with head ``g * 2 + o`` (JAX :317-321),
    forward and the gradients of ``sum(sin(b) b)``."""
    B, G, H, N, K = 2, 4, 8, 40, 10
    gq = np.linspace(-1, 1, N, dtype=np.float32)[:, None]
    gkv = rng.uniform(-1.2, 1.2, size=(B * G, K, 1)).astype(np.float32)
    jm = jdam.CPB(32, heads=H, offset_groups=G)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(gq),
                     jnp.asarray(gkv))["params"]
    r = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda v: v + r.normal(0, 0.1, v.shape).astype(np.float32), params)

    def jloss(p, g):
        b = jm.apply({"params": p}, jnp.asarray(gq), g)
        return jnp.sum(jnp.sin(b) * b), b

    (_, want), (jg, jgkv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(gkv))
    tm = tdam.CPB(32, H, G, coords=1)
    sd = {}
    te._cpb(params, "m", sd)
    tm.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}, strict=True)
    tgkv = torch.from_numpy(gkv).requires_grad_()
    got = tm(torch.from_numpy(gq), tgkv, side=N, table_divisor=1,
             kv_bound=1.2, layout="nk")
    assert got.shape == (B, H, N, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    (torch.sin(got) * got).sum().backward()
    np.testing.assert_allclose(tgkv.grad.numpy(), np.asarray(jgkv),
                               **GRAD_TOL)
    wg = {}
    te._cpb(jg, "m", wg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(wg[f"m.{name}"]),
                                   err_msg=name, **GRAD_TOL)


def test_attn_kv_axis_and_the_ports_auto_layout():
    """Port of JAX's ``test_attn_kv_axis_helper`` (:399), with the port's
    "auto": "kn" on every device (JAX's is "nk" off a TPU)."""
    assert tdam.attn_kv_axis("nk") == -1
    assert tdam.attn_kv_axis("kn") == -2
    assert tdam.attn_kv_axis("auto") == -2
    assert tdam.resolve_attn_layout("auto") == "kn"
    with pytest.raises(ValueError, match="attn_layout"):
        tdam.DeformCrossAttention2D(32, attn_layout="kv")
    with pytest.raises(ValueError, match="attn_layout"):
        tdam.DeformCrossAttention1D(32, attn_layout="nq")


def _load(module, export, params):
    out = {}
    export(params, "m", out)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                            for k, v in out.items()}, strict=True)
    return module


def _module_case(rng, dim, n, one_d):
    x1 = rng.normal(size=(2, n, dim)).astype(np.float32)
    x2 = rng.normal(size=(2, n, dim)).astype(np.float32)
    if one_d:
        jm = jdam.DeformCrossAttention1D(dim=dim, attn_layout="nk")
    else:
        jm = jdam.DeformCrossAttention2D(dim=dim, dropout=0.0, attn_layout="nk")
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x1),
                     jnp.asarray(x2), deterministic=True)["params"]
    # biases off 0, so that no relu input sits on a tie (JAX's maximum
    # splits a tie's gradient, torch's relu gives 0)
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    return x1, x2, jm, params


def _torch_module(one_d, dim, layout, params, divisor=0):
    if one_d:
        m = tdam.DeformCrossAttention1D(dim=dim, attn_layout=layout,
                                        cpb_table_divisor=divisor)
        return _load(m, te._attn1d, params)
    m = tdam.DeformCrossAttention2D(dim=dim, attn_layout=layout,
                                    cpb_table_divisor=divisor)
    return _load(m, te._attn2d, params)


def _loss(out):
    if isinstance(out, tuple):
        return (out[0] ** 2).sum() + (out[1] ** 2).sum()
    return (out ** 2).sum()


@pytest.mark.parametrize("one_d", [False, True], ids=["2d", "1d"])
def test_nk_modules_match_jax_in_nk(rng, one_d):
    """The port's attention in "nk" against JAX's with ``attn_layout="nk"``
    at the sizes of JAX's layout tests (dim 128; 2-D: an 8x8 grid, 1-D: 40
    tokens): out within 1e-5, the 2-D map ``[B, H, N, K]`` within 1e-6, and
    every parameter's gradient of ``sum(out^2) (+ sum(attn^2))`` within
    1e-5 of the leaf's largest entry plus 5e-4 relative (1-D: 1e-4 and 1e-3,
    the tolerance of JAX's own 1-D layout test, :506: its offset-conv bias
    sums cotangents of O(500) to 2e-5 of that in f32, the port's "kn" as
    its "nk"); the CPB output bias, whose gradient is 0 in exact
    arithmetic, only checked to be small on both sides.  The port runs at
    divisor 1, which "nk" ignores (JAX: ``use_table`` needs "kn")."""
    x1, x2, jm, params = _module_case(rng, 128, 40 if one_d else 64, one_d)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2),
                       deterministic=True)
        o = out if one_d else out[0]
        loss = jnp.sum(o ** 2) + (0.0 if one_d else jnp.sum(out[1] ** 2))
        return loss, out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = _torch_module(one_d, 128, "nk", params, divisor=1).eval()
    got = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    if one_d:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(want[0]), atol=1e-5, rtol=0)
        assert got[1].shape == (2, 8, 64, 4) and got[1].dtype == torch.float32
        np.testing.assert_allclose(got[1].detach().numpy(),
                                   np.asarray(want[1]), atol=1e-6, rtol=0)
    _loss(got).backward()
    wg = {}
    (te._attn1d if one_d else te._attn2d)(jgrads, "m", wg)
    atol, rtol = (1e-4, 1e-3) if one_d else (1e-5, 5e-4)
    for name, p in tm.named_parameters():
        want = np.asarray(wg[f"m.{name}"])
        if name == "rel_pos_bias.mlp.2.bias":
            floor = 1e-4 * np.abs(wg["m.rel_pos_bias.mlp.2.weight"]).max()
            assert np.abs(want).max() <= floor
            assert p.grad.abs().max().item() <= floor
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=rtol,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("one_d", [False, True], ids=["2d", "1d"])
def test_nk_modules_match_the_ports_kn(rng, one_d):
    """Ports of JAX's ``test_attn_layout_kn_matches_nk`` (:258) and
    ``test_attn1d_layout_kn_matches_nk`` (:506): the port's "kn" and "nk"
    from the same weights give the same out (1e-6 in 2-D, 1e-5 in 1-D), the
    transposed map (1e-6) and the same gradients (1e-5 abs / 5e-4 rel in
    2-D, 1e-4 / 1e-3 in 1-D; the CPB output bias left out as JAX does)."""
    x1, x2, _, params = _module_case(rng, 128, 40 if one_d else 64, one_d)
    mods = {lay: _torch_module(one_d, 128, lay, params).eval()
            for lay in ("nk", "kn")}
    outs = {lay: m(torch.from_numpy(x1), torch.from_numpy(x2))
            for lay, m in mods.items()}
    if one_d:
        torch.testing.assert_close(outs["nk"], outs["kn"], rtol=0, atol=1e-5)
        tol = dict(atol=1e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(outs["nk"][0], outs["kn"][0], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(outs["nk"][1],
                                   outs["kn"][1].transpose(-1, -2), rtol=0,
                                   atol=1e-6)
        tol = dict(atol=1e-5, rtol=5e-4)
    for lay in mods:
        _loss(outs[lay]).backward()
    for (name, a), b in zip(mods["nk"].named_parameters(),
                            mods["kn"].parameters()):
        if name == "rel_pos_bias.mlp.2.bias":
            continue  # softmax-invariant: the true gradient is 0
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   err_msg=name, **tol)


def test_gram_losses_read_either_layout(rng):
    """The teacher's and the student's consistency losses contract each map
    over both trailing axes, so the "nk" maps give the "kn" maps' losses."""
    maps = [torch.from_numpy(rng.dirichlet(np.ones(9), size=(3, 8, 16))
                             .astype(np.float32)) for _ in range(4)]
    kn = [m.transpose(-1, -2) for m in maps]
    torch.testing.assert_close(tlosses.omic_domain_scale_loss(*maps),
                               tlosses.omic_domain_scale_loss(*kn),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(tlosses.path_batch_loss(*maps[:2]),
                               tlosses.path_batch_loss(*kn[:2]),
                               rtol=1e-5, atol=1e-9)


FIXDIM, B = 64, 2


def _teacher_params(batch):
    jm = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                      input_size_omic_immune=361)
    x = {k: jnp.asarray(getattr(batch, k)) for k in
         ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")}
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), **x)["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    return jm, params, x


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_nk_teacher_matches_the_unpatched_jax_teacher(monkeypatch):
    """``TeachersNet`` built with ``define_net(cfg, attn_layout="nk")`` at
    the preset's divisor 1 against the JAX ``TeachersNet`` with nothing
    patched but the divisor its factory would set: on the CPU JAX's "auto"
    is "nk", which takes the exact CPB at every divisor, as the port's "nk"
    does.  fixdim 64, real widths; logits within 1e-4, the four maps
    ``[B, H, N, K]`` within 1e-5."""
    monkeypatch.setattr(jdam, "CPB_TABLE_DIVISOR", 1)
    assert jdam.resolve_attn_layout("auto") == "nk"
    ds = JSynthetic(size=B, fixdim=FIXDIM, label_dim=4, seed=0)
    jm, params, x = _teacher_params(ds.batch(list(range(B))))
    want = jax.jit(jm.apply)({"params": params}, **x)
    cfg = Config(fixdim=FIXDIM, batch_size=B, cpb_table_divisor=1).validate()
    model = load_jax_params(define_net(cfg, "cpu", attn_layout="nk"), params,
                            "teacher")
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in x.items()})
    for k in want[2]:
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(want[2][k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    for k in want[1]:
        assert got[1][k].shape == (B, 8, FIXDIM, 4)
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_nk_teacher_train_step_matches_jax(monkeypatch):
    """One teacher train step (AdamW, cosine, gradient modulation, the
    attention consistency loss on the "nk" maps) under
    ``deterministic_training``, the port in "nk" and JAX unpatched (its
    "nk" on the CPU), at the preset's divisor 1: the loss within 1e-5
    relative, every parameter's gradient after modulation within 1e-4
    rel-L2 (JAX's read off AdamW's first moment, ``mu = 0.1 g``; the CPB
    output biases, 0 in exact arithmetic, only checked to be small), and
    the second step's loss within 2e-4, the tolerances of
    ``tests/test_torch_train.py``."""
    monkeypatch.setattr(jdam, "CPB_TABLE_DIVISOR", 1)
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    jm, params, _ = _teacher_params(batches[0])
    jcfg = jconfig.Config(
        mode="teacher", task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=2, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, gradient_modulate=True,
        multiscale_attention=True, deterministic_training=True,
        checkpoints="#", cpb_table_divisor=1).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jm, jcfg, tx))
    jax_losses = []
    for k in range(2):
        state, m = jstep(state, batch_to_arrays(batches[k]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "teacher")
    cfg = Config(fixdim=FIXDIM, batch_size=B, cpb_table_divisor=1, epochs=2,
                 deterministic_training=True).validate()
    model = load_jax_params(define_net(cfg, "cpu", attn_layout="nk"), params,
                            "teacher")
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    for k in range(2):
        loss = float(step(batch_to_tensors(batches[k], "cpu"))["loss"])
        assert abs(loss - jax_losses[k]) <= (1e-5 if k == 0 else 2e-4) * max(
            1.0, abs(jax_losses[k])), (k, loss, jax_losses[k])
        if k:
            continue
        for name, p in model.named_parameters():
            want = np.asarray(jax_grads[name])
            if name.endswith("rel_pos_bias.mlp.2.bias"):
                w3 = model.get_parameter(name[:-4] + "weight").grad
                floor = 1e-5 * w3.abs().max().item()
                assert p.grad.abs().max().item() <= floor, name
                assert np.abs(want).max() <= floor, name
                continue
            assert _rel_l2(p.grad, want) <= 1e-4, name


def test_same_weights_load_into_nk_and_kn_models():
    """The layout moves no parameter: a reference-named state_dict of the
    "kn" teacher, student and deformpathomic loads into the "nk" model with
    ``strict=True``, and every 2-D and 1-D attention takes the layout."""
    for mode, extra in (("teacher", {}), ("student", {}),
                        ("deformpathomic", {"attn_dim": 1})):
        cfg = Config(mode=mode, fixdim=FIXDIM, batch_size=B,
                     **extra).validate()
        kn, nk = (define_net(cfg, "cpu", attn_layout=lay)
                  for lay in ("kn", "nk"))
        nk.load_state_dict(kn.state_dict(), strict=True)
        attns = [m for m in nk.modules()
                 if isinstance(m, (tdam.DeformCrossAttention2D,
                                   tdam.DeformCrossAttention1D))]
        assert attns and all(m.layout == "nk" for m in attns), mode
        assert all(m.layout == "kn" for m in kn.modules()
                   if isinstance(m, (tdam.DeformCrossAttention2D,
                                     tdam.DeformCrossAttention1D)))

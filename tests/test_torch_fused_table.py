"""The port's fused table attention (``ops/fused_table.py``, the plain
version of kernel K6, the ``fused_table_attention`` option) against the
JAX package on the CPU: the op against JAX's ``fused_table_attention``
(the v10 kernels in interpret mode) and ``_v10_ref``, forward and the
gradients upstream of the table; its dropout; ``DeformCrossAttention2D``
with ``fused_table_attention`` against JAX's module with ``fused_table=1``;
the whole ``TeachersNet`` and ``StudentsNet`` at fixdim 64; and one
teacher train step (gradients) against JAX's.  The kernels themselves are held against this plain
version on the card by ``tests/test_torch_cuda.py``.

JAX's fused path runs off the TPU only with ``V10_INTERPRET`` set; these
tests set it, and every other JAX module global, through ``monkeypatch``
or restore it in ``finally``.  Dropout: the port's mask is its own counter
hash (JAX's interpret-mode PRNG emits zero bits on the CPU), so the JAX
comparisons run at rate 0 and the dropout is tested on its own.

Tolerances (f32): out within 2e-5 and attn within 2e-6 abs (the products
and the softmax summed in another order); gradients within 2e-5 of the
largest (1e-4 for grid_kv, whose shift sums cancel, the ``_tbl_sum2d``
note); module outputs and maps 1e-5, parameter gradients 5e-4 abs / 2e-3
rel; logits 1e-4; the train step's loss 1e-5 relative, its gradients 1e-4
rel-L2, the second step's loss 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jdam
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    StudentsNet as JStudentsNet, TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils import torch_export as te
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention2D)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net, init_weights)
from disentangled_multimodal_learning_tpu_torch.ops import cluster as tcluster
from disentangled_multimodal_learning_tpu_torch.ops import cpb, fused_table
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

OUT_TOL, ATTN_TOL, GRAD_TOL, GKV_TOL = 2e-5, 2e-6, 2e-5, 1e-4
NAMES = ("q", "k", "v", "grid_kv", "w1", "b1", "w2", "b2", "w3", "b3")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(rng):
    h = cpb.HID
    w = [rng.normal(size=(2, h)) / np.sqrt(2), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, 1)) / np.sqrt(h), rng.normal(size=(1,)) * 0.1]
    return [a.astype(np.float32) for a in w]


def _case(rng, side, kv_bound, bh=2, k=16, d=8):
    """q, k, v as JAX's ``_v10_case`` draws them, grid_kv, the CPB weights,
    and cotangents of out and attn."""
    n = side * side
    f32 = np.float32
    return dict(q=(rng.normal(size=(bh, n, d)) * 0.3).astype(f32),
                k=(rng.normal(size=(bh, k, d)) * 0.3).astype(f32),
                v=rng.normal(size=(bh, k, d)).astype(f32),
                grid_kv=rng.uniform(-kv_bound, kv_bound,
                                    size=(bh, k, 2)).astype(f32),
                w=_mlp(rng), g_out=rng.normal(size=(bh, n, d)).astype(f32),
                g_attn=rng.normal(size=(bh, k, n)).astype(f32))


def _port(c, side, kv_bound, leaves, seed=0, rate=0.0):
    q, k, v, gkv, *w = leaves
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound)
    shifts = cpb.table_shifts(gkv, side=side, kv_bound=kv_bound)
    return fused_table.fused_table_attention(q, k, v, table, shifts, side,
                                             seed, rate)


@pytest.mark.parametrize("side,kv_bound", [(8, 0.5), (50, 2.5)])
def test_fused_table_attention_matches_jax(rng, side, kv_bound):
    """The plain K6 (from the CPB weights and grid_kv: the table build,
    shifts, windows, sim, softmax over K, PV) == JAX's
    ``cpb_bias_table_parts`` + ``fused_table_attention`` in interpret mode
    and + ``_v10_ref``, at rate 0: out, attn, and the gradients of
    ``sum(out g_out) + sum(attn g_attn)`` with respect to q, k, v, grid_kv
    and the CPB weights (upstream of the table, whose layouts differ); the
    CPB output bias, whose gradient is 0 in exact arithmetic, is checked
    for being below 1e-5 of its weight's on both sides.  At side 50 JAX
    takes its lane-split table layout."""
    c = _case(rng, side, kv_bound)
    args = [c["q"], c["k"], c["v"], c["grid_kv"]] + c["w"]

    def jloss(fused):
        def f(q, k, v, gkv, *w):
            tablep, shifts, rn, split = jda.cpb_bias_table_parts(
                gkv, *w, side=side, kv_bound=kv_bound)
            if fused:
                out, attn = jda.fused_table_attention(
                    q, k, v, tablep, shifts, jnp.zeros((), jnp.float32),
                    side, rn, split, 0.0, True)
            else:
                out, attn = jda._v10_ref(q, k, v, tablep, shifts, side, rn,
                                         split)
            return (jnp.sum(out * c["g_out"]) + jnp.sum(attn * c["g_attn"]),
                    (out, attn))
        return f

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, attn = _port(c, side, kv_bound, leaves)
    ((out * torch.from_numpy(c["g_out"])).sum()
     + (attn * torch.from_numpy(c["g_attn"])).sum()).backward()
    for fused in (True, False):
        (_, (jout, jattn)), grads = jax.value_and_grad(
            jloss(fused), argnums=tuple(range(10)), has_aux=True)(
                *map(jnp.asarray, args))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(attn.detach().numpy(), np.asarray(jattn),
                                   atol=ATTN_TOL, rtol=0)
        for name, leaf, g in zip(NAMES, leaves, grads):
            g = np.asarray(g)
            if name == "b3":
                # 0 in exact arithmetic (the softmax over K ignores a
                # shift): both sides only small against w3's gradient
                floor = 1e-5 * float(np.abs(np.asarray(grads[8])).max())
                assert np.abs(g).max() <= floor, fused
                assert leaf.grad.abs().max().item() <= floor, fused
                continue
            scale = float(np.abs(g).max()) + 1e-8
            err = float(np.abs(leaf.grad.numpy() - g).max()) / scale
            assert err <= (GKV_TOL if name == "grid_kv" else GRAD_TOL), (
                fused, name, err)


def test_dropout_mask_is_uint32_arithmetic():
    """``dropout_keep_mask``'s int64 ops masked to 32 bits are the kernels'
    uint32 hash (``csrc/fused_table.cuh``), also for element indices past
    2^32; the keep rate is 1 - rate."""
    def mix(x):
        x = x.astype(np.uint32)
        with np.errstate(over="ignore"):
            x ^= x >> np.uint32(16)
            x *= np.uint32(0x7FEB352D)
            x ^= x >> np.uint32(15)
            x *= np.uint32(0x846CA68B)
            x ^= x >> np.uint32(16)
        return x

    seed = 2 ** 31 - 7
    idx = np.concatenate([np.arange(3 * 5 * 400, dtype=np.uint64),
                          np.array([2 ** 32 + 5, 2 ** 40 + 17], np.uint64)])
    want = mix((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
               ^ mix((idx >> np.uint64(32)).astype(np.uint32)
                     ^ mix(np.array([seed], np.uint64))))
    t = torch.from_numpy(idx.astype(np.int64))
    got = fused_table._mix32((t & 0xFFFFFFFF) ^ fused_table._mix32(
        (t >> 32) ^ fused_table._mix32_int(seed)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for rate in (0.1, 0.25):
        keep = fused_table.dropout_keep_mask(seed, (3, 5, 400), rate)
        thr = fused_table.dropout_threshold(rate)
        np.testing.assert_array_equal(keep.numpy().ravel(),
                                      (want[:6000] >> np.uint32(8)) >= thr)
        assert abs(keep.float().mean().item() - (1 - rate)) < 0.02


def test_fused_dropout_is_deterministic_and_consistent(rng):
    """The same seed gives bit-identical output; ``attn`` is the map before
    dropout; about 1 - rate of the map is kept, the kept entries scaled by
    1 / (1 - rate); another seed drops others; and the backward regenerates
    the same mask: ``dv == drop(attn)^T g_out``, as JAX's
    ``test_v10_dropout_determinism_and_consistency`` checks."""
    side, kv_bound, rate = 8, 0.5, 0.25
    c = _case(rng, side, kv_bound, k=16, d=16)
    leaves = [torch.from_numpy(a) for a in
              [c["q"], c["k"], c["v"], c["grid_kv"]] + c["w"]]
    out_a, attn_a = _port(c, side, kv_bound, leaves, seed=7, rate=rate)
    out_b, _ = _port(c, side, kv_bound, leaves, seed=7, rate=rate)
    out_n, attn_n = _port(c, side, kv_bound, leaves, seed=7, rate=0.0)
    assert torch.equal(out_a, out_b) and torch.equal(attn_a, attn_n)
    out_c, _ = _port(c, side, kv_bound, leaves, seed=8, rate=rate)
    assert not torch.equal(out_a, out_c)
    # the dropped map, read off an identity v (D == K)
    eye = torch.eye(16).expand(2, 16, 16).contiguous()
    p_drop = _port(c, side, kv_bound, leaves[:2] + [eye] + leaves[3:], seed=7,
                   rate=rate)[0].transpose(1, 2)
    kept = p_drop != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.05
    torch.testing.assert_close(p_drop[kept], attn_a[kept] / (1 - rate),
                               rtol=1e-6, atol=1e-7)
    v = leaves[2].clone().requires_grad_()
    out, _ = _port(c, side, kv_bound, leaves[:2] + [v] + leaves[3:], seed=7,
                   rate=rate)
    g_out = torch.from_numpy(c["g_out"])
    out.backward(g_out)
    torch.testing.assert_close(v.grad, p_drop @ g_out, rtol=1e-5, atol=1e-5)


def test_backward_wrapper_on_the_cpu_is_the_plain_autograd(rng):
    """``fused_table_attention_backward`` on the CPU (its plain version,
    what K6-bwd is checked against on the card) == autograd through
    ``fused_table_attention``: the fraction cotangent is the shift
    cotangent.  Neither wrapper counts on the CPU."""
    side, kv_bound = 8, 0.5
    c = _case(rng, side, kv_bound)
    table = cpb.cpb_table(*map(torch.from_numpy, c["w"]), side=side,
                          kv_bound=kv_bound).detach()
    shifts = cpb.table_shifts(torch.from_numpy(c["grid_kv"]), side=side,
                              kv_bound=kv_bound)
    before = (fused_table.fused_table_attention.launches,
              fused_table.fused_table_attention_backward.launches)
    leaves = [torch.from_numpy(c[n]).requires_grad_() for n in ("q", "k", "v")]
    leaves += [table.clone().requires_grad_(), shifts.clone().requires_grad_()]
    out, attn = fused_table.fused_table_attention(*leaves, side, 3, 0.1)
    g_out, g_attn = torch.from_numpy(c["g_out"]), torch.from_numpy(c["g_attn"])
    want = torch.autograd.grad((out, attn), leaves, (g_out, g_attn))
    taps, fracs = cpb.table_taps(shifts, side=side, tn=table.shape[0])
    got = fused_table.fused_table_attention_backward(
        *(t.detach() for t in leaves[:4]), taps, fracs, attn.detach(), g_out,
        g_attn, side, 3, 0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert (fused_table.fused_table_attention.launches,
            fused_table.fused_table_attention_backward.launches) == before


def test_fused_wrappers_raise_off_cpu_instead_of_falling_back():
    meta = dict(device="meta")
    q, k = torch.empty(2, 64, 8, **meta), torch.empty(2, 4, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        fused_table.fused_table_attention(
            q, k, k, torch.empty(20, 20, **meta), torch.empty(8, 2, **meta), 8)


def _load(module, export, params):
    out = {}
    export(params, "m", out)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                            for k, v in out.items()}, strict=True)
    return module


def test_fused_deform_attention_matches_jax(rng):
    """``DeformCrossAttention2D(fused_table_attention=True)`` against JAX's
    module with ``fused_table=1`` (``V10_INTERPRET``), at the sizes of
    JAX's ``test_v10_through_attention_module`` (an 8x8 grid, 4 heads and
    groups, a 4x4 deformed grid): outputs and maps within 1e-5, every
    parameter's gradient of ``sum(out^2) + sum(sin(attn))`` within 5e-4
    abs / 2e-3 rel; the port's fused and unfused modules agree; train-mode
    dropout runs and moves the output."""
    B, N, C = 2, 64, 32
    x1 = rng.normal(size=(B, N, C)).astype(np.float32)
    x2 = rng.normal(size=(B, N, C)).astype(np.float32)
    kw = dict(dim=C, dim_head=8, heads=4, offset_groups=4,
              downsample_factor=2, offset_scale=2.0, offset_kernel_size=4)
    jm = jdam.DeformCrossAttention2D(**kw, dropout=0.0, attn_layout="kn",
                                     cpb_table_divisor=1, fused_table=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2),
                     deterministic=True)["params"]
    # biases off 0: a zero CPB bias puts the divisor-1 table's centre entry
    # on a relu tie, whose gradient JAX splits and torch does not
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    old = jdam.V10_INTERPRET
    try:
        jdam.V10_INTERPRET = pltpu.InterpretParams()

        def jloss(p):
            o, a = jm.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2),
                            deterministic=True)
            return jnp.sum(o ** 2) + jnp.sum(jnp.sin(a)), (o, a)

        (_, (want_out, want_attn)), jgrads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(params)
    finally:
        jdam.V10_INTERPRET = old
    tm = _load(DeformCrossAttention2D(**kw, dropout=0.3, cpb_table_divisor=1,
                                      fused_table_attention=True),
               te._attn2d, params).eval()
    out, attn = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               atol=1e-5, rtol=0)
    ((out ** 2).sum() + torch.sin(attn).sum()).backward()
    want = {}
    te._attn2d(jgrads, "m", want)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(want[f"m.{name}"]),
                                   atol=5e-4, rtol=2e-3, err_msg=name)
    unfused = DeformCrossAttention2D(**kw, dropout=0.3, cpb_table_divisor=1)
    unfused.load_state_dict(tm.state_dict())
    with torch.no_grad():
        u_out, u_attn = unfused.eval()(torch.from_numpy(x1),
                                       torch.from_numpy(x2))
        torch.testing.assert_close(u_out, out, rtol=0, atol=1e-5)
        torch.testing.assert_close(u_attn, attn, rtol=0, atol=1e-6)
        torch.manual_seed(0)
        d_out, d_attn = tm.train()(torch.from_numpy(x1), torch.from_numpy(x2))
    assert torch.isfinite(d_out).all() and not torch.equal(d_out, out)
    torch.testing.assert_close(d_attn, attn, rtol=0, atol=0)


FIXDIM, B = 64, 2


def _teacher_inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x_path10=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_path20=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_omic_tumor=r.normal(size=(B, 59)).astype(np.float32),
        x_omic_immune=r.normal(size=(B, 361)).astype(np.float32))


def _use_jax_fused(monkeypatch):
    monkeypatch.setattr(jdam, "CPB_TABLE_DIVISOR", 1)
    monkeypatch.setattr(jdam, "FUSED_TABLE_ATTENTION", True)
    monkeypatch.setattr(jdam, "V10_INTERPRET", pltpu.InterpretParams())
    monkeypatch.setattr(jdam, "resolve_attn_layout", lambda layout: "kn")


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_fused_models_match_jax(monkeypatch, mode):
    """The whole two-scale teacher (setting (a) of the card's main path) and
    student with the fused table attention, fixdim 64, real widths: logits
    within 1e-4 of JAX's (the student with JAX's DPC tie-break noise, as in
    ``test_torch_student.py``)."""
    _use_jax_fused(monkeypatch)
    x = _teacher_inputs()
    if mode == "student":
        x = {k: v for k, v in x.items() if k.startswith("x_path")}
        jm = JStudentsNet(label_dim=4)

        def noise(shape, device):
            return torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.PRNGKey(0), tuple(shape), jnp.float32))).to(device)

        monkeypatch.setattr(tcluster, "pinned_density_noise", noise)
    else:
        jm = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                          input_size_omic_immune=361)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    monkeypatch.setattr(jdam, "FUSED_TABLE_ATTENTION", False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), **jx)["params"]
    monkeypatch.setattr(jdam, "FUSED_TABLE_ATTENTION", True)
    want = jax.jit(jm.apply)({"params": params}, **jx)[2]
    cfg = Config(mode=mode, fixdim=FIXDIM, batch_size=B, cpb_table_divisor=1,
                 fused_table_attention=True).validate()
    model = load_jax_params(define_net(cfg, "cpu"), params, mode)
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in x.items()})[2]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_fused_teacher_train_step_matches_jax(monkeypatch):
    """The teacher's train step (AdamW, cosine schedule, gradient
    modulation, the attention consistency loss, which reads the fused map)
    under ``deterministic_training`` with the fused table attention, from
    the same weights (biases nudged off 0, see ``test_torch_train.py``):
    the first step's loss within 1e-5 relative and every parameter's
    gradient after modulation within 1e-4 rel-L2 of JAX's (read off
    AdamW's first moment, ``mu = 0.1 g``; the CPB output biases, 0 in exact
    arithmetic, only checked to be small), and the second step's loss
    within 2e-4.  One step and not a 10-step trajectory: JAX's v10 kernels
    run in interpret mode inside its jitted step, about 5 s a step on the
    CPU."""
    steps = 2
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    jm = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                      input_size_omic_immune=361)
    x = {k: jnp.asarray(getattr(batches[0], k)) for k in
         ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")}
    # the parameter tree does not depend on the attention path, so the
    # init runs the exact CPB, not the interpreted kernels
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), **x)["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    _use_jax_fused(monkeypatch)
    jcfg = jconfig.Config(
        mode="teacher", task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=steps, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, gradient_modulate=True,
        multiscale_attention=True, deterministic_training=True,
        checkpoints="#", cpb_table_divisor=1,
        fused_table_attention=True).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jm, jcfg, tx))
    jax_losses = []
    for k in range(steps):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "teacher")

    cfg = Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=1, fused_table_attention=True,
                 epochs=steps, deterministic_training=True).validate()
    model = load_jax_params(define_net(cfg, "cpu"), params, "teacher")
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    for k in range(steps):
        loss = float(step(batch_to_tensors(batches[k % 2], "cpu"))["loss"])
        assert abs(loss - jax_losses[k]) <= (1e-5 if k == 0 else 2e-4) * max(
            1.0, abs(jax_losses[k])), k
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


def test_config_threads_the_opt_in_flags_to_every_2d_attention():
    """``fused_table_attention`` and ``cpb_table_bf16`` reach every 2-D
    attention of each model (JAX sets module globals instead), from the
    command line too; the 1-D attention takes neither."""
    for mode, extra in (("teacher", {}), ("student", {}),
                        ("deformpathomic", {"attn_dim": 2})):
        cfg = Config(mode=mode, fixdim=FIXDIM, batch_size=B,
                     cpb_table_divisor=1, fused_table_attention=True,
                     cpb_table_bf16=True, **extra).validate()
        attns = [m for m in define_net(cfg, "cpu").modules()
                 if isinstance(m, DeformCrossAttention2D)]
        assert attns and all(m.fused_table_attention and m.cpb_table_bf16
                             for m in attns), mode
    cfg, _ = Config.from_args(["--fused_table_attention", "true",
                               "--cpb_table_bf16", "true",
                               "--cpb_table_divisor", "4"])
    assert cfg.fused_table_attention and cfg.cpb_table_bf16
    assert cfg.cpb_table_divisor == 4
    m = DeformCrossAttention2D(32, dim_head=8, heads=4, offset_groups=4,
                               cpb_table_divisor=1, cpb_table_bf16=True)
    init_weights(m, 1)
    x = torch.randn(1, 64, 32)
    with torch.no_grad():
        out, attn = m.eval()(x, x)
    assert out.dtype == attn.dtype == torch.float32

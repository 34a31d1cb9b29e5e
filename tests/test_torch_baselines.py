"""The port's baselines against the JAX package on the CPU: the Nystrom
core and its pseudo-inverse in float64, every baseline mode's f32 forward,
one ``deterministic_training`` train step (loss and gradients), the flax
BatchNorm statistics of BilinearFusion, the leaves ``init_type`` changes,
strict weight loads, and a fold through both entries.  The same
numpy-seeded inputs go to both sides; JAX's params reach the port through
``utils/jax_params.jax_state_dict`` (``strict=True``).  Small sizes: bags
of 16 or 25 patches at 1,024-d (ABMIL's width is fixed), 431 genes (MCAT's
and CMTA's four signatures), B = 2; one torch thread a test.

Tolerances: float64 Nystrom and pinv within 1e-10 (both sides compute the
same float64 products in other orders).  f32 forwards within ``FWD_TOL``
abs (1e-5; other summation orders) and 5e-5 for TransMIL and CMTA, whose
pinv amplifies f32 rounding (their outputs measured up to 3.7e-6 apart at
fixdim 25).  Train step: the loss within 1e-5 relative, every gradient
within ``GRAD_TOL`` rel-L2 (1e-4; the pinv's backward amplifies rounding
the same way), a gradient that is 0 on one side 0 on the other, and the
gradients that are 0 in exact arithmetic small (``ZERO_GRAD_FLOOR``).
BatchNorm's train-mode outputs within ``BN_TRAIN_TOL``, its running
statistics within 1e-5 (relative or abs; they average pre-norm
activations, encoder2's behind encoder1's BatchNorm, which agree to
~1e-6 abs; the unbiased variance would be 4/3 of them).
"""

import functools
import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.loader import BagLoader as JLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import cmta as jcmta
from disentangled_multimodal_learning_tpu.models import mcat as jmcat
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net, model_inputs as jmodel_inputs)
from disentangled_multimodal_learning_tpu.ops.nystrom import (
    nystrom_attention as jnystrom)
from disentangled_multimodal_learning_tpu.ops.pinv import (
    moore_penrose_pinv as jpinv)
from disentangled_multimodal_learning_tpu.train import grad_modulate as jgm
from disentangled_multimodal_learning_tpu.train.evaluation import (
    Evaluator as JEvaluator)
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.weight_init import (
    apply_init_type as japply_init_type)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models import cmta as tcmta
from disentangled_multimodal_learning_tpu_torch.models import mcat as tmcat
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    BASELINES, MODES, define_net, init_weights)
from disentangled_multimodal_learning_tpu_torch.ops.nystrom import (
    moore_penrose_pinv, nystrom_attention)
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    Evaluator, model_inputs)
from disentangled_multimodal_learning_tpu_torch.train.optim import (
    make_optimizer)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    jax_state_dict, load_jax_params)
from disentangled_multimodal_learning_tpu_torch.utils.weight_init import (
    apply_init_type)

FWD_TOL = 1e-5
NYSTROM_FWD_TOL = 5e-5
# train-mode BatchNorm normalises by the batch variance (B = 4), which flax
# computes as E[x^2] - E[x]^2 and torch in two passes: their f32
# difference, divided by a small standard deviation, reached 1.2e-5 at B 2
BN_TRAIN_TOL = 1e-4
GRAD_TOL = 1e-4
# the attention-pooling score biases shift every score of a softmax over
# the bag: their gradient is 0 in exact arithmetic, so both sides' f32
# residues are held below ZERO_GRAD_FLOOR of their weight's gradient (JAX's
# reached 1.0e-5 of it in MCAT's pooling over 4 tokens)
ZERO_GRAD_BIASES = ("attention_1.bias", "attention_c.bias")
ZERO_GRAD_FLOOR = 1e-4
FIXDIM, B = 25, 2
# (mode, config settings): every factory baseline, the pathomic fusions,
# and deformpathomic with BilinearFusion (exact CPB, "nk" on both sides)
CASES = [("path", {}), ("transmil", {}), ("omic", {}),
         ("pathomic", {}), ("pathomic", {"fusion_type": "add"}),
         ("pathomic", {"fusion_type": "pofusion", "skip": 1}),
         ("pathomic_original", {"fusion_type": "pofusion",
                                "use_bilinear": 0}),
         ("pathomic_fg", {}), ("pathomic_ensemble", {}), ("mcat", {}),
         ("cmta", {}), ("deformpathomic", {"fusion_type": "pofusion",
                                           "fixdim": 16})]
IDS = [m + "".join(f"-{v}" for v in kw.values()) for m, kw in CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(mode, kw, **extra):
    kw = {"fixdim": FIXDIM, "batch_size": B, **kw, **extra}
    return (jconfig.Config(mode=mode, **kw),
            Config(mode=mode, **kw).validate())


def _jax_model(jcfg, batch, seed=3):
    """The JAX model of ``jcfg`` and numpy-seeded variables for it
    (``_seeded_variables``)."""
    model = jdefine_net(jcfg)
    return model, _seeded_variables(
        model, jmodel_inputs(jcfg.mode, batch, train=False), seed)


def _seeded_variables(model, inputs, seed=3):
    """Numpy-seeded variables of the shapes of ``model.init`` on
    ``inputs`` (``jax.eval_shape``, so nothing compiles): kernels N(0,
    1/fan_in), scales 1 + N(0, 0.1), biases and running means N(0, 0.1),
    running variances U(0.5, 1.5)."""
    arrays, flags = _split(inputs)
    shapes = jax.eval_shape(
        functools.partial(model.init, deterministic=True, **flags),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        **arrays)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "scale":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=shape)
        elif len(shape) < 2:
            x = 0.1 * rng.normal(size=shape)
        else:
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _split(inputs: dict) -> tuple:
    """A model's kwargs as (arrays, Python flags): the flags (FG's and
    Ensemble's ``is_training``) stay static under ``jax.jit``."""
    flags = {k: v for k, v in inputs.items() if isinstance(v, bool)}
    return {k: v for k, v in inputs.items() if k not in flags}, flags


_CASE_CACHE: dict = {}


def _jax_case(mode, kw):
    """JAX's side of a case, computed once per case for the file (the tests
    of a case share its init): ``(configs, batch, model, variables, eval
    forward outputs, (loss, gradients) of one deterministic_training step)``
    at the case's task (survival for MCAT and CMTA, whose survival loss is
    their own)."""
    key = (mode, tuple(sorted(kw.items())))
    if key not in _CASE_CACHE:
        task = "survival" if mode in ("mcat", "cmta") else "diag2021"
        jcfg, cfg = _configs(mode, kw, task_type=task,
                             deterministic_training=True)
        batch = _batch(fixdim=cfg.fixdim)
        jm, variables = _jax_model(jcfg, batch)
        arrays, flags = _split(jmodel_inputs(mode, batch, False))
        fwd = jax.jit(functools.partial(jm.apply, deterministic=True,
                                        **flags))
        out = _leaves(jax.device_get(fwd(variables, **arrays)))
        step = None
        if mode != "deformpathomic":
            state = TrainState.create(variables, _grads_tx())
            state, metrics = jax.jit(jmake_train_step(jm, jcfg, _grads_tx()))(
                state, batch_to_arrays(batch), jax.random.PRNGKey(0))
            step = (float(metrics["loss"]), jax.device_get(state.opt_state))
        _CASE_CACHE[key] = ((jcfg, cfg), batch, jm, variables, out, step)
    return _CASE_CACHE[key]


def _port_model(cfg, variables):
    attn = {"attn_layout": "nk"} if cfg.mode == "deformpathomic" else {}
    model = define_net(cfg, "cpu", **attn)
    load_jax_params(model, variables["params"], cfg.mode, cfg.attn_dim,
                    variables.get("batch_stats"))
    return model


def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    if hasattr(out, "shape") and np.ndim(out) > 0:
        return [np.asarray(out)]
    return []


def _batch(seed=0, fixdim=FIXDIM, size=B):
    return JSynthetic(size=size, fixdim=fixdim, seed=seed).batch(
        list(range(size)))


@pytest.mark.parametrize("n", [32, 37])
def test_nystrom_and_pinv_match_jax_in_float64(n):
    """float64 on both sides (JAX under ``enable_x64``): the core at an N
    that is a multiple of the 8 landmarks and at one left-padded to it; the
    pinv's normaliser is the max over the whole batch, so a bag's pinv
    changes with a batch-mate's scale, as in JAX."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(2, 3, n, 8)) for _ in range(3))
    with jax.enable_x64(True):
        want = np.asarray(jnystrom(*(jnp.asarray(t) for t in (q * 8 ** -0.5,
                                                              k, v)), 8))
        x = rng.uniform(size=(2, 4, 6, 6))
        x[1] *= 5.0
        want_pinv = np.asarray(jpinv(jnp.asarray(x), 6))
        want_alone = np.asarray(jpinv(jnp.asarray(x[:1]), 6))
    got = nystrom_attention(*(torch.from_numpy(t) for t in (q * 8 ** -0.5,
                                                            k, v)), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    got_pinv = moore_penrose_pinv(torch.from_numpy(x), 6).numpy()
    np.testing.assert_allclose(got_pinv, want_pinv, rtol=0, atol=1e-10)
    alone = moore_penrose_pinv(torch.from_numpy(x[:1]), 6).numpy()
    np.testing.assert_allclose(alone, want_alone, rtol=0, atol=1e-10)
    assert np.abs(alone - got_pinv[:1]).max() > 1e-3  # the global max


@pytest.mark.parametrize("mode,kw", CASES, ids=IDS)
def test_forward_matches_jax(mode, kw):
    """Every output of the f32 eval-mode forward, JAX's params loaded
    strictly (a key short, the load raises)."""
    (_, cfg), batch, _, variables, want, _ = _jax_case(mode, kw)
    model = _port_model(cfg, variables)
    with torch.no_grad():
        got = _leaves(model(**model_inputs(batch, "cpu", mode)))
    assert len(got) == len(want)
    tol = NYSTROM_FWD_TOL if mode in ("transmil", "cmta") else FWD_TOL
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    sd = model.state_dict()
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("cls,jcls,fusion", [
    (tmcat.MCAT_Surv, jmcat.MCAT_Surv, "bilinear"),
    (tcmta.CMTA, jcmta.CMTA, "bilinear")])
def test_mcat_and_cmta_bilinear_fusion_match_jax(cls, jcls, fusion):
    """The modules' other ``fusion`` value (the factory builds concat):
    BilinearFusion at scale 8 in place of the two Linear layers."""
    batch = _batch()
    x = dict(x_path=jnp.asarray(batch.x_path10), x_omic=jnp.asarray(
        batch.x_omic))
    jm = jcls(label_dim=4, fusion=fusion)
    variables = _seeded_variables(jm, x, seed=5)
    want = _leaves(jax.jit(functools.partial(jm.apply, deterministic=True))(
        variables, **x))
    model = cls(4, fusion=fusion)
    init_weights(model, 0)
    mode = "mcat" if cls is tmcat.MCAT_Surv else "cmta"
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_state_dict(
        variables["params"], mode, batch_stats=variables["batch_stats"])
        .items()}, strict=True)
    with torch.no_grad():
        got = _leaves(model.eval()(torch.from_numpy(batch.x_path10),
                                   torch.from_numpy(batch.x_omic)))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=NYSTROM_FWD_TOL)


def _grads_tx():
    """An optax transformation that keeps the step's gradients as its state
    and leaves the params as they are."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.mark.parametrize("mode,kw", CASES[:-1], ids=IDS[:-1])
def test_train_step_matches_jax(mode, kw):
    """One ``deterministic_training`` step from the same weights on the same
    batch: the loss, and every parameter's gradient (JAX's read from an
    optax state that keeps them; the port's after ``backward``).  MCAT and
    CMTA train on the survival task (their NLL of hazards and S)."""
    (_, cfg), batch, _, variables, _, (jloss, jgrads) = _jax_case(mode, kw)
    model = _port_model(cfg, variables)
    metrics = make_train_step(model, cfg, make_optimizer(
        cfg, model.parameters()))(batch_to_tensors(batch, "cpu"))
    assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
    want = jax_state_dict(jgrads, mode, batch_stats=None)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) <= set(want)
    for name, g in grads.items():
        w = torch.from_numpy(np.asarray(want[name], np.float64))
        if name.endswith(ZERO_GRAD_BIASES):
            scale = grads[name[:-4] + "weight"].abs().max().item()
            assert max(g.abs().max().item(), w.abs().max().item()) <= (
                ZERO_GRAD_FLOOR * scale), name
            continue
        err = (g.double() - w).norm() / max(w.norm().item(), 1e-30)
        assert err <= GRAD_TOL, (name, err.item())


def test_bilinear_fusion_batchnorm_keeps_flax_statistics():
    """Three train-mode forwards of the pathomic model with BilinearFusion
    at dropout 0, B = 4: the outputs, and the encoders' running mean and
    (biased) variance against JAX's ``batch_stats`` (torch's own
    ``BatchNorm1d`` keeps the unbiased variance, 4/3 of the biased one at
    B = 4, which this check would catch)."""
    jcfg, cfg = _configs("pathomic", {"fusion_type": "pofusion"},
                         dropout_rate=0.0, batch_size=4)
    jm, variables = _jax_model(jcfg, _batch(size=4))
    apply = jax.jit(functools.partial(jm.apply, deterministic=False,
                                      mutable=["batch_stats"]))
    model = _port_model(cfg, variables).train()
    bs = variables["batch_stats"]
    for seed in range(3):
        batch = _batch(seed=10 + seed, size=4)
        jout, upd = apply({"params": variables["params"], "batch_stats": bs},
                          **jmodel_inputs("pathomic", batch, True))
        bs = jax.device_get(upd["batch_stats"])
        with torch.no_grad():
            out = model(**model_inputs(batch, "cpu", "pathomic"))
        np.testing.assert_allclose(out[3][2].numpy(), np.asarray(jout[3][2]),
                                   rtol=0, atol=BN_TRAIN_TOL)
    for enc in ("encoder1_bn", "encoder2_bn"):
        bn = getattr(model.fusion, enc)
        for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, mine).numpy(), bs["fusion"][enc][theirs],
                rtol=1e-5, atol=1e-5)
    assert set(model.state_dict()) >= {"fusion.encoder1_bn.running_var",
                                       "fusion.encoder2_bn.running_mean"}


def _changed(before: dict, after: dict) -> set:
    return {k for k in before
            if not np.array_equal(np.asarray(before[k]), np.asarray(after[k]))}


@pytest.mark.parametrize("mode,kw", [
    CASES[1], CASES[5], CASES[9], CASES[11],
    ("deformpathomic", {"attn_dim": 1, "fixdim": 16})])
def test_init_type_changes_the_leaves_jax_changes(mode, kw):
    """``apply_init_type`` at ``normal`` changes the state_dict entries whose
    JAX leaves JAX's changes (kernels and their biases, BatchNorm scales
    and biases), from the same seeded weights (nonzero biases), and no
    other: not the cls tokens, PPEG's filters, the Nystrom ``res_conv``,
    the bilinear weights, the CPB MLPs or the 1-D attention's offset conv.
    ``define_net`` applies it: its weights at ``normal`` differ from those
    at ``max`` in the same entries but the biases (0 from the seeded init
    already)."""
    if kw.get("attn_dim") == 1:
        jcfg, cfg = _configs(mode, kw)
        _, variables = _jax_model(jcfg, _batch(fixdim=cfg.fixdim))
    else:
        (_, cfg), _, _, variables, _, _ = _jax_case(mode, kw)
    new = jax.device_get(japply_init_type(variables, "normal", 0.02, 1))
    stats = variables.get("batch_stats")
    before = jax_state_dict(variables["params"], mode, cfg.attn_dim, stats)
    want = _changed(before, jax_state_dict(new["params"], mode, cfg.attn_dim,
                                           stats))
    model = _port_model(cfg, variables)
    apply_init_type(model, "normal", 0.02, 1)
    assert _changed(before, model.state_dict()) == want
    assert not any(k.endswith(("cls_token", "res_conv.weight", "bilinear_w1",
                               "mlp.0.0.weight", "pos_layer.proj.weight"))
                   for k in want)
    attn = {"attn_layout": "nk"} if mode == "deformpathomic" else {}
    base = define_net(cfg, "cpu", **attn).state_dict()
    got = _changed(base, define_net(cfg.replace(init_type="normal"), "cpu",
                                    **attn).state_dict())
    assert got == {k for k in want if not k.endswith("bias")}


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_init_type_draws_at_jax_scale(init_type):
    """On TransMIL's ``_fc1`` ([512, 1024]) and the pofusion BatchNorm: the
    std of each init type (gain 0.02), zeroed biases, orthogonal rows
    scaled by the gain, BatchNorm scales ~ N(1, gain)."""
    gain = 0.02
    w = define_net(Config(mode="transmil", init_type=init_type,
                          init_gain=gain), "cpu")._fc1
    std = {"normal": gain, "xavier": gain * (2 / (1024 + 512)) ** 0.5,
           "kaiming": (2 / 1024) ** 0.5, "orthogonal": gain / 1024 ** 0.5}
    assert w.weight.std().item() == pytest.approx(std[init_type], rel=0.03)
    assert torch.count_nonzero(w.bias) == 0
    if init_type == "orthogonal":
        gram = w.weight.detach().double() @ w.weight.detach().double().T
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(512),
                                   atol=1e-9)  # f32 entries: 2e-12 off
    bn = define_net(Config(mode="pathomic", fusion_type="pofusion",
                           mmhid=1024, path_scale=8, omic_scale=8,
                           init_type=init_type, init_gain=gain),
                    "cpu").fusion.encoder1_bn
    assert bn.weight.mean().item() == pytest.approx(1.0, abs=3 * gain / 32)
    assert bn.weight.std().item() == pytest.approx(gain, rel=0.1)
    assert torch.count_nonzero(bn.bias) == 0


@pytest.mark.parametrize("mode,task,kw", [
    ("pathomic", "diag2021", {"fusion_type": "pofusion"}),
    ("mcat", "survival", {}), ("transmil", "diag2021", {})])
def test_baseline_fold_through_both_entries(tmp_path, mode, task, kw):
    """One fold through ``main.main`` on the CPU writes a checkpoint, which
    ``inference.main`` restores (strictly, the BatchNorm statistics
    included) and serves: its outputs bitwise equal to the fold's final
    evaluation."""
    cfg = Config(mode=mode, task_type=task, fixdim=16, batch_size=B,
                 synthetic_data=True, debug=True, synthetic_train_size=4,
                 synthetic_test_size=3, kfold=1, epochs=1,
                 checkpoints=str(tmp_path), **kw).validate()
    final = tmain.main(cfg, device="cpu")[0]
    ckpt, = glob.glob(f"{tmp_path}/{mode}_fold_1_epoch_1_*.pt")
    metrics, logits = inference.main(cfg, checkpoint=ckpt, device="cpu")
    assert set(logits) == set(final["logits"])
    for k, v in logits.items():
        np.testing.assert_array_equal(v, final["logits"][k])
    assert set(metrics) == ({"cindex"} if task == "survival" else
                            {"acc", "f1", "auc", "bac", "sens", "spec",
                             "prec"})


def test_survival_refused_where_jax_simple_val_fails():
    """``path``, ``transmil`` and ``omic`` have no S for a survival risk:
    JAX's ``simple_val`` reads ``o[2]`` (None) and fails; the port's
    evaluator refuses with a reason instead of inventing a risk."""
    jcfg, cfg = _configs("path", {}, task_type="survival")
    jm, variables = _jax_model(jcfg, _batch())
    loader = JLoader(JSynthetic(size=2, fixdim=FIXDIM, seed=0), B)
    with pytest.raises((TypeError, ValueError)):
        JEvaluator(jm, jcfg).simple_val(TrainState.create(
            variables, _grads_tx()), loader)
    for mode in ("path", "transmil", "omic"):
        with pytest.raises(NotImplementedError, match="no survival output"):
            Evaluator(define_net(cfg.replace(mode=mode), "cpu"),
                      cfg.replace(mode=mode), "cpu", "simple")


def test_deformpathomic_bilinear_fusion_refuses_gradient_modulation():
    """With BilinearFusion the classifier reads ``mmhid`` fused features, not
    the tumor | immune halves the modulation splits its weight into: JAX
    fails on the shapes, the port's train step refuses with the reason."""
    f = jnp.ones((2, 128))
    with pytest.raises(TypeError):
        jgm.modulate_kernel_grad(jnp.ones((128, 4)), f, f, jnp.ones((128, 4)),
                                 jnp.zeros(4), jnp.zeros(2, jnp.int32))
    cfg = Config(mode="deformpathomic", fusion_type="pofusion", fixdim=16,
                 batch_size=B).validate()
    model = define_net(cfg, "cpu")
    with pytest.raises(ValueError, match="gradient_modulate"):
        make_train_step(model, cfg, make_optimizer(cfg, model.parameters()))


def test_every_factory_mode_builds_and_config_takes_the_baseline_keys():
    """``define_net`` builds all fourteen modes of the JAX factory (and
    distillation's pair); ``Config.from_dict`` takes the eight former LATER
    keys at any value and any ``fusion_type``, and TransMIL's token
    sharding (``seq_shard_devices``, a layout of the train step)."""
    assert len(MODES) == 15 and len(BASELINES) == 9
    cfg = Config.from_dict({"init_type": "xavier", "init_gain": 0.5,
                            "skip": 1, "use_bilinear": 0, "path_gate": 0,
                            "omic_gate": 0, "path_scale": 2, "omic_scale": 4,
                            "fusion_type": "whatever", "fixdim": 16})
    assert (cfg.init_type, cfg.skip, cfg.omic_scale) == ("xavier", 1, 4)
    model = define_net(cfg.replace(mode="pathomic"), "cpu")
    assert model.fusion.linear_h2.out_features == 128 // 4
    for mode in MODES:
        assert define_net(cfg.replace(mode=mode, init_type="max"), "cpu")
    assert Config.from_dict({"seq_shard_devices": 2}).seq_shard_devices == 2
    with pytest.raises(NotImplementedError, match="initialization method"):
        Config(init_type="uniform").validate()

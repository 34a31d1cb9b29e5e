"""The port's run logging, profiling hooks and gene importance against the
JAX package on the CPU (the port of JAX ``tests/test_aux.py``'s logger,
timer and importance tests):

- ``Logger``: the JSONL line of a payload equals JAX's (tensors and numpy
  scalars as floats), nothing under ``debug``, wandb falling back to the
  file, ``run_config``;
- both entries log by default: on the same tiny teacher run (2 train steps,
  an evaluation after each, then the serving entry) the port's JSONL lines
  carry JAX's keys at every level, every train metric among them, and
  every value is a finite float;
- ``StepTimer`` and ``trace`` on the CPU; ``current_learning_rate``;
- integrated gradients and expected-gradients SHAP: exact on a linear
  function, complete on an MLP, and equal to JAX's on the same function
  and, through the eval forward, on ``omic`` and ``pathomic`` models with
  JAX's weights; zero on deformpathomic (which reads no ``x_omic``) in
  both packages; refused where JAX fails;
- ablation and permutation importance equal to JAX's exactly on a seeded
  ``omic`` model whose logit margins the test checks; the two CSVs of
  ``export_gene_importance`` equal byte for byte.

Tolerances: IG and SHAP of the same function within 1e-5 rel-L2 (f32, the
same midpoints summed in the same order, other kernels' rounding); of a
model within ``IMP_TOL`` rel-L2 (1e-4: a forward and a backward per step in
f32 on each side); completeness as JAX's tests state it.  Small shapes:
fixdim 16, B 2 (the last batch padded), 24 genes; one torch thread a test.
"""

import dataclasses
import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jmain
from disentangled_multimodal_learning_tpu.config import Config as JConfig
from disentangled_multimodal_learning_tpu.data.loader import BagLoader as JLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net, model_inputs as jmodel_inputs)
from disentangled_multimodal_learning_tpu.train.trainers import (
    run_training as jrun_training)
from disentangled_multimodal_learning_tpu.utils import importance as jimp
from disentangled_multimodal_learning_tpu.utils.logging import (
    Logger as JLogger)
from disentangled_multimodal_learning_tpu_torch import compat
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    model_type_of)
from disentangled_multimodal_learning_tpu_torch.train.optim import (
    ReduceLROnPlateau, current_learning_rate, make_optimizer, make_scheduler,
    set_learning_rate)
from disentangled_multimodal_learning_tpu_torch.train.trainers import (
    run_training)
from disentangled_multimodal_learning_tpu_torch.utils import importance
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)
from disentangled_multimodal_learning_tpu_torch.utils.logging import Logger
from disentangled_multimodal_learning_tpu_torch.utils.profiling import (
    StepTimer, trace)

FN_TOL, IMP_TOL = 1e-5, 1e-4
FIXDIM, B, GENES = 16, 2, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _lines(log_dir) -> list[dict]:
    """The JSONL lines of the run files in ``log_dir`` (one a ``Logger``,
    named by the second it was made in: loggers made in the same second
    append to one file), in order, without their time "t"."""
    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for path in sorted(log_dir.glob("run_*.jsonl"))
            for line in path.read_text().splitlines()]


def _keys(payload):
    """The nested key structure of a payload."""
    if isinstance(payload, dict):
        return {k: _keys(v) for k, v in payload.items()}
    return None


def _floats(payload):
    if isinstance(payload, dict):
        return [x for v in payload.values() for x in _floats(v)]
    return [payload]


# ------------------------------------------------------------------- logging

def test_logger_writes_jax_lines_and_nothing_under_debug(tmp_path):
    """The same payload through both loggers gives the same JSON line but
    for its time (a 0-d tensor and numpy scalars become floats); ``debug``
    writes nothing and makes no directory; ``wandb`` without the package
    falls back to the file; ``run_config`` is the whole config."""
    cfg = Config(log_dir=str(tmp_path / "port")).validate()
    jcfg = JConfig(log_dir=str(tmp_path / "jax"))
    logger, jlogger = Logger(cfg), JLogger(jcfg)
    for lg, scalar in ((logger, torch.tensor(1.5)),
                       (jlogger, jnp.asarray(1.5))):
        lg.log({"training": {"loss": scalar, "n": np.int64(3)},
                "test": {"auc": np.float32(0.25), "acc": {"acc_teas": 0.5}}})
        lg.close()
    assert _lines(tmp_path / "port") == _lines(tmp_path / "jax") == [
        {"training": {"loss": 1.5, "n": 3.0},
         "test": {"auc": 0.25, "acc": {"acc_teas": 0.5}}}]
    quiet = Logger(cfg.replace(debug=True, log_dir=str(tmp_path / "quiet")))
    quiet.log({"a": 1.0})
    quiet.close()
    assert quiet.path is None and not (tmp_path / "quiet").exists()
    wb = Logger(cfg.replace(wandb=True, log_dir=str(tmp_path / "wandb")))
    wb.log({"a": 1.0})
    wb.close()
    assert _lines(tmp_path / "wandb") == [{"a": 1.0}]
    rc = quiet.run_config()
    assert rc == dataclasses.asdict(cfg.replace(debug=True, log_dir=str(
        tmp_path / "quiet")))
    assert rc["mode"] == "teacher" and rc["batch_size"] == 4


def test_config_takes_the_logging_fields_and_the_debug_switch():
    """``debug``, ``log_dir`` and ``wandb`` are fields with JAX's defaults;
    ``--debug`` is a switch (JAX ``config.py:54-59``)."""
    for name in ("debug", "log_dir", "wandb"):
        assert getattr(Config(), name) == getattr(JConfig(), name)
    assert Config.from_args(["--debug"])[0].debug is True
    assert Config.from_args([])[0].debug is False
    cfg = Config.from_args(["--log_dir", "/x", "--wandb", "true"])[0]
    assert (cfg.log_dir, cfg.wandb) == ("/x", True)


def test_entries_log_jax_payloads_by_default(tmp_path):
    """The training entry (1 fold, 2 steps, an evaluation after each) and
    the serving entry of the teacher, each building its ``Logger`` from the
    config, against JAX's root ``main.py`` on the same config: the
    evaluations' lines with JAX's keys at every level (every train metric,
    the per-tag metric dicts), the serving line ``{"inference": ...}``
    with JAX's headline metric names (``inference.py:152-153``: the flat
    floats, whose names JAX's per-tag dicts take over in the training
    payload), all finite floats; under ``debug`` the entries write
    nothing."""
    kw = dict(mode="teacher", fixdim=FIXDIM, batch_size=B,
              synthetic_data=True, synthetic_train_size=4,
              synthetic_test_size=2, kfold=1, epochs=1, eval_every_iters=1,
              checkpoints="#", seed=0)
    cfg = Config(log_dir=str(tmp_path / "port"), **kw).validate()
    jcfg = JConfig(log_dir=str(tmp_path / "jax"), **kw).validate()
    tmain.main(cfg, device="cpu")
    inference.main(cfg, device="cpu")
    jmain.main(0, jcfg)
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == 3 and len(want) == 2
    assert [_keys(p) for p in got[:2]] == [_keys(p) for p in want]
    assert _keys(got[2]) == {"inference": dict.fromkeys(want[0]["test"])}
    assert set(got[0]["training"]) == {"loss", "taskloss", "batchloss"}
    assert set(got[0]["test"]["auc"]) == {"auc_tea10", "auc_tea20",
                                          "auc_teas"}
    assert set(got[2]) == {"inference"}
    assert all(isinstance(x, float) and math.isfinite(x)
               for p in got for x in _floats(p))
    quiet = cfg.replace(debug=True, log_dir=str(tmp_path / "quiet"))
    tmain.main(quiet, device="cpu")
    inference.main(quiet, device="cpu")
    assert not (tmp_path / "quiet").exists()


@pytest.mark.parametrize("mode,task", [("pathomic", "survival"),
                                       ("omic", "grade")])
def test_eval_payload_keys_match_jax(mode, task):
    """The cadence evaluation's payload of a one-tag model (fused on
    survival: the c-index alone; simple on grade: seven flat metrics),
    through ``run_training`` with a logger, against JAX's."""
    kw = dict(mode=mode, task_type=task, fixdim=FIXDIM, batch_size=B,
              epochs=1, eval_every_iters=1, checkpoints="#", debug=True,
              seed=0)
    cfg, jcfg = Config(**kw).validate(), JConfig(**kw).validate()
    ds = dict(fixdim=FIXDIM, label_dim=cfg.label_dim)
    logs = {}
    for side, loader_cls, make, run, c, net in (
            ("port", BagLoader, SyntheticBagDataset, run_training, cfg,
             lambda: define_net(cfg, "cpu")),
            ("jax", JLoader, JSynthetic, jrun_training, jcfg,
             lambda: jdefine_net(jcfg))):
        loaders = (loader_cls(make(size=2, seed=1, **ds), B, seed=0),
                   loader_cls(make(size=2, seed=2, **ds), B, shuffle=False,
                              drop_last=False))
        logged = []
        run(c, net(), loaders, logger=types.SimpleNamespace(
            log=logged.append), model_type=model_type_of(mode))
        logs[side] = logged
    assert len(logs["port"]) == len(logs["jax"]) == 1
    assert _keys(logs["port"][0]) == _keys(logs["jax"][0])
    assert all(math.isfinite(x) for x in _floats(logs["port"][0]))


# ----------------------------------------------------------------- profiling

def test_step_timer_on_the_cpu():
    """JAX's ``test_step_timer_fence`` on the port: a fence on CPU tensors
    waits for nothing; ``roundtrip`` stays 0.0 until ``calibrate``."""
    t = StepTimer()
    tree = {"a": torch.ones(4, 4), "b": [torch.zeros(2)]}
    assert t.roundtrip == 0.0
    t.calibrate(tree)
    assert 0.0 <= t.roundtrip < 0.01
    t.start()
    for _ in range(3):
        tree["a"] = tree["a"] @ tree["a"]
        t.count()
    assert t.stop(tree) > -0.01
    t.start()
    assert t.stop(tree) >= -0.01  # no step counted: the window over 1


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(8, 8)
    with trace(str(tmp_path / "trace")) as path:
        assert path.startswith(str(tmp_path / "trace"))
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 3


def test_current_learning_rate_follows_the_schedule_and_plateau():
    """``current_learning_rate`` reads the lr the next step takes: the
    cosine schedule's value after each ``LambdaLR`` step, and under
    ``plateau`` the lr ``set_learning_rate`` wrote (JAX
    ``test_plateau_optimizer_injects_mutable_lr``)."""
    cfg = Config(lr=0.1, lr_policy="cosine", epochs=2).validate()
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer(cfg, [p])
    sched = make_scheduler(cfg, opt, 4)
    assert current_learning_rate(opt) == pytest.approx(0.1)
    for _ in range(4):
        opt.step()
        sched.step()
    assert current_learning_rate(opt) == pytest.approx(0.05)
    plateau = ReduceLROnPlateau(factor=0.5, patience=0)
    cfg = cfg.replace(lr_policy="plateau")
    opt = make_optimizer(cfg, [p])
    make_scheduler(cfg, opt, 1, plateau)
    assert current_learning_rate(opt) == pytest.approx(0.1)
    plateau.step(1.0)
    set_learning_rate(opt, cfg.lr * plateau.step(1.0))
    assert current_learning_rate(opt) == pytest.approx(0.05)


# ---------------------------------------------------- IG and SHAP, functions

def _mlp(rng):
    w1 = rng.normal(size=(8, 16)).astype(np.float32)
    w2 = rng.normal(size=(16,)).astype(np.float32)
    return (lambda x: torch.tanh(x @ torch.from_numpy(w1))
            @ torch.from_numpy(w2),
            lambda x: jnp.tanh(x @ jnp.asarray(w1)) @ jnp.asarray(w2))


def test_integrated_gradients_linear_exact_and_mlp_complete():
    """JAX's two IG tests on the port: ``x * w`` exactly on a linear
    function; on an MLP the rows sum to f(x) - f(0) at 256 steps; and the
    port's attributions equal JAX's on the same MLP at 32 steps."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=8).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    ig = importance.integrated_gradients(lambda xo: xo @ torch.from_numpy(w),
                                         x, steps=8)
    np.testing.assert_allclose(ig, x * w, rtol=1e-5, atol=1e-6)
    f, jf = _mlp(np.random.default_rng(1))
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    ig = importance.integrated_gradients(f, x, steps=256)
    np.testing.assert_allclose(ig.sum(axis=1), f(torch.from_numpy(x)).numpy(),
                               rtol=1e-3, atol=1e-3)
    base = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    got = importance.integrated_gradients(f, x, baseline=base, steps=32)
    want = jimp.integrated_gradients(jf, x, baseline=base, steps=32)
    assert _rel_l2(got, want) <= FN_TOL


def test_expected_gradients_shap_draws_jax_baselines():
    """JAX's two SHAP tests on the port (exact on a linear function,
    complete over the drawn baselines on an MLP), and on the MLP with 3 of
    6 background rows drawn, the port's attributions equal JAX's: the same
    ``default_rng(seed).choice`` rows."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=8).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    bg = rng.normal(size=(6, 8)).astype(np.float32)
    phi = importance.expected_gradients_shap(
        lambda xo: xo @ torch.from_numpy(w), x, bg, n_baselines=6, steps=8)
    np.testing.assert_allclose(phi, (x - bg.mean(axis=0)) * w, rtol=1e-4,
                               atol=1e-5)
    f, jf = _mlp(np.random.default_rng(1))
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    bg = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    phi = importance.expected_gradients_shap(f, x, bg, n_baselines=5,
                                             steps=256)
    expect = f(torch.from_numpy(x)).numpy()[:, None] - f(
        torch.from_numpy(bg)).numpy().mean()
    np.testing.assert_allclose(phi.sum(axis=1, keepdims=True), expect,
                               rtol=1e-2, atol=2e-3)
    bg6 = np.random.default_rng(4).normal(size=(6, 8)).astype(np.float32)
    for seed in (0, 7):
        got = importance.expected_gradients_shap(f, x, bg6, n_baselines=3,
                                                 steps=16, seed=seed)
        want = jimp.expected_gradients_shap(jf, x, bg6, n_baselines=3,
                                            steps=16, seed=seed)
        assert _rel_l2(got, want) <= FN_TOL, seed


# ------------------------------------------------- importance through models

def _batches(size=3, seed=2):
    """``size`` synthetic bags of ``GENES`` genes in batches of B, the last
    one padded (the tumor and immune omics are the genes' first 59 and 361
    columns in JAX's synthetic data: here all 24 of them)."""
    ds = JSynthetic(size=size, fixdim=FIXDIM, omic_dim=GENES, seed=seed)
    return list(JLoader(ds, B, shuffle=False, drop_last=False))


@functools.lru_cache(maxsize=None)
def _models(mode):
    """JAX's model of ``mode`` at ``GENES`` genes with numpy-seeded params
    (kernels N(0, 1/fan_in), 1-D leaves N(0, 0.1)) in a state holder, and
    the port's with them loaded strictly."""
    batch = _batches()[0]
    kw = dict(mode=mode, fixdim=FIXDIM, batch_size=B, input_size_omic=GENES,
              input_size_omic_tumor=batch.x_omic_tumor.shape[1],
              input_size_omic_immune=batch.x_omic_immune.shape[1], debug=True)
    jcfg, cfg = JConfig(**kw), Config(**kw).validate()
    jm = jdefine_net(jcfg)
    inputs = jmodel_inputs(mode, batch, False)
    shapes = jax.eval_shape(functools.partial(jm.init, deterministic=True),
                            jax.random.PRNGKey(0), **inputs)
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape) if len(s.shape) < 2 else
                   rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1])))
        .astype(np.float32), shapes)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables.get("batch_stats"))
    attn = {"attn_layout": "nk"} if mode == "deformpathomic" else {}
    model = load_jax_params(define_net(cfg, "cpu", **attn),
                            variables["params"], mode)
    return (jcfg, jm, state), (cfg, model)


@pytest.mark.parametrize("mode", ["omic", "pathomic"])
@pytest.mark.parametrize("method", ["ig", "shap"])
def test_importance_matches_jax_through_the_eval_forward(mode, method):
    """Mean |IG| (8 steps) and mean |SHAP| (2 baselines of the 3 bags, 4
    steps) of the true-class logit per gene over 3 bags (the padded row
    dropped): the port's eval forward with JAX's weights against JAX's;
    ``compat.shap_feature_importance`` is the SHAP one."""
    (jcfg, jm, state), (cfg, model) = _models(mode)
    batches = _batches()
    if method == "ig":
        got = importance.integrated_gradients_importance(model, cfg, batches,
                                                         steps=8)
        want = jimp.integrated_gradients_importance(jm, state, jcfg, batches,
                                                    steps=8)
    else:
        got = compat.shap_feature_importance(model, cfg, batches,
                                             n_baselines=2, steps=4, seed=1)
        want = jimp.deep_shap_importance(jm, state, jcfg, batches,
                                         n_baselines=2, steps=4, seed=1)
    assert got.shape == want.shape == (GENES,)
    assert np.isfinite(got).all() and (got >= 0).all() and got.max() > 0
    assert _rel_l2(got, want) <= IMP_TOL


def test_deformpathomic_attributions_are_zero_in_both():
    """deformpathomic reads the tumor and immune omics, never ``x_omic``:
    its IG is exactly zero in JAX, and in the port."""
    (jcfg, jm, state), (cfg, model) = _models("deformpathomic")
    batches = _batches(size=2)
    want = jimp.integrated_gradients_importance(jm, state, jcfg, batches,
                                                steps=1)
    got = importance.integrated_gradients_importance(model, cfg, batches,
                                                     steps=2)
    assert not want.any() and not got.any() and got.shape == (GENES,)


@pytest.mark.parametrize("mode", ["teacher", "student", "multiscale"])
def test_importance_refused_where_jax_fails(mode):
    """The teachers' and students' eval outputs are tuples of dicts: JAX's
    ``out[3][2]`` raises KeyError (traced for the teacher here); the port
    refuses with the reason, for IG, SHAP and the score."""
    if mode == "teacher":
        jcfg = JConfig(mode="teacher", fixdim=FIXDIM, batch_size=B)
        jm = jdefine_net(jcfg)
        batch = _batches(size=2)[0]
        shapes = jax.eval_shape(functools.partial(jm.init,
                                                  deterministic=True),
                                jax.random.PRNGKey(0),
                                **jmodel_inputs("teacher", batch, False))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
        with pytest.raises(KeyError):
            jimp.integrated_gradients_importance(
                jm, types.SimpleNamespace(params=zeros["params"],
                                          batch_stats=None), jcfg, [batch],
                steps=1)
    cfg = Config(mode=mode, fixdim=FIXDIM, batch_size=B).validate()
    model = define_net(cfg, "cpu")
    batches = _batches(size=2)
    for call in (lambda: importance.integrated_gradients_importance(
                     model, cfg, batches, steps=1),
                 lambda: importance.deep_shap_importance(model, cfg, batches),
                 lambda: importance.make_omic_score_fn(model, cfg, batches)):
        with pytest.raises(NotImplementedError, match="KeyError"):
            call()


def test_ablation_and_permutation_equal_jax_exactly(tmp_path):
    """On an ``omic`` model with JAX's weights, 8 bags: the accuracy drop
    per gene with its column zeroed, and per gene over 2 shuffles of its
    column (``default_rng(0)``, JAX's draws), equal JAX's exactly.  Every
    input scored has a top-2 logit margin above 100 times the two
    packages' largest logit gap on the bags (measured here, ~1e-7), so no
    argmax can flip; then the scores go through ``export_gene_importance``,
    whose CSVs equal JAX's bytes."""
    (jcfg, jm, state), (cfg, model) = _models("omic")
    batches = _batches(size=8, seed=5)
    score = importance.make_omic_score_fn(model, cfg, batches)
    jscore = jimp.make_omic_score_fn(jm, state, jcfg, batches)
    margins = []

    def checked(x):
        with torch.no_grad():
            top2 = model(x_omic=torch.from_numpy(x))[1].topk(2, dim=1)[0]
        margins.append((top2[:, 0] - top2[:, 1]).min().item())
        return score(x)

    x = np.concatenate([b.x_omic for b in batches])
    abl = importance.ablation_feature_importance(checked, x)
    perm = importance.permutation_feature_importance(checked, x, n_trials=2)
    with torch.no_grad():
        mine = model(x_omic=torch.from_numpy(x))[1].numpy()
    gap = np.abs(mine - np.asarray(jm.apply(
        {"params": state.params}, x_omic=jnp.asarray(x))[1])).max()
    assert gap < 1e-5 and min(margins) > 100 * gap
    assert len(margins) == 1 + GENES + 1 + 2 * GENES
    np.testing.assert_array_equal(
        abl, jimp.ablation_feature_importance(jscore, x))
    np.testing.assert_array_equal(
        perm, jimp.permutation_feature_importance(jscore, x, n_trials=2))
    assert abl.any() and perm.any()
    genes = [f"gene{i}" for i in range(GENES)]
    for imp in (abl, perm, np.linspace(0.5, -0.5, GENES)):
        mine = importance.export_gene_importance(imp, genes,
                                                 str(tmp_path / "mine"), 3)
        theirs = jimp.export_gene_importance(imp, genes,
                                             str(tmp_path / "theirs"), 3)
        for k in ("scores", "genes"):
            with open(mine[k], "rb") as a, open(theirs[k], "rb") as b:
                assert a.read() == b.read(), k

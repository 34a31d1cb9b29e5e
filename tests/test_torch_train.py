"""The port's teacher training path against the JAX package on the CPU: the
losses, the gradient modulation, every optimizer under every lr policy, the
train-mode dropouts, the loader's training order, the training entry, and
20-step loss and parameter trajectories of ``make_train_step`` against the
JAX train step, from the same weights (``load_jax_params``) on the same
batches, under ``deterministic_training``, at divisor 0 and at divisor 1
(each against JAX at the same divisor).  fixdim 64 (an 8x8 grid, K = 4
deformed kv points), B = 2, the real widths.

Tolerances: 1e-6 relative on the losses and the modulated gradients (f32,
other summation orders; 1e-4 on the consistency loss, a scaled variance of
near-equal values); 2e-6 relative on optimizer trajectories (the update
formulas round differently); the trajectory tolerances are in
``test_train_step_trajectory_matches_jax``.
"""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

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
from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train import grad_modulate as jgm
from disentangled_multimodal_learning_tpu.train import losses as jlosses
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention2D)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net, init_weights)
from disentangled_multimodal_learning_tpu_torch.train import grad_modulate as tgm
from disentangled_multimodal_learning_tpu_torch.train import losses as tlosses
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step, task_class_weights)
from disentangled_multimodal_learning_tpu_torch.train.trainers import (
    run_training)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

REPO = Path(__file__).resolve().parents[1]
FIXDIM, B, STEPS = 64, 2, 20
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: under the suite's parallel
    workers a pool of one thread per core oversubscribes the CPU, and these
    small models' steps then wait at every op's barrier (as in
    ``tests/test_torch_data.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------- losses

def _labels(r, n=6):
    lab = np.zeros((n, 12), np.int32)
    lab[:, 4] = r.integers(0, 3, n)
    lab[:, 5] = r.integers(0, 4, n)
    lab[:, 7] = r.integers(0, 3, n)
    lab[:, 8] = r.integers(0, 4, n)
    lab[:, 9] = r.integers(0, 2, n)
    return lab


@pytest.mark.parametrize("task", ["diag2021", "grade", "subtype", "survival"])
def test_task_loss_matches_jax(rng, task):
    n = 6
    c = 4 if task in ("diag2021", "survival") else 3
    logits = rng.normal(size=(n, c)).astype(np.float32)
    hazards = 1 / (1 + np.exp(-logits))
    S = np.cumprod(1 - hazards, axis=1).astype(np.float32)
    label = _labels(rng, n)
    cw = jconfig.TASK_CLASS_WEIGHTS.get(task)
    want = jlosses.task_loss(task, logits=jnp.asarray(logits),
                             hazards=jnp.asarray(hazards), S=jnp.asarray(S),
                             label=jnp.asarray(label), class_weights=cw)
    got = tlosses.task_loss(task, logits=_t(logits), hazards=_t(hazards),
                            S=_t(S), label=_t(label).long(), class_weights=cw)
    _close(got, want)


@pytest.mark.parametrize("alpha,given_S", [(0.0, True), (0.4, False)])
def test_nll_surv_loss_and_unweighted_ce_match_jax(rng, alpha, given_S):
    hazards = rng.uniform(0.01, 0.99, size=(5, 4)).astype(np.float32)
    S = np.cumprod(1 - hazards, axis=1) if given_S else None
    Y, c = rng.integers(0, 4, 5), rng.integers(0, 2, 5)
    want = jlosses.nll_surv_loss(jnp.asarray(hazards), None if S is None
                                 else jnp.asarray(S), jnp.asarray(Y),
                                 jnp.asarray(c), alpha=alpha)
    got = tlosses.nll_surv_loss(_t(hazards), None if S is None else _t(S),
                                _t(Y), _t(c), alpha=alpha)
    _close(got, want)
    logits = rng.normal(size=(5, 4)).astype(np.float32)
    _close(tlosses.weighted_cross_entropy(_t(logits), _t(Y)),
           jlosses.weighted_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(Y)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_omic_domain_scale_loss_matches_jax(rng, dtype):
    """The teacher's consistency loss on ``[B, H, K, N]`` maps; bf16 maps
    (the card's streams) are upcast before the f32 cross-Gram, as JAX
    contracts them with ``preferred_element_type=f32``."""
    maps = [torch.from_numpy(rng.dirichlet(np.ones(9), size=(3, 8, 16))
                             .transpose(0, 1, 3, 2).astype(np.float32))
            .to(dtype) for _ in range(4)]
    want = jlosses.omic_domain_scale_loss(
        *(jnp.asarray(m.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
          for m in maps))
    got = tlosses.omic_domain_scale_loss(*maps)
    assert got.dtype == torch.float32
    # x1e4 on the variance of near-equal diagonal entries, which cancels
    _close(got, want, tol=1e-4)
    x = rng.normal(size=(5, 5)).astype(np.float32)
    _close(tlosses.diag_variance_loss(_t(x), 3.0),
           jlosses.diag_variance_loss(jnp.asarray(x), 3.0))


# ------------------------------------------------------- gradient modulation

@pytest.mark.parametrize("weaker", [1, 2])
def test_gradient_modulation_matches_jax(rng, weaker):
    """Rows 0-2 of the gradient conflict (cosine < 0) and get projected;
    ``weaker`` picks which branch scores lower, so which half moves.  The
    JAX kernel is the transposed torch weight."""
    C, hs, n = 4, 8, 6
    f1 = rng.normal(size=(n, hs)).astype(np.float32)
    f2 = rng.normal(size=(n, hs)).astype(np.float32)
    W = rng.normal(size=(C, 2 * hs)).astype(np.float32) * 0.3
    y = rng.integers(0, C, n)
    # make branch `weaker` score lower by weakening its half of W
    W[:, (weaker - 1) * hs:weaker * hs] *= 0.05
    b = rng.normal(size=(C,)).astype(np.float32)
    g = rng.normal(size=(C, 2 * hs)).astype(np.float32)
    g[:3, hs:] = -g[:3, :hs] + 0.1 * rng.normal(size=(3, hs))
    s_t = tgm.branch_scores(_t(f1), _t(f2), _t(W), _t(b), _t(y))
    s_j = jgm.branch_scores(jnp.asarray(f1), jnp.asarray(f2),
                            jnp.asarray(W.T), jnp.asarray(b), jnp.asarray(y))
    assert (float(s_t[0]) < float(s_t[1])) == (weaker == 1)
    for a, w in zip(s_t, s_j):
        _close(a, w)
    got = tgm.modulate_kernel_grad(_t(g), _t(f1), _t(f2), _t(W), _t(b), _t(y))
    want = jgm.modulate_kernel_grad(jnp.asarray(g.T), jnp.asarray(f1),
                                    jnp.asarray(f2), jnp.asarray(W.T),
                                    jnp.asarray(b), jnp.asarray(y))
    _close(got, np.asarray(want).T)
    moved = ~np.isclose(got.numpy(), g).all(axis=1)
    assert moved[:3].all() and not moved[3:].any()


# ------------------------------------------------------------ optimizers

POLICIES = ["linear", "exp", "step", "plateau", "cosine", "cosinewithwarmup",
            "onecycle", "cosine_torchstep"]


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "adamw"])
def test_optimizer_and_schedule_match_optax(rng, name):
    """Every lr policy under ``name``: 4 epochs x 3 steps of the same
    gradients through the torch optimizer + per-iteration ``LambdaLR`` and
    through the JAX package's optax chain; the parameters after every step
    agree.  ``plateau`` gets an epoch-loss sequence that stalls, so its
    watcher (patience 0) cuts the lr twice."""
    spe, epochs = 3, 4
    shapes = {"w": (3, 4), "b": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(spe * epochs)]
    epoch_losses = [1.0, 0.999, 0.998, 0.5]
    for policy in POLICIES:
        cfg = types.SimpleNamespace(
            lr=0.05, lr_policy=policy, epochs=epochs, warmup_epochs=1,
            optimizer=name, weight_decay=0.01, plateau_factor=0.2,
            plateau_patience=0, plateau_threshold=0.01)
        tx = joptim.make_optimizer(cfg, spe)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jstate = tx.init(jp)
        jwatch = joptim.ReduceLROnPlateau(0.2, 0, 0.01)
        tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
        watch = (toptim.ReduceLROnPlateau(0.2, 0, 0.01)
                 if policy == "plateau" else None)
        opt = toptim.make_optimizer(cfg, list(tp.values()))
        sched = toptim.make_scheduler(cfg, opt, spe, watch)
        for i, g in enumerate(grads):
            upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in tp.items():
                p.grad = _t(g[k])
            opt.step()
            sched.step()
            if policy == "plateau" and (i + 1) % spe == 0:
                loss = epoch_losses[i // spe]
                hp = jstate.hyperparams
                hp["learning_rate"] = jnp.asarray(cfg.lr * jwatch.step(loss))
                toptim.set_learning_rate(opt, cfg.lr * watch.step(loss))
            for k in shapes:
                np.testing.assert_allclose(
                    tp[k].detach().numpy(), np.asarray(jp[k]), rtol=2e-6,
                    atol=2e-6, err_msg=f"{name} {policy} step {i} {k}")
        if policy == "plateau":
            assert watch.scale == pytest.approx(0.04)


def test_schedules_match_optax_step_by_step():
    for policy in POLICIES[:3] + POLICIES[4:]:
        cfg = types.SimpleNamespace(lr=2e-4, lr_policy=policy, epochs=5,
                                    warmup_epochs=1)
        want = joptim.make_schedule(cfg, 4)
        got = toptim.make_schedule(cfg, 4)
        for step in range(25):
            # optax evaluates in f32: 1 + cos cancels near the end
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                              abs=1e-6 * cfg.lr), (policy, step)


# -------------------------------------------------------------- dropout

def test_dropout_is_live_in_train_mode_and_the_loss_reads_the_pre_dropout_map():
    """Train mode: two forwards differ (attention dropout, AlphaDropout,
    MHA dropout); eval mode: they agree.  The attention map returned in
    train mode is the softmax itself (each query's weights over K sum to
    1), which is what the consistency loss reads.  The train step leaves
    the model in train mode, and in eval mode under
    ``deterministic_training``."""
    cfg = Config(fixdim=FIXDIM, batch_size=B, cpb_table_divisor=1).validate()
    model = define_net(cfg, "cpu")
    x = {k: _t(v) for k, v in _inputs().items()}
    torch.manual_seed(0)
    model.train()
    a = model(**x)
    b = model(**x)
    assert not torch.equal(a[2]["logits_teas"], b[2]["logits_teas"])
    for att in a[1].values():
        torch.testing.assert_close(att.sum(dim=-2), torch.ones_like(
            att.sum(dim=-2)), rtol=1e-5, atol=1e-5)
    attn = DeformCrossAttention2D(128, dropout=0.5, cpb_table_divisor=1)
    init_weights(attn, 0)
    q = torch.randn(1, 64, 128)
    attn.train()
    out_t, map_t = attn(q, q)
    attn.eval()
    out_e, map_e = attn(q, q)
    torch.testing.assert_close(map_t, map_e)
    assert not torch.allclose(out_t, out_e)
    model.eval()
    torch.testing.assert_close(model(**x)[2]["logits_teas"],
                               model(**x)[2]["logits_teas"], rtol=0, atol=0)

    batch = SyntheticBagDataset(size=B, fixdim=FIXDIM, seed=0).batch([0, 1])
    for deterministic in (False, True):
        c = cfg.replace(deterministic_training=deterministic)
        opt = toptim.make_optimizer(c, model.parameters())
        make_train_step(model, c, opt)(batch_to_tensors(batch, "cpu"))
        assert model.training is not deterministic


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x_path10=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_path20=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_omic_tumor=r.normal(size=(B, 59)).astype(np.float32),
        x_omic_immune=r.normal(size=(B, 361)).astype(np.float32))


# ---------------------------------------------------- loader and entry

def test_training_loader_shuffles_per_epoch_as_jax():
    kw = dict(size=7, fixdim=4, path_dim=2, seed=3)
    got = BagLoader(SyntheticBagDataset(**kw), 2, shuffle=True,
                    drop_last=True, seed=5)
    want = JLoader(JSynthetic(**kw), 2, shuffle=True, drop_last=True, seed=5)
    assert len(got) == len(want) == 3
    orders = []
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = list(got), list(want)
        for bg, bw in zip(g, w):
            np.testing.assert_array_equal(bg.x_omic, bw.x_omic)
            np.testing.assert_array_equal(bg.label, bw.label)
        orders.append(np.concatenate([b.x_omic for b in g]))
    assert not np.array_equal(orders[0], orders[1])


def test_class_weights_follow_the_task_and_external_eval():
    cfg = Config()
    assert task_class_weights(cfg, "diag2021") == (1.0, 4.15, 2.93, 2.43)
    assert task_class_weights(cfg.replace(external_eval=True),
                              "diag2021") is None
    assert task_class_weights(cfg.replace(task_type="grade",
                                          external_eval=True),
                              "grade") == (1.47, 1.51, 1.0)
    assert task_class_weights(cfg, "survival") is None


def test_training_entry_runs_folds_with_the_eval_cadence(tmp_path):
    """The entry trains each synthetic fold with a fresh model and
    evaluates every ``eval_every_iters`` iterations and at the end; it
    raises for a cohort directory that is not there (instead of falling
    back to synthetic bags, as JAX does) and for the modes not ported yet
    instead of skipping them."""
    cfg = Config(fixdim=FIXDIM, batch_size=B, synthetic_data=True,
                 synthetic_train_size=4, synthetic_test_size=3, kfold=2,
                 epochs=2, eval_every_iters=3, checkpoints="#",
                 cpb_table_divisor=1, debug=True).validate()
    logged = []
    logger = types.SimpleNamespace(log=logged.append)
    results = tmain.main(cfg, device="cpu", logger=logger)
    assert sorted(results) == [0, 1]
    for m in results.values():
        assert np.isfinite(m["train_loss"])
        assert set(m["detail"]) == {f"{n}_{t}" for n in
                                    ("acc", "f1", "auc", "bac", "sens",
                                     "spec", "prec")
                                    for t in ("tea10", "tea20", "teas")}
        assert m["auc"] == m["detail"]["auc_teas"]
    # 2 steps per epoch x 2 epochs: the count crosses 3 once per fold
    assert len(logged) == 2
    assert {"loss", "taskloss", "batchloss"} == set(logged[0]["training"])
    missing = str(tmp_path / "no_cohorts")
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        tmain.main(cfg.replace(synthetic_data=False, dataDir=missing),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="not a mode of the port"):
        run_training(cfg.replace(mode="bogus"), define_net(cfg, "cpu"),
                     ([], None))


def test_training_entry_runs_from_the_command_line():
    proc = subprocess.run(
        [sys.executable, "-m", "disentangled_multimodal_learning_tpu_torch.main",
         "--synthetic_data", "true", "--checkpoints", "#", "--fixdim", "64",
         "--batch_size", "2", "--synthetic_train_size", "2",
         "--synthetic_test_size", "2", "--kfold", "1", "--epochs", "1",
         "--device", "cpu", "--debug"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert "[fold 0] acc=" in proc.stdout and "train_loss=" in proc.stdout


# ------------------------------------------------- trajectories against JAX

@pytest.fixture(scope="module")
def jax_setup():
    """One JAX teacher init (the param tree does not depend on the
    divisor), with every bias nudged off 0: a zero CPB bias puts the relu
    inputs of the divisor-1 table's centre entry exactly at 0, where JAX's
    ``maximum`` splits the gradient in half and torch's relu gives 0."""
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    model = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                         input_size_omic_immune=361)
    x = {k: jnp.asarray(getattr(batches[0], k)) for k in
         ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")}
    params = jax.jit(model.init)(jax.random.PRNGKey(7), **x)["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    return model, params, batches


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("divisor", [0, 1])
def test_train_step_trajectory_matches_jax(monkeypatch, jax_setup, divisor):
    """20 AdamW steps (cosine schedule, gradient modulation, the attention
    consistency loss) of the port's ``make_train_step`` and of the JAX
    ``make_train_step`` on alternating batches, from the same weights.

    Step 0: the loss within 1e-5 relative, and every parameter's
    gradient after modulation within 1e-4 rel-L2 (JAX's read off AdamW's
    first moment, ``mu = 0.1 g``), except the CPB MLPs' output biases: the
    softmax over the kv axis ignores a constant shift, so their gradient is
    0 in exact arithmetic, and both frameworks hold rounding noise (checked
    to be below 1e-5 of the output weights' gradient).

    Then every step's loss within 2e-4 relative (observed at most 4.1e-5
    at divisor 0 and 2.7e-5 at divisor 1; the JAX package's own envelope
    is 5e-3), and the final classifiers and CPB ``mlp0`` weights within
    1e-5 rel-L2 (observed at most 4.2e-7; JAX's envelope 5e-4).  Leaves
    that the loss barely moves (the CPB output biases above) are left out:
    Adam turns their noise into full-size steps."""
    monkeypatch.setattr(jda, "CPB_TABLE_DIVISOR", divisor)
    if divisor == 1:
        monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")
    jmodel, params, batches = jax_setup
    jcfg = jconfig.Config(
        mode="teacher", task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=STEPS, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, gradient_modulate=True,
        multiscale_attention=True, deterministic_training=True,
        checkpoints="#", cpb_table_divisor=divisor).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jmodel, jcfg, tx))
    jax_losses = []
    for k in range(STEPS):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "teacher")
    jax_final = export_torch_state_dict(jax.device_get(state.params),
                                        "teacher")

    cfg = Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=divisor, epochs=STEPS,
                 deterministic_training=True).validate()
    model = load_jax_params(define_net(cfg, "cpu"), params, "teacher")
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt,
                           toptim.make_scheduler(cfg, opt, 1))
    losses = []
    for k in range(STEPS):
        losses.append(float(step(batch_to_tensors(batches[k % 2], "cpu"))
                          ["loss"]))
        if k == 0:
            assert abs(losses[0] - jax_losses[0]) <= 1e-5 * abs(jax_losses[0])
            for name, p in model.named_parameters():
                want = np.asarray(jax_grads[name])
                if name.endswith("rel_pos_bias.mlp.2.bias"):
                    w3 = model.get_parameter(name[:-4] + "weight").grad
                    floor = 1e-5 * w3.abs().max().item()
                    assert p.grad.abs().max().item() <= floor, name
                    assert np.abs(want).max() <= floor, name
                    continue
                assert _rel_l2(p.grad, want) <= 1e-4, name
    for k, (a, b) in enumerate(zip(losses, jax_losses)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (k, a, b)
    sd = model.state_dict()
    for name in ("teacher10_net.classifier.weight",
                 "teacher20_net.classifier.weight",
                 "teacher10_net.encoder.attn2d_omic1.rel_pos_bias.mlp.0.0.weight"):
        assert _rel_l2(sd[name], jax_final[name]) <= 1e-5, name

"""The port's distillation path against the JAX package on the CPU: the
two distillation losses, the frozen teacher's boundary tensors, 20-step
trajectories of the distillation train step against JAX's uncached
``make_train_step(..., teacher_model=...)``, one step of each single-loss
weighting, the cached step against the uncached one, and the entries from
the command line without JAX.

As in ``tests/test_torch_student.py``: the student's DPC noise is JAX's
eval-time draw on both sides (``jax_noise``), every bias is nudged off 0
(the divisor-1 table's centre relu ties exactly at a zero CPB bias, where
JAX's ``maximum`` splits the gradient and torch's relu gives 0), and at
divisor 1 the JAX attention layout is forced to "kn" (on the CPU "auto"
means "nk", which never takes the table CPB).  fixdim 64, B = 2, the real
widths.

Tolerances: the losses alone 1e-6 (f32, other summation orders); the
boundary tensors 1e-4 abs (the teacher's logits tolerance); the
trajectories the student's (step 0: loss 1e-5 relative, the logged
``batchloss`` 1e-4, gradients 1e-4 rel-L2 but for the two biases whose
gradient is 0 in exact arithmetic;
every step's loss 2e-4 relative; final weights 1e-5 rel-L2).  The cached
step against the uncached one, and a run through the trainer with the
cache against one without: bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    StudentsNet as JStudentsNet, TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train import losses as jlosses
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_teacher_boundary_fn as jmake_boundary,
    make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.main import (
    make_loaders, synthetic_fold_datasets)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.ops import cluster as tcluster
from disentangled_multimodal_learning_tpu_torch.train import losses as tlosses
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.distill_cache import (
    TeacherBoundaryCache, loader_dataset_size)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    BOUNDARY_KEYS, batch_to_tensors, make_distill_cached_step,
    make_teacher_boundary_fn, make_train_step)
from disentangled_multimodal_learning_tpu_torch.train.trainers import (
    trainDistillation)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "config" / "config_mine_diag2021.yaml"
FIXDIM, B, STEPS = 64, 2, 20
LOGITS_TOL = 1e-4
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's pinned DPC noise replaced by JAX's eval-time draw."""
    def draw(shape, device):
        return _t(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), tuple(shape), jnp.float32))).to(device)

    monkeypatch.setattr(tcluster, "pinned_density_noise", draw)


def _use_jax_divisor(monkeypatch, divisor):
    monkeypatch.setattr(jda, "CPB_TABLE_DIVISOR", divisor)
    if divisor == 1:
        monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")


def _nudge_biases(params, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)


@pytest.fixture(scope="module")
def jax_setup():
    """JAX student and teacher inits at fixdim 64 (biases nudged) and two
    batches."""
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    arrays = batch_to_arrays(batches[0])
    student = JStudentsNet(label_dim=4)
    teacher = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                           input_size_omic_immune=361)
    sparams = jax.jit(student.init)(
        jax.random.PRNGKey(7), arrays["x_path10"],
        arrays["x_path20"])["params"]
    tparams = jax.jit(teacher.init)(
        jax.random.PRNGKey(8), arrays["x_path10"], arrays["x_path20"],
        arrays["x_omic_tumor"], arrays["x_omic_immune"])["params"]
    return (student, _nudge_biases(sparams, 3), teacher,
            _nudge_biases(tparams, 4), batches)


def _cfg(divisor, **kw):
    return Config(mode="distillation", fixdim=FIXDIM, batch_size=B,
                  cpb_table_divisor=divisor, epochs=STEPS,
                  deterministic_training=True, **kw).validate()


def _port_nets(cfg, sparams, tparams):
    student, teacher = define_net(cfg, "cpu")
    return (load_jax_params(student, sparams, "student"),
            load_jax_params(teacher, tparams, "teacher"))


@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_distillation_losses_match_jax(rng, temperature):
    """The KL at ``temperature`` (batchmean x T^2, the clip inside the log;
    one teacher row nearly one-hot, so that the clip matters) and the
    feature MSE, against JAX."""
    s = rng.normal(size=(5, 4)).astype(np.float32) * 3
    t = rng.normal(size=(5, 4)).astype(np.float32) * 3
    t[0] = (-200.0, 200.0, -200.0, -200.0)
    want = jlosses.distillation_loss(jnp.asarray(s), jnp.asarray(t),
                                     temperature)
    got = tlosses.distillation_loss(_t(s), _t(t), temperature)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    fs = rng.normal(size=(5, 256)).astype(np.float32)
    ft = rng.normal(size=(5, 256)).astype(np.float32)
    want = jlosses.feature_distillation_loss(jnp.asarray(fs), jnp.asarray(ft))
    got = tlosses.feature_distillation_loss(_t(fs), _t(ft))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_teacher_boundary_matches_jax(monkeypatch, jax_setup):
    """The frozen teacher's four boundary tensors at the preset's divisor 1:
    the logits of both scales ``[B, 4]`` and the concatenated feature
    halves ``[B, 256]``; the teacher is left in eval mode."""
    _use_jax_divisor(monkeypatch, 1)
    _, sparams, jteacher, tparams, batches = jax_setup
    want = jax.jit(jmake_boundary(jteacher))({"params": tparams},
                                             batch_to_arrays(batches[0]))
    _, teacher = _port_nets(_cfg(1), sparams, tparams)
    teacher.train()
    got = make_teacher_boundary_fn(teacher)(
        batch_to_tensors(batches[0], "cpu"))
    assert not teacher.training
    for k, g, w in zip(BOUNDARY_KEYS, got, want):
        assert g.shape == w.shape == ((B, 4) if "lt" in k else (B, 256)), k
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGITS_TOL,
                                   rtol=0, err_msg=k)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _trajectories(jax_setup, divisor, steps, **distill):
    """``steps`` distillation steps of JAX's uncached step and of the
    port's, on alternating batches from the same weights: -> (port losses,
    JAX losses, port metrics of step 0, JAX metrics of step 0, JAX's step-0
    gradients, JAX's final student, the port's student)."""
    jstudent, sparams, jteacher, tparams, batches = jax_setup
    jcfg = jconfig.Config(
        mode="distillation", task_type="diag2021", label_dim=4,
        fixdim=FIXDIM, batch_size=B, epochs=STEPS, lr=2e-4,
        lr_policy="cosine", optimizer="adamw", weight_decay=0.01,
        multiscale_attention=True, deterministic_training=True,
        checkpoints="#", cpb_table_divisor=divisor, **distill).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": sparams}, tx)
    jstep = jax.jit(jmake_train_step(jstudent, jcfg, tx,
                                     teacher_model=jteacher))
    jax_losses = []
    for k in range(steps):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k), {"params": tparams})
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_m0 = {n: float(v) for n, v in m.items()}
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "student")
    jax_final = export_torch_state_dict(jax.device_get(state.params),
                                        "student")
    cfg = _cfg(divisor, **distill)
    student, teacher = _port_nets(cfg, sparams, tparams)
    opt = toptim.make_optimizer(cfg, student.parameters())
    step = make_train_step(student, cfg, opt,
                           toptim.make_scheduler(cfg, opt, 1),
                           teacher=teacher)
    losses = []
    for k in range(steps):
        m = step(batch_to_tensors(batches[k % 2], "cpu"))
        losses.append(float(m["loss"]))
        if k == 0:
            m0 = {n: float(v) for n, v in m.items()}
            for name, p in student.named_parameters():
                if name.endswith(ZERO_GRAD_BIASES):
                    w = student.get_parameter(name[:-4] + "weight").grad
                    floor = 1e-5 * w.abs().max().item()
                    assert p.grad.abs().max().item() <= floor, name
                    assert np.abs(jax_grads[name]).max() <= floor, name
                    continue
                assert _rel_l2(p.grad, jax_grads[name]) <= 1e-4, name
    return losses, jax_losses, m0, jax_m0, jax_final, student


@pytest.mark.parametrize("divisor", [0, 1])
def test_distillation_trajectory_matches_jax(monkeypatch, jax_noise,
                                             jax_setup, divisor):
    """20 AdamW steps (cosine schedule) of the port's uncached distillation
    step and JAX's, both distillation losses on (``taskloss + 0.01 dl +
    0.01 df``, T = 2), the frozen teacher run every step,
    ``deterministic_training``, alternating two batches, 2 clusters a bag.
    Step 0: the loss and its parts (the task loss, both distillation
    losses) within 1e-5 relative, the logged ``batchloss`` within 1e-4
    (the consistency-loss tolerance of ``tests/test_torch_train.py``: a
    sum of squared differences of near-equal Grams, whose cancellation
    amplifies f32 rounding; observed 1.2e-5), every student
    gradient within 1e-4 rel-L2 (JAX's read off AdamW's first moment),
    the two biases whose gradient is 0 in exact arithmetic below 1e-5 of
    their weights'.  Then every step's loss within 2e-4 relative and the
    final classifiers, cluster scores and CPB ``mlp0`` weights within 1e-5
    rel-L2.  DPC modes are discrete: a near-tie broken differently would
    fork the trajectory, so all 20 steps run."""
    _use_jax_divisor(monkeypatch, divisor)
    losses, jax_losses, m0, jax_m0, jax_final, student = _trajectories(
        jax_setup, divisor, STEPS)
    assert set(m0) == set(jax_m0) == {
        "loss", "taskloss", "distillloss_logits", "distillloss_feature",
        "batchloss"}
    for n, v in jax_m0.items():
        tol = 1e-4 if n == "batchloss" else 1e-5
        assert abs(m0[n] - v) <= tol * abs(v), (n, m0[n], v)
    for k, (a, b) in enumerate(zip(losses, jax_losses)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (k, a, b)
    sd = student.state_dict()
    for name in ("student10_net.classifier.weight",
                 "student20_net.classifier.weight",
                 "student10_net.encoder.cluster_merge.score.weight",
                 "student10_net.encoder.attn2d.rel_pos_bias.mlp.0.0.weight"):
        assert _rel_l2(sd[name], jax_final[name]) <= 1e-5, name


@pytest.mark.parametrize("distill_logits,distill_feature",
                         [(True, False), (False, True)])
def test_single_distillation_loss_weighting_matches_jax(
        monkeypatch, jax_noise, jax_setup, distill_logits, distill_feature):
    """One step with one distillation loss: the loss is ``taskloss`` plus
    that loss at weight 1 (JAX's weighting), on both sides within 1e-5
    relative (``batchloss`` 1e-4, as in the trajectory test), and the
    gradients as in the trajectory test (divisor 0)."""
    _use_jax_divisor(monkeypatch, 0)
    _, _, m0, jax_m0, _, _ = _trajectories(
        jax_setup, 0, 1, distill_logits=distill_logits,
        distill_feature=distill_feature)
    part = "distillloss_logits" if distill_logits else "distillloss_feature"
    assert set(m0) == set(jax_m0) == {"loss", "taskloss", part, "batchloss"}
    for n, v in jax_m0.items():
        tol = 1e-4 if n == "batchloss" else 1e-5
        assert abs(m0[n] - v) <= tol * abs(v), (n, m0[n], v)
    assert m0["loss"] == pytest.approx(m0["taskloss"] + m0[part], rel=1e-6)


def _fold(cfg, seed=0):
    return make_loaders(cfg, *synthetic_fold_datasets(cfg, seed))


def test_cached_step_equals_uncached_step():
    """Two epochs of 2 steps each (dropout on, so both steps draw the same
    masks from the same seeds): the cached step with a
    ``TeacherBoundaryCache`` gives losses and weights bitwise equal to the
    uncached step's; epoch 1 misses on each batch and fills the store,
    epoch 2 (reshuffled) replays every batch.  A batch without indices
    recomputes and counts a miss."""
    cfg = Config(mode="distillation", fixdim=FIXDIM, batch_size=B,
                 synthetic_data=True, synthetic_train_size=4,
                 epochs=2).validate()
    loader = _fold(cfg)[0]
    runs = []
    for cached in (False, True):
        student, teacher = define_net(cfg, "cpu")
        opt = toptim.make_optimizer(cfg, student.parameters())
        sched = toptim.make_scheduler(cfg, opt, len(loader))
        if cached:
            cache = TeacherBoundaryCache(make_teacher_boundary_fn(teacher),
                                         loader_dataset_size(loader), "cpu")
            step = make_distill_cached_step(student, cfg, opt, sched)
        else:
            step = make_train_step(student, cfg, opt, sched, teacher=teacher)
        losses = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            for k, batch in enumerate(loader):
                tensors = batch_to_tensors(batch, "cpu")
                if cached:
                    tensors.update(cache.boundary(tensors, batch.indices))
                    assert (cache.hits, cache.misses) == (
                        (0, k + 1) if epoch == 0 else (k + 1, 2))
                torch.manual_seed(100 * epoch + k)
                losses.append(step(tensors)["loss"].item())
        runs.append((losses, student.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    batch = next(iter(loader))
    tensors = batch_to_tensors(batch, "cpu")
    want = make_teacher_boundary_fn(teacher)(tensors)
    got = cache.boundary(tensors, None)
    assert (cache.hits, cache.misses) == (2, 3)
    for k, w in zip(BOUNDARY_KEYS, want):
        assert torch.equal(got[k], w), k


def test_trainer_with_the_cache_equals_the_trainer_without(capsys):
    """``trainDistillation`` over 2 epochs with ``distill_teacher_cache``
    on (the cached step, 2 misses then 2 hits) and off (the uncached step,
    no cache): bitwise equal losses, weights and final logits."""
    cfg = Config(mode="distillation", fixdim=FIXDIM, batch_size=B,
                 synthetic_data=True, synthetic_train_size=4,
                 synthetic_test_size=3, kfold=1, epochs=2,
                 eval_every_iters=100, checkpoints="#",
                 cpb_table_divisor=1).validate()
    runs = []
    for cache in (True, False):
        student, teacher = define_net(cfg, "cpu")
        _, final, path = trainDistillation(
            student, teacher, _fold(cfg), None, None, None,
            cfg.replace(distill_teacher_cache=cache))
        runs.append((final, student.state_dict()))
        out = capsys.readouterr().out
        assert ("[distill cache] 2 hits, 2 misses" in out) == cache
        assert path is None
    (a, sa), (b, sb) = runs
    assert len(a["train_losses"]) == 4
    assert a["train_losses"] == b["train_losses"]
    assert set(a["logits"]) == {"logits_stu10", "logits_stu20",
                                "logits_stus"}
    for k in a["logits"]:
        np.testing.assert_array_equal(a["logits"][k], b["logits"][k])
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_loader_size_and_batch_indices():
    """Every batch of the loader carries its dataset rows (the cache's
    keys; a padded batch repeats the last row), and the cache reads the
    dataset's size through the loader."""
    ds = SyntheticBagDataset(size=5, fixdim=16, path_dim=8, omic_dim=40,
                             omic_tumor_dim=7, omic_immune_dim=30)
    batches = list(BagLoader(ds, 2))
    assert [b.indices.tolist() for b in batches] == [[0, 1], [2, 3], [4, 4]]
    assert batches[-1].wsi_id.tolist() == ["SYN-00004"] * 2
    assert loader_dataset_size(BagLoader(ds, 2)) == 5
    assert loader_dataset_size([]) is None


def test_distillation_entries_run_from_the_command_line_without_jax(
        tmp_path):
    """A fresh interpreter trains a teacher into a checkpoint directory,
    distils the student from that checkpoint (``--checkpoints_teacher``,
    the cache on: one miss and one hit), serves the distilled student from
    its checkpoint, and never loads jax, jaxlib or flax."""
    port = "disentangled_multimodal_learning_tpu_torch"
    code = (
        "import glob, runpy, sys\n"
        "d = sys.argv[2]\n"
        "tiny = ['--config', sys.argv[1], '--synthetic_data', 'true',"
        " '--fixdim', '64', '--batch_size', '2', '--synthetic_train_size',"
        " '2', '--synthetic_test_size', '2', '--kfold', '1',"
        " '--device', 'cpu', '--checkpoints', d, '--debug']\n"
        "sys.argv = ['main'] + tiny\n"
        f"runpy.run_module('{port}.main', run_name='__main__')\n"
        "teacher, = glob.glob(d + '/teacher_fold_1_epoch_10_*.pt')\n"
        "sys.argv = ['main'] + tiny + ['--mode', 'distillation', '--epochs',"
        " '2', '--checkpoints_teacher', teacher]\n"
        f"runpy.run_module('{port}.main', run_name='__main__')\n"
        "student, = glob.glob(d + '/distillation_fold_1_epoch_2_*.pt')\n"
        "sys.argv = ['inference'] + tiny + ['--mode', 'distillation',"
        " '--checkpoint', student]\n"
        f"runpy.run_module('{port}.inference', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax') if m in sys.modules]\n"
        "print('HEAVY', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(PRESET),
                           str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    assert "[distill cache] 1 hits, 1 misses" in proc.stdout
    assert "ckpt=" + str(tmp_path) + "/distillation_fold_1_epoch_2_" in (
        proc.stdout)
    assert "acc_stus=" in proc.stdout

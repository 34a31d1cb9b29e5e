"""The port's checkpoints, resume and survival evaluation against the JAX
package on the CPU: ``metric_stamped_name``, a saved and restored train
state, a resumed fold, ``reload``, the checkpoint's ``params`` read by
JAX's ``import_torch_checkpoint``, the c-index, survival ``distill_val``
and ``fused_val``, the ROC CSVs and the attention-map export, and the
survival entries from the command line without JAX.

Weights: the port's seeded init, carried into JAX by its own importer
(whose logits the import test holds within 1e-4); every JAX forward runs at
divisor 1 with the JAX attention layout forced to "kn" (on the CPU "auto"
means "nk", which never takes the table CPB), and the student's DPC noise
is JAX's eval-time draw on both sides.  fixdim 64, B = 2, the real widths.

Tolerances: a restored state, a resumed fold and ``reload`` bitwise; the
logits 1e-4 abs (the teacher's serving tolerance); the c-index exactly
(its risks differ by ~1e-6, far less than the gaps between the bags'
risks); the ROC scores and the attention maps 1e-5 abs (softmax and means
of logits and maps within 1e-4 and 1e-5).
"""

import csv
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.loader import BagLoader as JLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.deform_mil import (
    DeformPathomicNet as JDeformPathomicNet)
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    StudentsNet as JStudentsNet, TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train import metrics as jmetrics
from disentangled_multimodal_learning_tpu.train.evaluation import (
    Evaluator as JEvaluator)
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_eval_step)
from disentangled_multimodal_learning_tpu.utils import checkpoint as jckpt
from disentangled_multimodal_learning_tpu.utils.torch_import import (
    import_torch_checkpoint)
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.ops import cluster as tcluster
from disentangled_multimodal_learning_tpu_torch.train import metrics as tmetrics
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train import trainers
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    Evaluator)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parents[1]
SURV_PRESET = REPO / "config" / "config_mine_surv.yaml"
FIXDIM, B = 64, 2
LOGITS_TOL, EXPORT_TOL = 1e-4, 1e-5
_JAX_NETS = {
    "teacher": lambda task: JTeachersNet(label_dim=4,
                                         input_size_omic_tumor=59,
                                         input_size_omic_immune=361),
    "student": lambda task: JStudentsNet(label_dim=4),
    "deformpathomic": lambda task: JDeformPathomicNet(
        label_dim=4, input_size_omic_tumor=59, input_size_omic_immune=361,
        task_type=task)}


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
def jax_kn(monkeypatch):
    """JAX at divisor 1 in the "kn" layout, with the port's pinned DPC noise
    replaced by JAX's eval-time draw."""
    monkeypatch.setattr(jda, "CPB_TABLE_DIVISOR", 1)
    monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")

    def draw(shape, device):
        return _t(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), tuple(shape), jnp.float32))).to(device)

    monkeypatch.setattr(tcluster, "pinned_density_noise", draw)


def _cfg(mode="teacher", **kw):
    return Config(mode=mode, fixdim=FIXDIM, batch_size=B,
                  cpb_table_divisor=1, synthetic_data=True, debug=True,
                  **kw).validate()


def _jax_state(model, mode):
    """The port model's weights as a JAX state (``params``,
    ``batch_stats``) through JAX's importer."""
    params = import_torch_checkpoint(model.state_dict(), mode=mode)
    return types.SimpleNamespace(params=params, batch_stats=None)


def _loaders(n, seed, jcfg):
    return (BagLoader(SyntheticBagDataset(size=n, fixdim=FIXDIM, seed=seed),
                      B),
            JLoader(JSynthetic(size=n, fixdim=FIXDIM, label_dim=4, seed=seed,
                               args=jcfg), B, shuffle=False,
                    drop_last=False))


@pytest.mark.parametrize("task,mode", [("diag2021", None),
                                       ("diag2021", "teacher"),
                                       ("survival", None),
                                       ("survival", "distillation")])
def test_metric_stamped_name_matches_jax(task, mode):
    metrics = {"auc": 0.8125, "acc": 0.5, "sens": 0.4375, "spec": 0.8333333,
               "f1": 0.42, "cindex": 0.61234567}
    for fold, epoch in ((0, 9), (2, 0)):
        assert checkpoint.metric_stamped_name(
            fold, epoch, metrics, task, mode=mode) == (
            jckpt.metric_stamped_name(fold, epoch, metrics, task, mode=mode))


def test_saved_state_restores_logits_and_next_step(tmp_path):
    """Two steps, then ``save_checkpoint``; a model of another seed, a
    fresh optimizer and scheduler restored from it give bitwise the same
    eval logits, learning rate and next step (loss and every weight).  A
    bare reference-named state_dict (``.pth``) loads its params only."""
    cfg = _cfg(epochs=3, gradient_modulate=True)
    ds = SyntheticBagDataset(size=2 * B, fixdim=FIXDIM)
    batches = [batch_to_tensors(ds.batch(range(k * B, (k + 1) * B)), "cpu")
               for k in range(2)]

    def fresh(seed):
        model = define_net(cfg.replace(seed=seed), "cpu")
        opt = toptim.make_optimizer(cfg, model.parameters())
        sched = toptim.make_scheduler(cfg, opt, 2)
        return model, opt, sched, make_train_step(model, cfg, opt, sched)

    a, opt_a, sched_a, step_a = fresh(cfg.seed)
    for k in range(2):
        torch.manual_seed(k)
        step_a(batches[k])
    path = checkpoint.save_checkpoint(str(tmp_path), "state", a, opt_a,
                                      sched_a, 2, extra={"mode": "teacher"})
    assert path == str(tmp_path / "state.pt")
    b, opt_b, sched_b, step_b = fresh(cfg.seed + 1)
    assert checkpoint.restore_state(b, opt_b, sched_b, path) == 2
    assert sched_b.last_epoch == sched_a.last_epoch == 2
    assert opt_b.param_groups[0]["lr"] == opt_a.param_groups[0]["lr"]
    assert checkpoint.load_checkpoint(path)["extra"] == {"mode": "teacher"}
    batch = ds.batch(range(B))
    logits = [Evaluator(m.eval(), cfg, "cpu", "teacher").step(batch)
              for m in (a, b)]
    for k in logits[0]:
        np.testing.assert_array_equal(logits[0][k], logits[1][k])
    losses = []
    for step in (step_a, step_b):
        torch.manual_seed(5)
        losses.append(step(batches[0])["loss"].item())
    assert losses[0] == losses[1]
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    bare = tmp_path / "bare.pth"
    torch.save(a.state_dict(), bare)
    c, opt_c, sched_c, _ = fresh(cfg.seed + 2)
    assert checkpoint.restore_state(c, opt_c, sched_c, str(bare)) == 0
    assert sched_c.last_epoch == 0 and not opt_c.state
    for k, v in c.state_dict().items():
        assert torch.equal(v, sa[k]), k


class _Stop(Exception):
    pass


@pytest.mark.parametrize("mode", ["teacher", "distillation"])
def test_resumed_fold_equals_the_uninterrupted_fold(tmp_path, monkeypatch,
                                                    mode):
    """Under ``deterministic_training``, a fold of 2 epochs (2 steps each)
    killed after epoch 1's rolling checkpoint and restarted with ``resume``
    trains epoch 2 only and ends bitwise where the uninterrupted fold ends:
    the same step losses, final logits, checkpoint name, weights and
    optimizer state."""
    cfg = _cfg(mode, synthetic_train_size=4, synthetic_test_size=3,
               kfold=1, epochs=2, eval_every_iters=100,
               save_every_epochs=1, deterministic_training=True)
    whole = tmain.main(cfg.replace(checkpoints=str(tmp_path / "a")),
                       device="cpu")[0]
    save = trainers.save_checkpoint

    def killed_after_rolling_save(directory, name, *args, **kw):
        path = save(directory, name, *args, **kw)
        if name.endswith("_latest"):
            raise _Stop(path)
        return path

    monkeypatch.setattr(trainers, "save_checkpoint",
                        killed_after_rolling_save)
    part = cfg.replace(checkpoints=str(tmp_path / "b"))
    with pytest.raises(_Stop):
        tmain.main(part, device="cpu")
    monkeypatch.setattr(trainers, "save_checkpoint", save)
    latest = checkpoint.load_checkpoint(
        str(tmp_path / "b" / f"{mode}_fold_1_latest.pt"))
    assert (latest["step"], latest["extra"]["epoch"]) == (2, 1)
    resumed = tmain.main(part.replace(resume=True), device="cpu")[0]
    assert resumed["train_losses"] == whole["train_losses"][2:]
    for k in whole["logits"]:
        np.testing.assert_array_equal(resumed["logits"][k],
                                      whole["logits"][k])
    names = [sorted(p.name for p in (tmp_path / d).iterdir()) for d in "ab"]
    assert names[0] == names[1] and len(names[0]) == 2
    final = [checkpoint.load_checkpoint(str(tmp_path / d / names[0][0]))
             for d in "ab"]
    assert final[0]["step"] == final[1]["step"] == 4
    for k, v in final[0]["params"].items():
        assert torch.equal(v, final[1]["params"][k]), k
    for p, s in final[0]["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, final[1]["opt_state"]["state"][p][k]), k


def test_reload_restores_the_full_state(tmp_path):
    """``reload`` starts the teacher from ``checkpoints_teacher``'s weights,
    optimizer state and step: with no epoch to train, the fold's checkpoint
    holds exactly what it was restored from."""
    cfg = _cfg(synthetic_train_size=4, synthetic_test_size=2, kfold=1,
               epochs=1, checkpoints=str(tmp_path))
    tmain.main(cfg, device="cpu")
    src, = tmp_path.glob("teacher_fold_1_epoch_1_*.pt")
    tmain.main(cfg.replace(reload=True, checkpoints_teacher=str(src),
                           epochs=0), device="cpu")
    out, = tmp_path.glob("teacher_fold_1_epoch_0_*.pt")
    a, b = (checkpoint.load_checkpoint(str(p)) for p in (src, out))
    assert a["step"] == b["step"] == 2
    assert b["scheduler"]["last_epoch"] == 2
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for p, s in a["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["opt_state"]["state"][p][k]), k


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_checkpoint_params_load_into_jax(tmp_path, jax_kn, mode):
    """The ``params`` of the port's checkpoint are the reference's format:
    JAX's ``import_torch_checkpoint`` takes them as they are, and JAX's eval
    logits from them are within 1e-4 of the port's."""
    cfg = _cfg(mode)
    model = define_net(cfg, "cpu")
    path = checkpoint.save_checkpoint(str(tmp_path), mode, model)
    params = import_torch_checkpoint(
        checkpoint.load_checkpoint(path)["params"], mode=mode)
    jcfg = jconfig.Config(mode=mode, fixdim=FIXDIM, batch_size=B,
                          cpb_table_divisor=1).validate()
    batch = SyntheticBagDataset(size=B, fixdim=FIXDIM, seed=5).batch(range(B))
    step = jax.jit(make_eval_step(_JAX_NETS[mode](cfg.task_type), jcfg, mode,
                                  need_attention=False))
    want = step(params, None, batch_to_arrays(batch))[2]
    got = Evaluator(model, cfg, "cpu", mode).step(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   atol=LOGITS_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["random", "tied_times", "tied_risks",
                                  "censored", "none_comparable"])
def test_cindex_matches_jax(rng, case):
    """sksurv semantics: tied times count where the later one is censored,
    risks within 1e-8 count 0.5; 0.0 when no pair is comparable."""
    n = 40
    times = rng.integers(30, 3000, n)
    risk = rng.normal(size=n)
    censor = rng.integers(0, 2, n)
    if case == "tied_times":
        times = rng.integers(0, 5, n) * 100
    elif case == "tied_risks":
        risk = np.round(rng.normal(size=n))
        risk[:5] += 1e-9
    elif case == "censored":
        censor = (rng.random(n) < 0.9).astype(int)
    elif case == "none_comparable":
        censor = np.ones(n, int)
    got = tmetrics.cindex(risk, censor, times)
    assert got == jmetrics.cindex(risk, censor, times)
    if case == "none_comparable":
        assert got == 0.0
    else:
        assert 0.0 < got < 1.0


@pytest.mark.parametrize("mode", ["teacher", "student", "deformpathomic"])
def test_survival_evaluation_matches_jax(jax_kn, mode):
    """The c-index per tag on the survival task: ``distill_val`` of the
    teacher and the student (their ``risk_<tag>`` outputs), ``fused_val``
    of deformpathomic (``-sum(cumprod(1 - hazards))``), over 7 bags in
    batches of 2 (the last padded), against JAX on the same weights."""
    cfg = _cfg(mode, task_type="survival")
    model = define_net(cfg, "cpu")
    jcfg = jconfig.Config(mode=mode, task_type="survival", fixdim=FIXDIM,
                          batch_size=B, cpb_table_divisor=1).validate()
    loader, jloader = _loaders(7, 11, jcfg)
    want = JEvaluator(_JAX_NETS[mode]("survival"), jcfg)(
        _jax_state(model, mode), jloader)
    model_type = "fused" if mode == "deformpathomic" else mode
    ev = Evaluator(model, cfg, "cpu", model_type)
    outs, labels = ev.logits(loader)
    got = ev.metrics(outs, labels)
    if mode == "deformpathomic":
        want = {"cindex_fused": want}
    else:
        assert {f"risk_{t}" for t in ev.tags} <= set(outs)
    assert set(got) == set(want)
    for k, v in want.items():
        assert 0.0 < got[k] < 1.0 and got[k] == v, (k, got[k], v)


def test_roc_csv_and_attention_maps_match_jax(tmp_path, jax_kn):
    """``save4roc`` and the attention-map export of the teacher over 3 bags
    (the last batch padded) against JAX's files: the same CSV rows (scores
    within 1e-5), and the same npz keys and shapes, maps and scores within
    1e-5, labels and slide ids equal."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    cfg = _cfg(save4roc=True, checkpoints=str(tdir))
    model = define_net(cfg, "cpu")
    jcfg = jconfig.Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                          cpb_table_divisor=1, save4roc=True,
                          checkpoints=str(jdir)).validate()
    loader, jloader = _loaders(3, 13, jcfg)
    jev = JEvaluator(_JAX_NETS["teacher"]("diag2021"), jcfg)
    state = _jax_state(model, "teacher")
    jev(state, jloader)
    jev.export_attention_maps(state, jloader, str(jdir / "att.npz"))
    ev = Evaluator(model, cfg, "cpu", "teacher")
    ev.metrics(*ev.logits(loader))
    ev.export_attention_maps(loader, str(tdir / "att.npz"))
    for tag in ("tea10", "tea20", "teas"):
        name = f"roc_{tag}_fold0.csv"
        rows = [list(csv.reader(open(d / name))) for d in (jdir, tdir)]
        assert rows[0][0] == rows[1][0] == ["label"] + [
            f"score_{i}" for i in range(4)]
        assert len(rows[0]) == len(rows[1]) == 4
        for a, b in zip(rows[0][1:], rows[1][1:]):
            assert a[0] == b[0]
            np.testing.assert_allclose(np.float64(b[1:]), np.float64(a[1:]),
                                       atol=EXPORT_TOL, rtol=0)
    want, got = (np.load(d / "att.npz") for d in (jdir, tdir))
    assert set(got) == set(want) == {
        "scores", "labels", "wsi_ids", "attention", "att_att1_tea10",
        "att_att1_tea20", "att_att2_tea10", "att_att2_tea20"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in ("labels", "wsi_ids"):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], atol=EXPORT_TOL,
                                       rtol=0, err_msg=k)
    assert got["attention"].shape == (3, FIXDIM)


def test_survival_entries_run_from_the_command_line_without_jax(tmp_path):
    """A fresh interpreter runs the survival preset's training entry (the
    teacher, a ``cindex``-stamped checkpoint) and its serving entry from
    that checkpoint, with ``--device cpu``, and never loads jax, jaxlib or
    flax."""
    port = "disentangled_multimodal_learning_tpu_torch"
    code = (
        "import glob, runpy, sys\n"
        "d = sys.argv[2]\n"
        "tiny = ['--config', sys.argv[1], '--synthetic_data', 'true',"
        " '--fixdim', '64', '--batch_size', '2', '--synthetic_train_size',"
        " '2', '--synthetic_test_size', '4', '--kfold', '1', '--epochs', '1',"
        " '--device', 'cpu', '--checkpoints', d, '--debug']\n"
        "sys.argv = ['main'] + tiny\n"
        f"runpy.run_module('{port}.main', run_name='__main__')\n"
        "ckpt, = glob.glob(d + '/teacher_fold_1_epoch_1_cindex_*.pt')\n"
        "sys.argv = ['inference'] + tiny + ['--checkpoint', ckpt]\n"
        f"runpy.run_module('{port}.inference', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax') if m in sys.modules]\n"
        "print('HEAVY', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(SURV_PRESET),
                           str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    assert "[fold 0] cindex=" in proc.stdout
    assert "cindex_tea10=" in proc.stdout and "cindex_teas=" in proc.stdout

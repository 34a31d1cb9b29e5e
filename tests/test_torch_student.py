"""The port's two-scale student against the JAX package on the CPU: the
ClusterMergeNet and the whole ``StudentsNet`` (and one ``StudentNet``)
through ``load_jax_params``, ``path_batch_loss``, the serving entry against
the JAX eval step, the training entry, and 20-step trajectories of the
student train step against the JAX step.  Also the port's own JAX name map
against the JAX package's exporter, and the entries' refusal to run off the
card unless asked.

The DPC tie-break noise: JAX draws ``uniform(PRNGKey(0), [B, N])`` in eval
and under ``deterministic_training``; the port's ``pinned_density_noise``
is its own fixed draw, so every test here substitutes JAX's draw for it
(``monkeypatch``) and both frameworks see identical noise.  At divisor 1
the JAX attention layout is forced to "kn" (on the CPU "auto" means "nk",
which never takes the table CPB).

Sizes: fixdim 144 (forwards, B=2) and 64 (trajectories, B=2), the real
widths (1024-d patches, dims 128, 8 heads), ``path_cluster_num`` 0.0008,
which gives ``min_clusters`` = 2 clusters at these N (and 2 at 2500).

Tolerances (f32): 1e-4 abs on logits and features, 1e-5 on attention maps
and on the merged tokens; the trajectory tolerances are in
``test_student_train_step_trajectory_matches_jax``.
"""

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
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    ClusterMergeNet as JClusterMergeNet, StudentNet as JStudentNet,
    StudentsNet as JStudentsNet, TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train import losses as jlosses
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_eval_step, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.models.teacher_student import (
    ClusterMergeNet, StudentNet)
from disentangled_multimodal_learning_tpu_torch.ops import cluster as tcluster
from disentangled_multimodal_learning_tpu_torch.train import losses as tlosses
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils import jax_params

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "config" / "config_mine_diag2021.yaml"
FIXDIM, B, STEPS = 144, 2, 20
LOGITS_TOL, ATTN_TOL = 1e-4, 1e-5
# biases whose gradient is 0 in exact arithmetic (see the trajectory test)
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


def _paths(seed=0, fixdim=FIXDIM):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=(B, fixdim, 1024)).astype(np.float32)
            for k in ("x_path10", "x_path20")}


@pytest.fixture(scope="module")
def jax_student_params():
    x = {k: jnp.asarray(v) for k, v in _paths().items()}
    return JStudentsNet(label_dim=4).init(jax.random.PRNGKey(7), **x)["params"]


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=name)


def test_cluster_merge_net_matches_jax(rng, jax_noise):
    """LayerNorm, exp(score) weights and the DPC merge to 2 tokens, with
    non-trivial norm and score weights."""
    x = rng.normal(size=(B, FIXDIM, 128)).astype(np.float32)
    jnet = JClusterMergeNet(sample_ratio=0.0008, dim_out=128, min_clusters=2)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda v: v + rng.normal(0, 0.1, v.shape).astype(np.float32), params)
    want = jnet.apply({"params": params}, jnp.asarray(x))
    out = {}
    jax_params._ln(params["norm"], "norm", out)
    jax_params._dense(params["score"], "score", out)
    net = ClusterMergeNet(128, 0.0008, min_clusters=2).eval()
    net.load_state_dict({k: _t(v) for k, v in out.items()}, strict=True)
    with torch.no_grad():
        got = net(_t(x))
    assert got.shape == want.shape == (B, 2, 128)
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("model,divisor", [("StudentsNet", 0),
                                           ("StudentsNet", 1),
                                           ("StudentNet", 1)])
def test_students_net_matches_jax(monkeypatch, jax_noise, jax_student_params,
                                  model, divisor):
    _use_jax_divisor(monkeypatch, divisor)
    x = _paths()
    if model == "StudentNet":
        params = jax_student_params["student10_net"]
        jout = JStudentNet(label_dim=4).apply({"params": params},
                                              jnp.asarray(x["x_path10"]))
        sd = {}
        jax_params._student_net(params, "m", sd)
        net = StudentNet(4, cpb_table_divisor=divisor).eval()
        net.load_state_dict({k[2:]: _t(v) for k, v in sd.items()},
                            strict=True)
        with torch.no_grad():
            got = net(_t(x["x_path10"]))
        for name, g, w in zip(("logits", "hazards", "S", "risk", "feature"),
                              got[:5], jout[:5]):
            _close(g, w, LOGITS_TOL, name)
        att = np.asarray(jout[5])
        _close(got[5], att, ATTN_TOL, "att")
        return
    feats, atts, logits, hazards, S, risk = JStudentsNet(label_dim=4).apply(
        {"params": jax_student_params},
        **{k: jnp.asarray(v) for k, v in x.items()})
    cfg = Config(mode="student", fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=divisor).validate()
    net = jax_params.load_jax_params(define_net(cfg, "cpu"),
                                     jax_student_params, "student")
    with torch.no_grad():
        t = net(**{k: _t(v) for k, v in x.items()})
    for want, got in zip((feats, logits, hazards, S, risk),
                         (t[0], t[2], t[3], t[4], t[5])):
        assert set(want) == set(got)
        for k in want:
            _close(got[k], want[k], LOGITS_TOL, k)
    for k, want in atts.items():
        want = np.asarray(want)
        if divisor == 0:  # JAX ran its CPU default "nk" layout
            want = want.swapaxes(-1, -2)
        _close(t[1][k], want, ATTN_TOL, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_path_batch_loss_matches_jax(rng, dtype):
    """JAX's ``[B, H, N, K]`` maps against the port's ``[B, H, K, N]``
    transposes: the contraction over both trailing axes does not see the
    layout.  bf16 maps (the card's streams) are upcast first."""
    maps = [rng.dirichlet(np.ones(9), size=(3, 8, 16)).astype(np.float32)
            for _ in range(2)]
    maps = [_t(m).to(dtype).float().numpy() for m in maps]
    want = jlosses.path_batch_loss(*(jnp.asarray(m) for m in maps))
    got = tlosses.path_batch_loss(*(_t(m.swapaxes(-1, -2)).to(dtype)
                                    for m in maps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    assert got.item() > 0


def test_student_inference_matches_jax_eval_step(monkeypatch, jax_noise,
                                                 jax_student_params):
    """The serving entry in student mode (loader, forward, pad stripping,
    the stu10/stu20/stus metrics) against the JAX eval step over the same
    synthetic fold-0 batches: 3 bags in batches of 2."""
    _use_jax_divisor(monkeypatch, 1)
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    jcfg = jconfig.Config(mode="student", fixdim=FIXDIM, batch_size=B,
                          synthetic_data=True, synthetic_test_size=3,
                          cpb_table_divisor=1).validate()
    jloader = JLoader(JSynthetic(size=3, fixdim=FIXDIM, label_dim=4,
                                 seed=jcfg.seed + 100, args=jcfg), B,
                      shuffle=False, drop_last=False)
    step = make_eval_step(JStudentsNet(label_dim=4), jcfg, "student",
                          need_attention=False)
    want = {}
    for batch in jloader:
        out = step(jax_student_params, None,
                   {k: jnp.asarray(getattr(batch, k))
                    for k in ("x_path10", "x_path20")})
        for k, v in out[2].items():
            want.setdefault(k, []).append(np.asarray(v)[:B - batch.pad])
    cfg = Config(mode="student", fixdim=FIXDIM, batch_size=B,
                 synthetic_data=True, synthetic_test_size=3,
                 cpb_table_divisor=1, debug=True).validate()
    model = jax_params.load_jax_params(define_net(cfg, "cpu"),
                                       jax_student_params, "student")
    metrics, logits = inference.main(cfg, device="cpu", model=model)
    assert set(logits) == {"logits_stu10", "logits_stu20", "logits_stus"}
    for k, v in want.items():
        np.testing.assert_allclose(logits[k], np.concatenate(v),
                                   atol=LOGITS_TOL, rtol=0, err_msg=k)
    assert set(metrics) == {f"{n}_{t}" for n in ("acc", "f1", "auc", "bac",
                                                  "sens", "spec", "prec")
                            for t in ("stu10", "stu20", "stus")}


def test_student_training_entry_runs_with_the_student_loss():
    """The training entry in student mode: ``trainStudentsModel``, the
    ``stus`` headline metrics, the consistency loss logged, all finite."""
    cfg = Config(mode="student", fixdim=64, batch_size=B, synthetic_data=True,
                 synthetic_train_size=4, synthetic_test_size=3, kfold=1,
                 epochs=2, eval_every_iters=3, checkpoints="#",
                 cpb_table_divisor=1).validate()
    logged = []
    results = tmain.main(cfg, device="cpu",
                         logger=types.SimpleNamespace(log=logged.append))
    m = results[0]
    assert len(m["train_losses"]) == 4 and np.isfinite(m["train_losses"]).all()
    assert m["auc"] == m["detail"]["auc_stus"]
    assert {k.rsplit("_", 1)[1] for k in m["detail"]} == {
        "stu10", "stu20", "stus"}
    assert len(logged) == 1
    assert set(logged[0]["training"]) == {"loss", "taskloss", "batchloss"}
    assert logged[0]["training"]["batchloss"] > 0


def test_student_entries_run_from_the_command_line_without_jax():
    """A fresh interpreter runs the serving and training entries with
    ``--mode student --device cpu`` and never loads jax, jaxlib or flax."""
    port = "disentangled_multimodal_learning_tpu_torch"
    code = (
        "import runpy, sys\n"
        "tiny = ['--config', sys.argv[1], '--mode', 'student',"
        " '--synthetic_data', 'true', '--fixdim', '64', '--batch_size', '2',"
        " '--synthetic_test_size', '2', '--device', 'cpu', '--debug']\n"
        "sys.argv = ['inference'] + tiny\n"
        f"runpy.run_module('{port}.inference', run_name='__main__')\n"
        "sys.argv = ['main'] + tiny + ['--checkpoints', '#',"
        " '--synthetic_train_size', '2', '--kfold', '1', '--epochs', '1']\n"
        f"runpy.run_module('{port}.main', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax') if m in sys.modules]\n"
        "print('HEAVY', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(PRESET)],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    assert "acc_stus=" in proc.stdout and "[fold 0] acc=" in proc.stdout


def test_entries_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``define_net``, the serving entry and the training entry default to
    ``cuda`` and raise where there is none, instead of running on the
    CPU; ``--device`` defaults to ``cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(mode="student", fixdim=64, batch_size=B, synthetic_data=True,
                 synthetic_train_size=2, synthetic_test_size=2,
                 kfold=1, epochs=1, checkpoints="#").validate()
    for call in (lambda: define_net(cfg), lambda: inference.main(cfg),
                 lambda: tmain.main(cfg),
                 lambda: define_net(cfg.replace(mode="teacher"), "cuda")):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert Config.from_args([])[1].device == "cuda"
    assert define_net(cfg, "cpu") is not None


@pytest.mark.parametrize("mode", ["teacher", "uniteacher", "student"])
def test_jax_param_name_map_matches_the_jax_exporter(rng, mode):
    """The port's own copy of the name map writes what the JAX package's
    exporter writes, array for array."""
    if mode == "student":
        params = JStudentsNet(label_dim=4).init(
            jax.random.PRNGKey(1), **{k: jnp.asarray(v) for k, v in
                                      _paths(fixdim=64).items()})["params"]
    else:
        x = {k: jnp.asarray(v) for k, v in _paths(fixdim=64).items()}
        x["x_omic_tumor"] = jnp.ones((B, 59))
        x["x_omic_immune"] = jnp.ones((B, 361))
        params = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                              input_size_omic_immune=361,
                              unimodal=mode == "uniteacher").init(
            jax.random.PRNGKey(1), **x)["params"]
    got = jax_params.jax_state_dict(params, mode)
    want = export_torch_state_dict(params, mode)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="student"):
        jax_params.jax_state_dict(params, "bogus")


# ------------------------------------------------- trajectories against JAX

@pytest.fixture(scope="module")
def jax_student_setup():
    """One JAX student init at fixdim 64 with every bias nudged off 0 (a
    zero CPB bias puts the divisor-1 table's centre relu inputs at exactly
    0, where JAX's ``maximum`` splits the gradient and torch's relu gives
    0), and two batches."""
    ds = JSynthetic(size=2 * B, fixdim=64, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    model = JStudentsNet(label_dim=4)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(7), jnp.asarray(batches[0].x_path10),
        jnp.asarray(batches[0].x_path20))["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    return model, params, batches


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("divisor", [0, 1])
def test_student_train_step_trajectory_matches_jax(monkeypatch, jax_noise,
                                                   jax_student_setup,
                                                   divisor):
    """20 AdamW steps (cosine schedule, the task loss on both scales plus
    ``1000 * path_batch_loss``, no gradient modulation) of the port's
    student step and of the JAX student step under
    ``deterministic_training`` (dropout off, JAX's pinned DPC noise on both
    sides), alternating two batches, from the same weights; 2 clusters of
    64 tokens per bag.

    Step 0: the loss within 1e-5 relative, and every parameter's gradient
    within 1e-4 rel-L2 (JAX's read off AdamW's first moment, ``mu = 0.1
    g``), except two biases whose gradient is 0 in exact arithmetic: the
    CPB MLPs' output biases (the softmax over kv ignores a shift) and the
    cluster scores' bias (each cluster's weights are normalized, so a
    common factor ``exp(bias)`` cancels but for the 1e-6 guard).  Both
    sides must hold them below 1e-5 of their weights' gradient.  Then
    every step's loss within 2e-4 relative (the teacher's bound; observed
    at most 8.7e-5), and the final classifiers, cluster scores and CPB
    ``mlp0`` weights within 1e-5 rel-L2.  The
    cluster assignment is discrete: a near-tie that the two frameworks
    broke differently would fork the trajectory, and this test would show
    it as a jump, not as drift."""
    _use_jax_divisor(monkeypatch, divisor)
    jmodel, params, batches = jax_student_setup
    jcfg = jconfig.Config(
        mode="student", task_type="diag2021", label_dim=4, fixdim=64,
        batch_size=B, epochs=STEPS, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, multiscale_attention=True,
        deterministic_training=True, checkpoints="#",
        cpb_table_divisor=divisor).validate()
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
                             state.opt_state[0].mu), "student")
    jax_final = export_torch_state_dict(jax.device_get(state.params),
                                        "student")

    cfg = Config(mode="student", fixdim=64, batch_size=B,
                 cpb_table_divisor=divisor, epochs=STEPS,
                 deterministic_training=True).validate()
    model = jax_params.load_jax_params(define_net(cfg, "cpu"), params,
                                       "student")
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    losses = []
    for k in range(STEPS):
        losses.append(float(step(batch_to_tensors(batches[k % 2], "cpu"))
                            ["loss"]))
        if k == 0:
            assert abs(losses[0] - jax_losses[0]) <= 1e-5 * abs(jax_losses[0])
            for name, p in model.named_parameters():
                want = np.asarray(jax_grads[name])
                if name.endswith(ZERO_GRAD_BIASES):
                    w = model.get_parameter(name[:-4] + "weight").grad
                    floor = 1e-5 * w.abs().max().item()
                    assert p.grad.abs().max().item() <= floor, name
                    assert np.abs(want).max() <= floor, name
                    continue
                assert _rel_l2(p.grad, want) <= 1e-4, name
    for k, (a, b) in enumerate(zip(losses, jax_losses)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (k, a, b)
    sd = model.state_dict()
    for name in ("student10_net.classifier.weight",
                 "student20_net.classifier.weight",
                 "student10_net.encoder.cluster_merge.score.weight",
                 "student10_net.encoder.attn2d.rel_pos_bias.mlp.0.0.weight"):
        assert _rel_l2(sd[name], jax_final[name]) <= 1e-5, name

"""The port's multiscale model (a teacher and a student per magnification,
``MultiScaleNet``) against the JAX package on the CPU: the forward's five
tag sets of logits and its six attention maps on the same weights (through
``load_jax_params``), a 3-step ``deterministic_training`` trajectory of the
multiscale train step against JAX's (loss and its parts, gradients), the
name map against JAX's exporter and a reference-named state_dict with the
dead ``fusion.fusion_layer`` keys, and the entries on one fold.

No 20-step trajectory: the teacher's and the student's trajectory tests
(``tests/test_torch_train.py``, ``tests/test_torch_student.py``) already
hold every module the multiscale model composes; this file holds the
composition.  As there, the student's DPC noise is JAX's eval-time draw on
both sides (``jax_noise``), every bias is nudged off 0, and the JAX
attention layout is forced to "kn", the port's (on the CPU JAX's "auto"
is "nk", which never takes the table CPB).  fixdim 64, B = 2, the
real widths.

Tolerances (f32): logits 1e-4 abs, attention maps 1e-5 abs (the teacher's
and the student's tests'); step 0's task loss 1e-5 relative, its
``batchloss`` ``BATCHLOSS_TOL`` relative and the loss 1e-5 relative plus
that; every gradient 1e-4 rel-L2, the two biases whose gradient is 0 in exact arithmetic below 1e-5
of their weights'; each step's loss 2e-4 relative.  The served logits
against the training run's final evaluation: bitwise.
"""

import glob
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
    MultiScaleNet as JMultiScaleNet)
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu.utils.torch_import import (
    import_torch_checkpoint)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.ops import cluster as tcluster
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils import jax_params
from disentangled_multimodal_learning_tpu_torch.utils.checkpoint import (
    restore_state)

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "config" / "config_mine_diag2021.yaml"
FIXDIM, B, STEPS = 64, 2, 3
LOGITS_TOL, MAP_TOL = 1e-4, 1e-5
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias")
# ``omic_domain_scale_loss`` is 1e4 x the variance of a Gram diagonal whose
# entries nearly agree, so f32 rounding of the Gram cancels: on step 0's
# maps JAX's f32 value sits 1.5e-4 relative off the float64 value of the
# same maps, the port's 3e-6 (measured); the maps themselves agree within
# 1.4e-6.  5e-4 keeps a margin over JAX's error.
BATCHLOSS_TOL = 5e-4
TAGS = ("tea10", "tea20", "stu10", "stu20", "stus")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: under the suite's parallel
    workers a pool of one thread per core oversubscribes the CPU, and these
    small models' steps (~1,000 ops each) then wait at every op's barrier
    (measured: the real-data fold tests 40-100x slower than alone)."""
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
    monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX ``MultiScaleNet`` init at fixdim 64 (biases nudged off 0) and
    two batches."""
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    arrays = batch_to_arrays(batches[0])
    model = JMultiScaleNet(label_dim=4, input_size_omic_tumor=59,
                           input_size_omic_immune=361)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(5), arrays["x_path10"], arrays["x_path20"],
        arrays["x_omic_tumor"], arrays["x_omic_immune"])["params"]
    r = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    return model, params, batches


def _cfg(divisor, **kw):
    kw = {"epochs": STEPS, **kw}
    return Config(mode="multiscale", fixdim=FIXDIM, batch_size=B,
                  cpb_table_divisor=divisor, **kw).validate()


def _port_net(cfg, params):
    return jax_params.load_jax_params(define_net(cfg, "cpu"), params,
                                      "multiscale")


@pytest.mark.parametrize("divisor", [0, 1])
def test_multiscale_forward_matches_jax(monkeypatch, jax_noise, jax_setup,
                                        divisor):
    """The eval forward on the same weights and bags: the six dicts in
    JAX's keys and order, the logits of all five tags within 1e-4, the
    four teacher maps and the two student maps within 1e-5."""
    _use_jax_divisor(monkeypatch, divisor)
    jmodel, params, batches = jax_setup
    arrays = batch_to_arrays(batches[0])
    want = jax.jit(jmodel.apply)(
        {"params": params}, arrays["x_path10"], arrays["x_path20"],
        arrays["x_omic_tumor"], arrays["x_omic_immune"])
    model = _port_net(_cfg(divisor), params)
    with torch.no_grad():
        got = model(**{k: v for k, v in batch_to_tensors(batches[0],
                                                         "cpu").items()
                       if k not in ("x_omic", "label")})
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):  # jit returns JAX's dicts keys sorted
        assert set(g) == set(w)
    # JAX's key order (teacher_student.py:362-382)
    assert list(got[0]) == ["feature1_tea10", "feature2_tea10",
                            "feature1_tea20", "feature2_tea20",
                            "feature_stu10", "feature_stu20"]
    assert list(got[1]) == ["att1_tea10", "att2_tea10", "att1_tea20",
                            "att2_tea20", "att_stu10", "att_stu20"]
    for i, name in enumerate(("logits", "hazards", "S", "risk"), start=2):
        assert list(got[i]) == [f"{name}_{t}" for t in TAGS]
    for k, w in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(w),
                                   atol=LOGITS_TOL, rtol=0, err_msg=k)
    for k, w in want[1].items():
        assert got[1][k].shape == w.shape, k
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(w),
                                   atol=MAP_TOL, rtol=0, err_msg=k)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_multiscale_train_step_trajectory_matches_jax(monkeypatch, jax_noise,
                                                      jax_setup):
    """3 AdamW steps (cosine schedule, ``deterministic_training``,
    ``multiscale_attention``, alternating two batches) of the port's
    multiscale step and JAX's at the preset's divisor 1: step 0's loss,
    task loss and ``batchloss``, every gradient (JAX's read off AdamW's
    first moment), then each step's loss, as stated in the module
    docstring; the MaxNets' classifiers, which no loss reaches, get a zero
    gradient on both sides."""
    _use_jax_divisor(monkeypatch, 1)
    jmodel, params, batches = jax_setup
    jcfg = jconfig.Config(
        mode="multiscale", task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=STEPS, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, multiscale_attention=True,
        deterministic_training=True, checkpoints="#",
        cpb_table_divisor=1).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jmodel, jcfg, tx))
    jax_losses = []
    for k in range(STEPS):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_m0 = {n: float(v) for n, v in m.items()}
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "multiscale")

    cfg = _cfg(1, deterministic_training=True)
    model = _port_net(cfg, params)
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    losses = []
    for k in range(STEPS):
        m = step(batch_to_tensors(batches[k % 2], "cpu"))
        losses.append(float(m["loss"]))
        if k > 0:
            continue
        assert set(m) == set(jax_m0) == {"loss", "taskloss", "batchloss"}
        bl_tol = BATCHLOSS_TOL * abs(jax_m0["batchloss"])
        tols = {"taskloss": 1e-5 * abs(jax_m0["taskloss"]),
                "batchloss": bl_tol,
                "loss": 1e-5 * abs(jax_m0["loss"]) + bl_tol}
        for n, v in jax_m0.items():
            assert abs(float(m[n]) - v) <= tols[n], (n, float(m[n]), v)
        assert set(dict(model.named_parameters())) == set(jax_grads)
        for name, p in model.named_parameters():
            if name.endswith(ZERO_GRAD_BIASES):
                w = model.get_parameter(name[:-4] + "weight").grad
                floor = 1e-5 * w.abs().max().item()
                assert p.grad.abs().max().item() <= floor, name
                assert np.abs(jax_grads[name]).max() <= floor, name
            elif name.endswith("classifier.0.weight"):  # a MaxNet's
                assert not p.grad.any() and not jax_grads[name].any(), name
            else:
                assert _rel_l2(p.grad, jax_grads[name]) <= 1e-4, name
    for k, (a, b) in enumerate(zip(losses, jax_losses)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (k, a, b)


def test_name_map_and_reference_state_dict_load(tmp_path, jax_setup):
    """The port's multiscale name map equals JAX's exporter; a
    reference-named ``.pth`` carrying the reference MultiScaleNet's dead
    ``fusion.fusion_layer`` keys loads strictly but for those (which JAX's
    importer skips too), giving the JAX weights; a key the model lacks
    under any other name still fails; JAX's ``stacked_scales`` tree of the
    same weights maps to the same state_dict."""
    _, params, _ = jax_setup
    got = jax_params.jax_state_dict(params, "multiscale")
    want = export_torch_state_dict(params, "multiscale")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in got.items()}
    sd["fusion.fusion_layer.weight"] = torch.zeros(128, 256)
    sd["fusion.fusion_layer.bias"] = torch.zeros(128)
    import_torch_checkpoint(sd, mode="multiscale")  # JAX's importer
    path = str(tmp_path / "multiscale.pth")
    torch.save(sd, path)
    model = define_net(_cfg(1), "cpu")
    restore_state(model, None, None, path)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
    sd["scale10_net.extra.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="scale10_net.extra.weight"):
        restore_state(model, None, None, path)
    # JAX's stacked_scales layout of the same tree (scale_nets, leading
    # axis 2) maps to the same state_dict
    stacked = jax_params.stack_scale_params(jax.device_get(params))
    assert set(stacked) == {"scale_nets"}
    for k, v in jax_params.jax_state_dict(stacked, "multiscale").items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def test_multiscale_entries_run_one_fold_and_serve_its_checkpoint(tmp_path):
    """The training entry on one synthetic fold (2 steps) writes a
    metric-stamped checkpoint whose name carries the combined student's
    metrics, reports all five tags, and the serving entry restored from it
    gives the final evaluation's logits bitwise."""
    cfg = _cfg(1, synthetic_data=True, synthetic_train_size=4,
               synthetic_test_size=3, kfold=1, epochs=1,
               checkpoints=str(tmp_path), debug=True)
    final = tmain.main(cfg, device="cpu")[0]
    assert set(final["detail"]) == {f"{n}_{t}" for n in (
        "acc", "f1", "auc", "bac", "sens", "spec", "prec") for t in TAGS}
    assert final["auc"] == final["detail"]["auc_stus"]
    assert len(final["train_losses"]) == 2
    assert all(np.isfinite(final["train_losses"]))
    ckpt, = glob.glob(str(tmp_path / "multiscale_fold_1_epoch_1_AUC_*.pt"))
    assert f"AUC_{final['auc']:f}_ACC_{final['acc']:f}_" in ckpt
    metrics, logits = inference.main(cfg.replace(checkpoints_student=ckpt),
                                     device="cpu")
    assert set(logits) == {f"logits_{t}" for t in TAGS}
    assert len(metrics) == 7 * 5
    for k in logits:
        np.testing.assert_array_equal(logits[k], final["logits"][k])


def test_multiscale_entry_runs_from_the_command_line_without_jax(tmp_path):
    """``--mode multiscale`` through ``python -m ...main`` in a fresh
    interpreter trains one fold and loads no JAX module."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['main', '--config', sys.argv[1], '--mode', 'multiscale',"
        " '--synthetic_data', 'true', '--fixdim', '64', '--batch_size', '2',"
        " '--synthetic_train_size', '2', '--synthetic_test_size', '2',"
        " '--kfold', '1', '--epochs', '1', '--device', 'cpu',"
        " '--checkpoints', '#', '--debug']\n"
        "runpy.run_module('disentangled_multimodal_learning_tpu_torch.main',"
        " run_name='__main__')\n"
        "print('HEAVY', [m for m in ('jax', 'jaxlib', 'flax', 'pandas')"
        " if m in sys.modules])\n")
    proc = subprocess.run([sys.executable, "-c", code, str(PRESET)],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   OMP_NUM_THREADS="1"),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    assert "[fold 0]" in proc.stdout and "auc=" in proc.stdout

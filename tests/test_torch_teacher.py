"""The port's teacher serving path against the JAX package on the CPU: the
whole two-scale ``TeachersNet`` through ``load_jax_params``, the inference
entry against the JAX eval step, and the config, data, loader and metrics
it runs on.  fixdim 144 (a 12x12 grid, K = 9 deformed kv points), B = 2,
the real widths (1024-d patches, omics 59/361, dims 128, 8 heads).

JAX's ``define_net`` sets module globals; these tests set them only through
``monkeypatch``, so nothing leaks into later tests on the same worker.

Tolerances (f32): 1e-4 abs on whole-model logits and features, 1e-5 on
attention maps.
"""

import dataclasses
import os
import re
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
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train import metrics as jmetrics
from disentangled_multimodal_learning_tpu.train.steps import make_eval_step
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    save_torch_checkpoint)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.train import metrics as tmetrics
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "config" / "config_mine_diag2021.yaml"
FIXDIM, B = 144, 2
LOGITS_TOL = 1e-4
ATTN_TOL = 1e-5


def _jax_teacher(unimodal=False):
    return JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                        input_size_omic_immune=361, unimodal=unimodal)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x_path10=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_path20=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_omic_tumor=r.normal(size=(B, 59)).astype(np.float32),
        x_omic_immune=r.normal(size=(B, 361)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    """One JAX init per mode (the param tree does not depend on the CPB
    divisor or the attention layout)."""
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    return {u: _jax_teacher(u).init(jax.random.PRNGKey(7), **x)["params"]
            for u in (False, True)}


def _use_jax_divisor(monkeypatch, divisor):
    """Divisor 1 needs the kn layout in JAX: on the CPU "auto" resolves to
    nk, and nk never takes the table path, so JAX would silently compute
    the exact CPB."""
    monkeypatch.setattr(jda, "CPB_TABLE_DIVISOR", divisor)
    if divisor == 1:
        monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")


def _port(mode, divisor, params):
    cfg = Config(mode=mode, fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=divisor).validate()
    return cfg, load_jax_params(define_net(cfg, "cpu"), params, mode)


@pytest.mark.parametrize("mode,divisor", [("teacher", 0), ("teacher", 1),
                                          ("uniteacher", 1)])
def test_teachers_net_matches_jax(monkeypatch, jax_params, mode, divisor):
    _use_jax_divisor(monkeypatch, divisor)
    unimodal = mode == "uniteacher"
    x = _inputs()
    feats, atts, logits, hazards, S, risk = _jax_teacher(unimodal).apply(
        {"params": jax_params[unimodal]},
        **{k: jnp.asarray(v) for k, v in x.items()})
    _, model = _port(mode, divisor, jax_params[unimodal])
    with torch.no_grad():
        t = model(**{k: torch.from_numpy(v) for k, v in x.items()})
    for want, got in zip((feats, logits, hazards, S, risk),
                         (t[0], t[2], t[3], t[4], t[5])):
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=LOGITS_TOL, rtol=0, err_msg=k)
    for k, want in atts.items():
        want = np.asarray(want)
        if divisor == 0:  # JAX ran its CPU default "nk" layout
            want = want.swapaxes(-1, -2)
        np.testing.assert_allclose(t[1][k].numpy(), want, atol=ATTN_TOL,
                                   rtol=0, err_msg=k)


def _hide_sklearn(monkeypatch):
    """JAX's compute_avg_metrics takes sklearn when it imports; the port
    ports its numpy branch."""
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)


def test_inference_matches_jax_eval_step(monkeypatch, jax_params, tmp_path):
    """The port's entry (loader, forward, pad stripping, metrics) against
    the JAX eval step (``need_attention=False``) over the same synthetic
    fold-0 batches with the same weights: 3 bags in batches of 2, so the
    last batch is padded.  Also loads the same weights from a
    reference-named ``.pth`` (``save_torch_checkpoint``)."""
    _use_jax_divisor(monkeypatch, 1)
    _hide_sklearn(monkeypatch)
    jcfg = jconfig.Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                          synthetic_data=True, synthetic_test_size=3,
                          cpb_table_divisor=1).validate()
    jloader = JLoader(JSynthetic(size=3, fixdim=FIXDIM, label_dim=4,
                                 seed=jcfg.seed + 100, args=jcfg), B,
                      shuffle=False, drop_last=False)
    step = make_eval_step(_jax_teacher(), jcfg, "teacher",
                          need_attention=False)
    state = types.SimpleNamespace(params=jax_params[False], batch_stats=None)
    want, labels = {}, []
    for batch in jloader:
        out = step(state.params, None,
                   {k: jnp.asarray(getattr(batch, k)) for k in
                    ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")})
        assert out[1] == {}
        keep = B - batch.pad
        for k, v in out[2].items():
            want.setdefault(k, []).append(np.asarray(v)[:keep])
        labels.append(batch.label[:keep])
    want = {k: np.concatenate(v) for k, v in want.items()}
    y = np.concatenate(labels)[:, 5]

    cfg, model = _port("teacher", 1, jax_params[False])
    cfg = cfg.replace(synthetic_data=True, synthetic_test_size=3, debug=True)
    metrics, logits = inference.main(cfg, device="cpu", model=model)
    assert set(logits) == set(want)
    for k in want:
        assert logits[k].shape == (3, 4)
        np.testing.assert_allclose(logits[k], want[k], atol=LOGITS_TOL,
                                   rtol=0, err_msg=k)
    names = ("acc", "f1", "auc", "bac", "sens", "spec", "prec")
    assert len(metrics) == 21
    for tag in ("tea10", "tea20", "teas"):
        p = np.exp(logits[f"logits_{tag}"])
        p /= p.sum(-1, keepdims=True)
        for n, v in zip(names, jmetrics.compute_avg_metrics(y, p)):
            assert metrics[f"{n}_{tag}"] == pytest.approx(v, nan_ok=True)

    ckpt = str(tmp_path / "teacher.pth")
    save_torch_checkpoint(jax_params[False], "teacher", ckpt)
    _, from_pth = inference.main(cfg, checkpoint=ckpt, device="cpu")
    for k in logits:
        np.testing.assert_array_equal(from_pth[k], logits[k])


def test_inference_refuses_real_data_until_ported(tmp_path):
    """Asked for a cohort directory that is not there, the serving entry
    raises, naming the path, instead of evaluating synthetic bags (JAX
    falls back to them)."""
    missing = str(tmp_path / "no_cohorts")
    for external in (False, True):
        with pytest.raises(FileNotFoundError, match=re.escape(missing)):
            inference.build_fold0_test_loader(Config(
                fixdim=64, dataDir=missing, external_eval=external))


def test_define_net_refuses_unported_modes():
    """Every mode of the JAX factory is ported (the baselines too): a mode
    it does not know raises as JAX's does; TransMIL with its token axis
    sharded over ranks builds the plain TransMIL (the sharding is a layout
    of the train step, ``parallel/seq_shard.py``)."""
    with pytest.raises(NotImplementedError, match=r"model \[bogus\]"):
        define_net(Config(mode="bogus"), "cpu")
    cfg = Config.from_dict({"mode": "transmil", "seq_shard_devices": 2,
                            "fixdim": 64})
    assert type(define_net(cfg, "cpu")).__name__ == "TransMIL"


def test_seeded_init_is_reproducible_and_finite():
    cfg = Config(fixdim=64, cpb_table_divisor=1).validate()
    a, b = define_net(cfg, "cpu"), define_net(cfg, "cpu")
    c = define_net(cfg.replace(seed=cfg.seed + 1), "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["teacher10_net._fc1.0.weight"],
                           sc["teacher10_net._fc1.0.weight"])
    assert torch.equal(sa["teacher10_net.norm.weight"], torch.ones(128))
    assert not a.training


FIELDS = [f for f in Config.__dataclass_fields__]


def test_diag2021_preset_matches_the_yaml_on_shared_fields():
    want = jconfig.Config.from_yaml(str(PRESET))
    got = Config.diag2021()
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert Config.from_yaml(str(PRESET)) == got


def test_from_args_overrides_and_defaults_to_the_preset():
    cfg, args = Config.from_args(["--config", str(PRESET), "--synthetic_data",
                                  "true", "--fixdim", "144",
                                  "--checkpoint", "t.pth", "--device", "cpu"])
    assert cfg.synthetic_data is True and cfg.fixdim == 144
    assert cfg.cpb_table_divisor == 1 and cfg.attn_bf16_streams is True
    assert (args.checkpoint, args.device) == ("t.pth", "cpu")
    cfg, args = Config.from_args([])
    assert cfg == Config.diag2021() and args.checkpoint is None
    with pytest.raises(ValueError, match="perfect square"):
        Config(fixdim=50).validate()
    assert Config(task_type="grade", label_dim=4).validate().label_dim == 3


def test_yaml_includes_win_as_in_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "inc.yaml").write_text("fixdim: 400\nseed: 3\n")
    top = tmp_path / "top.yaml"
    top.write_text("defaults:\n  - sub: inc\nfixdim: 900\nbatch_size: 8\n")
    from disentangled_multimodal_learning_tpu_torch.config import (
        yaml_config_hook)

    assert yaml_config_hook(str(top)) == jconfig.yaml_config_hook(str(top))
    cfg = Config.from_yaml(str(top))
    assert (cfg.fixdim, cfg.seed, cfg.batch_size) == (400, 3, 8)


@pytest.mark.parametrize("preset", sorted(
    p.name for p in (REPO / "config").glob("*.yaml")))
def test_every_yaml_preset_loads(preset):
    """Every YAML under ``config/`` loads: each of its keys is a port field,
    a key the port ignores on purpose, or a key ported later that it leaves
    at JAX's default (``config_synthetic_smoke.yaml``'s ``debug: true``
    is logging only)."""
    cfg = Config.from_yaml(str(REPO / "config" / preset)).validate()
    want = jconfig.Config.from_yaml(str(REPO / "config" / preset))
    for f in dataclasses.fields(Config):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name


def test_config_refuses_later_and_unknown_keys():
    """No key is left for a later part of the port (``LATER`` is empty
    since the parallel part: its keys load at any value); a key that
    neither the port nor the JAX ``Config`` knows raises ``ValueError``
    (JAX would keep it in ``cfg._extra``, where its ``define_net`` may read
    it)."""
    from disentangled_multimodal_learning_tpu_torch import config as tconfig

    assert tconfig.LATER == {}
    assert Config.from_dict({"seq_shard_devices": 4}).seq_shard_devices == 4
    assert Config.from_dict({"seq_shard_dp": 2}).seq_shard_dp == 2
    assert Config.from_dict({"init_type": "xavier", "skip": 1}).skip == 1
    with pytest.raises(ValueError, match="unknown config key 'fixdimm'"):
        Config.from_dict({"fixdimm": 64})
    cfg = Config.from_dict({"seq_shard_devices": 0, "debug": True,
                            "remat": False,
                            "image_size": [224, 224], "fixdim": 64,
                            "dataDir": "/data/", "coTraining": False})
    assert (cfg.fixdim, cfg.dataDir, cfg.coTraining) == (64, "/data/", False)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_scan_steps_above_one_is_refused(k):
    """``scan_steps`` is a field at JAX's default, read as ``max(1, K)``,
    and no K is refused any more: ``validate`` and both entries' command
    lines take each and keep it (K <= 1, one update a batch; K > 1, JAX's
    chunked order, ``tests/test_torch_scan_steps.py``)."""
    assert Config.from_dict({"scan_steps": k}).validate().scan_steps == k
    assert Config.from_args(["--scan_steps", str(k)])[0].scan_steps == k


def test_every_jax_config_field_is_ported_or_in_one_table():
    """Each field of the JAX ``Config`` is a field of the port's, or sits in
    exactly one of its tables; each LATER entry holds JAX's default."""
    from disentangled_multimodal_learning_tpu_torch import config as tconfig

    port = {f.name for f in dataclasses.fields(Config)}
    jax_fields = {f.name: f for f in dataclasses.fields(jconfig.Config)}
    for name, f in jax_fields.items():
        where = [name in port, name in tconfig.IGNORED, name in tconfig.LATER]
        assert sum(where) == 1, (name, where)
        if name in tconfig.LATER:
            assert tconfig.LATER[name][0] == f.default, name
    assert set(tconfig.IGNORED) | set(tconfig.LATER) <= set(jax_fields)
    # scan_steps is a field at JAX's default; the keys JAX reads nowhere
    # say so, and remat says why the port needs no recompute
    assert Config().scan_steps == jax_fields["scan_steps"].default == 1
    for name in ("use_pallas", "mesh_data_axis", "compute_dtype"):
        assert tconfig.IGNORED[name].startswith(
            "the JAX package reads it nowhere"), name
    assert "CPB_REMAT" in tconfig.IGNORED["remat"]


def test_synthetic_data_matches_jax():
    kw = dict(size=5, fixdim=16, path_dim=8, omic_dim=40, omic_tumor_dim=7,
              omic_immune_dim=30, label_dim=3, seed=11)
    got, want = SyntheticBagDataset(**kw), JSynthetic(**kw)
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    gb, wb = got.batch([4, 0, 4]), want.batch([4, 0, 4])
    for f in ("x_path10", "x_path20", "x_omic", "x_omic_tumor",
              "x_omic_immune", "label"):
        np.testing.assert_array_equal(getattr(gb, f), getattr(wb, f))


def test_loader_pads_the_last_batch_as_jax():
    ds = SyntheticBagDataset(size=5, fixdim=4, path_dim=2, seed=1)
    jds = JSynthetic(size=5, fixdim=4, path_dim=2, seed=1)
    got = list(BagLoader(ds, 2))
    want = list(JLoader(jds, 2, shuffle=False, drop_last=False))
    assert len(got) == len(BagLoader(ds, 2)) == len(want) == 3
    assert [b.pad for b in got] == [b.pad for b in want] == [0, 0, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x_path10, w.x_path10)
        np.testing.assert_array_equal(g.label, w.label)
    np.testing.assert_array_equal(got[-1].label[0], got[-1].label[1])


@pytest.mark.parametrize("case", range(4))
def test_metrics_match_jax_numpy_branch(monkeypatch, case):
    _hide_sklearn(monkeypatch)
    r = np.random.default_rng(case)
    n = 12 + case
    y = r.integers(0, 4 - (case % 2), size=n)  # odd cases miss a class
    probs = r.dirichlet(np.ones(4), size=n)
    if case == 3:
        probs[:4] = probs[4]  # ties
    got = tmetrics.compute_avg_metrics(y, probs)
    want = jmetrics.compute_avg_metrics(y, probs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_port_runs_without_jax_or_flax():
    """A fresh interpreter imports the training modules, runs the inference
    entry and the training entry on the CPU (tiny synthetic config) and
    never loads jax, jaxlib or flax."""
    port = "disentangled_multimodal_learning_tpu_torch"
    code = (
        "import importlib, runpy, sys\n"
        f"for m in ('train.losses', 'train.grad_modulate', 'train.optim',"
        " 'train.steps', 'train.trainers', 'main'):\n"
        f"    importlib.import_module('{port}.' + m)\n"
        "tiny = ['--config', sys.argv[1], '--synthetic_data', 'true',"
        " '--fixdim', '64', '--batch_size', '2', '--synthetic_test_size', '3',"
        " '--device', 'cpu', '--debug']\n"
        "sys.argv = ['inference'] + tiny\n"
        f"runpy.run_module('{port}.inference', run_name='__main__')\n"
        "sys.argv = ['main'] + tiny + ['--checkpoints', '#',"
        " '--synthetic_train_size', '2', '--kfold', '1', '--epochs', '1']\n"
        f"runpy.run_module('{port}.main', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax') if m in sys.modules]\n"
        "print('HEAVY', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(PRESET)],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    assert "acc_teas=" in proc.stdout and "prec_tea10=" in proc.stdout
    assert "[fold 0] acc=" in proc.stdout

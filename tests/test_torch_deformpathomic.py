"""The port's deformpathomic family against the JAX package on the CPU:
``DeformCrossAttention1D`` (exact and table CPB, both samplers),
``DeformCrossAttention2D`` with ``return_vgrid``, ``DeformCrossTransMIL``
and ``DeformPathomicNet`` through ``load_jax_params`` at ``attn_dim`` 1 and
2, ``batch_loss_vgrid``, the port's JAX name map against the JAX exporter,
the fused evaluation against JAX ``fused_val``, both entries, and 20-step
trajectories of the deformpathomic train step against the JAX step.

At a table divisor the JAX attention layout is forced to "kn" (on the CPU
"auto" means "nk", where the 1-D and 2-D CPBs never take the table).

Sizes: fixdim 64 (B=2, the real widths: 1024-d patches, dims 128, 8 heads;
at ``attn_dim`` 1 the cls token makes N = 65 and the offset conv K = 16 kv
points, at ``attn_dim`` 2 an 8x8 grid and K = 4).

Tolerances (f32): 1e-5 abs on the attention modules' outputs, 1e-4 abs on
the models' logits, features and vgrids, 1e-6 relative on
``batch_loss_vgrid``; the trajectory tolerances are in
``test_deformpathomic_train_step_trajectory_matches_jax``.
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
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.deform_mil import (
    DeformCrossTransMIL as JDeformCrossTransMIL,
    DeformPathomicNet as JDeformPathomicNet)
from disentangled_multimodal_learning_tpu.train import losses as jlosses
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.evaluation import (
    Evaluator as JEvaluator)
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention1D, DeformCrossAttention2D)
from disentangled_multimodal_learning_tpu_torch.models.deform_mil import (
    DeformCrossTransMIL)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.train import losses as tlosses
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    Evaluator)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils import jax_params

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "config" / "config_mine_diag2021.yaml"
FIXDIM, B, STEPS = 64, 2, 20
MODULE_TOL, LOGITS_TOL = 1e-5, 1e-4


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


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=name)


def _use_jax_divisor(monkeypatch, divisor):
    monkeypatch.setattr(jda, "CPB_TABLE_DIVISOR", divisor)
    if divisor > 0:
        monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")


def _load(module, export, params, *args):
    """Export one JAX module's params under the prefix ``m`` and load them
    strictly."""
    out = {}
    export(params, "m", out, *args)
    module.load_state_dict({k[2:]: _t(v) for k, v in out.items()},
                           strict=True)
    return module.eval()


def _inputs(seed=0, n=FIXDIM):
    r = np.random.default_rng(seed)
    return dict(x_path=r.normal(size=(B, n, 1024)).astype(np.float32),
                x_omic=r.normal(size=(B, 431)).astype(np.float32),
                x_omic_tumor=r.normal(size=(B, 59)).astype(np.float32),
                x_omic_immune=r.normal(size=(B, 361)).astype(np.float32))


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("divisor", [0, 1, 2])
def test_deform_cross_attention_1d_matches_jax(rng, divisor, degenerate):
    """The 1-D deformable attention: the exact CPB (K2's plain version, the
    coordinate padded to 2) at divisor 0, the 1-D table CPB (K4's plain
    version) at 1 and at 2 (the 1-D lattice has the query spacing at every
    divisor); the corrected sampler and the reference's degenerate one.
    N = 65 tokens (a cls token and 64), K = 16 deformed kv points."""
    N, C = FIXDIM + 1, 128
    x1 = rng.normal(size=(B, N, C)).astype(np.float32)
    x2 = rng.normal(size=(B, N, C)).astype(np.float32)
    jm = jda.DeformCrossAttention1D(
        dim=C, downsample_factor=4, offset_scale=2, offset_kernel_size=6,
        degenerate_sampling=degenerate, attn_layout="kn",
        cpb_table_divisor=divisor)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x1),
                     jnp.asarray(x2))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x1), jnp.asarray(x2))
    tm = _load(DeformCrossAttention1D(C, degenerate_sampling=degenerate,
                                      cpb_table_divisor=divisor),
               jax_params._attn1d, params)
    with torch.no_grad():
        out = tm(_t(x1), _t(x2))
    assert out.shape == (B, N, C)
    _close(out, want, MODULE_TOL)


@pytest.mark.parametrize("divisor", [0, 1])
def test_deform_cross_attention_2d_returns_the_vgrid_as_jax(rng, divisor):
    """``return_vgrid`` gives the unnormalized ``[B*G, 2, gh, gw]`` grid."""
    N, C = 144, 128
    x1 = rng.normal(size=(B, N, C)).astype(np.float32)
    x2 = rng.normal(size=(B, N, C)).astype(np.float32)
    jm = jda.DeformCrossAttention2D(dim=C, attn_layout="kn",
                                    cpb_table_divisor=divisor)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x1),
                     jnp.asarray(x2))["params"]
    want, want_vgrid = jm.apply({"params": params}, jnp.asarray(x1),
                                jnp.asarray(x2), return_vgrid=True)
    tm = _load(DeformCrossAttention2D(C, cpb_table_divisor=divisor),
               jax_params._attn2d, params)
    with torch.no_grad():
        out, vgrid = tm(_t(x1), _t(x2), return_vgrid=True)
    assert vgrid.shape == want_vgrid.shape == (B * 8, 2, 3, 3)
    _close(out, want, MODULE_TOL)
    _close(vgrid, want_vgrid, MODULE_TOL)


@pytest.mark.parametrize("attn_dim,return_vgrid", [(1, False), (2, False),
                                                   (2, True)])
def test_deform_cross_trans_mil_matches_jax(monkeypatch, attn_dim,
                                            return_vgrid):
    """One branch at divisor 1: encoded vector and logits (and the
    broadcast omic and the vgrid with ``return_vgrid``)."""
    _use_jax_divisor(monkeypatch, 1)
    x = _inputs()
    omic = np.random.default_rng(1).normal(size=(B, 128)).astype(np.float32)
    jm = JDeformCrossTransMIL(label_dim=4, attn_dim=attn_dim,
                              return_vgrid=return_vgrid)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x["x_path"]),
                     jnp.asarray(omic))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x["x_path"]),
                    jnp.asarray(omic))
    tm = _load(DeformCrossTransMIL(attn_dim=attn_dim,
                                   return_vgrid=return_vgrid,
                                   cpb_table_divisor=1),
               jax_params._deform_mil, params, attn_dim)
    with torch.no_grad():
        got = tm(_t(x["x_path"]), _t(omic))
    assert len(got) == len(want) == (5 if return_vgrid else 3)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        _close(g, w, LOGITS_TOL, f"output {i}")


@pytest.fixture(scope="module")
def jax_models():
    """JAX DeformPathomicNet params at attn_dim 1 and 2 (the 2-D tree does
    not depend on ``return_vgrid``)."""
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    out = {}
    for attn_dim in (1, 2):
        model = JDeformPathomicNet(label_dim=4, input_size_omic_tumor=59,
                                   input_size_omic_immune=361,
                                   attn_dim=attn_dim)
        out[attn_dim] = model.init(jax.random.PRNGKey(3), **x)["params"]
    return out


@pytest.mark.parametrize("attn_dim,return_vgrid,divisor,task", [
    (1, False, 1, "diag2021"), (1, False, 0, "diag2021"),
    (2, False, 1, "diag2021"), (2, True, 1, "diag2021"),
    (2, True, 0, "diag2021"), (1, False, 1, "survival")])
def test_deformpathomic_net_matches_jax(monkeypatch, jax_models, attn_dim,
                                        return_vgrid, divisor, task):
    """The whole model from the same weights (``load_jax_params``, strict):
    features, both branch vectors and every entry of the logits list (the
    sigmoid outputs on survival; with ``return_vgrid`` the broadcast omics
    and vgrids too)."""
    _use_jax_divisor(monkeypatch, divisor)
    params = jax_models[attn_dim]
    x = _inputs(seed=4)
    jm = JDeformPathomicNet(label_dim=4, input_size_omic_tumor=59,
                            input_size_omic_immune=361, attn_dim=attn_dim,
                            return_vgrid=return_vgrid, task_type=task)
    want = jm.apply({"params": params}, **{k: jnp.asarray(v)
                                           for k, v in x.items()})
    cfg = Config(mode="deformpathomic", task_type=task, fixdim=FIXDIM,
                 batch_size=B, attn_dim=attn_dim, return_vgrid=return_vgrid,
                 cpb_table_divisor=divisor).validate()
    model = jax_params.load_jax_params(define_net(cfg, "cpu"), params,
                                       "deformpathomic", attn_dim)
    with torch.no_grad():
        got = model(**{k: _t(v) for k, v in x.items()})
    for i in range(3):
        _close(got[i], want[i], LOGITS_TOL, f"output {i}")
    assert len(got[3]) == len(want[3]) == (7 if return_vgrid else 3)
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        _close(g, w, LOGITS_TOL, f"logits[{i}]")
    if task == "survival":
        assert all(((h > 0) & (h < 1)).all() for h in got[3][:3])


@pytest.mark.parametrize("attn_dim", [1, 2])
def test_deformpathomic_name_map_matches_the_jax_exporter(jax_models,
                                                          attn_dim):
    """The port's name map writes what ``export_torch_state_dict(params,
    "deformpathomic", attn_dim)`` writes, array for array, and it loads
    into the port's model with ``strict=True`` (the cls token at attn_dim
    1, the Pooler at 2, the reference's constant buffers)."""
    params = jax_models[attn_dim]
    got = jax_params.jax_state_dict(params, "deformpathomic", attn_dim)
    want = export_torch_state_dict(params, "deformpathomic", attn_dim)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = Config(mode="deformpathomic", fixdim=FIXDIM,
                 attn_dim=attn_dim).validate()
    model = define_net(cfg, "cpu")
    assert set(model.state_dict()) == set(want)
    model.load_state_dict({k: _t(v) for k, v in got.items()}, strict=True)
    assert model.output_range.item() == 6.0
    assert model.output_shift.item() == -3.0
    assert ("pathomic_net_tumor.cls_token" in want) == (attn_dim == 1)


def test_batch_loss_vgrid_matches_jax(rng):
    """The vgrid consistency loss, including the reference's verbatim
    ``reshape(8, n, -1)`` of the (batch, group)-major vgrid."""
    n = 3
    omic = rng.normal(size=(n, 5, 16)).astype(np.float32)
    vgrid = rng.normal(size=(n * 8, 2, 3, 3)).astype(np.float32)
    want = float(jlosses.batch_loss_vgrid(jnp.asarray(omic),
                                          jnp.asarray(vgrid)))
    got = tlosses.batch_loss_vgrid(_t(omic), _t(vgrid)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_config_refuses_what_the_port_or_jax_cannot_run():
    with pytest.raises(ValueError, match="attn_dim 2"):
        Config(mode="deformpathomic", attn_dim=1, return_vgrid=True).validate()
    # BilinearFusion (any fusion_type but concat) is ported; the gradient
    # modulation, which needs the concatenated classifier, is refused with it
    # (tests/test_torch_baselines.py)
    assert Config(mode="deformpathomic",
                  fusion_type="pofusion").validate().fusion_type == "pofusion"
    with pytest.raises(ValueError, match="attn_dim"):
        Config(attn_dim=3).validate()
    cfg = Config.from_args(["--mode", "deformpathomic", "--attn_dim", "1",
                            "--degenerate_1d_sampling", "true"])[0]
    assert (cfg.attn_dim, cfg.degenerate_1d_sampling) == (1, True)
    assert (cfg.fusion_type, cfg.mmhid, cfg.return_vgrid) == ("concat", 128,
                                                             False)


def test_fused_evaluator_matches_jax_fused_val(rng):
    """The seven classification metrics of the fused logits ``logits[2]``
    against JAX ``Evaluator.fused_val`` on the same logits and labels (its
    forward replaced by those logits)."""
    fused = rng.normal(size=(9, 4)).astype(np.float32)
    labels = np.zeros((9, 12), np.int32)
    labels[:, 5] = rng.integers(0, 4, 9)
    jcfg = jconfig.Config(mode="deformpathomic", task_type="diag2021",
                          fixdim=FIXDIM)
    jev = JEvaluator(JDeformPathomicNet(label_dim=4, input_size_omic_tumor=59,
                                        input_size_omic_immune=361), jcfg)
    jev._run = lambda state, loader: ([(None, None, None,
                                        [None, None, fused])], labels)
    want = jev.fused_val(None, None)
    cfg = Config(mode="deformpathomic", fixdim=FIXDIM).validate()
    ev = Evaluator(None, cfg, "cpu", "fused")
    got = ev.metrics({"logits_fused": fused}, labels)
    names = ("acc", "f1", "auc", "bac", "sens", "spec", "prec")
    assert list(got) == [f"{n}_fused" for n in names]
    np.testing.assert_allclose([got[f"{n}_fused"] for n in names], want,
                               rtol=1e-6, atol=1e-7)


def test_deformpathomic_entries_run_on_the_cpu_when_asked(monkeypatch):
    """Serving (``testDeformPathomicModel``: the flat metrics of the fused
    logits) and training (``trainDeformPathomicModel``: ``loss3`` and, with
    ``return_vgrid``, ``batch_sim_loss`` logged) at attn_dim 1 and 2; both
    raise where there is no card unless asked for the CPU."""
    names = {"acc", "f1", "auc", "bac", "sens", "spec", "prec"}
    for attn_dim, rv in ((1, False), (2, True)):
        cfg = Config(mode="deformpathomic", fixdim=FIXDIM, batch_size=B,
                     attn_dim=attn_dim, return_vgrid=rv, cpb_table_divisor=1,
                     synthetic_data=True, synthetic_train_size=4,
                     synthetic_test_size=3, kfold=1, epochs=2,
                     eval_every_iters=3, checkpoints="#",
                     debug=True).validate()
        metrics, logits = inference.main(cfg, device="cpu")
        assert set(metrics) == names and logits["logits_fused"].shape == (3, 4)
        logged = []
        m = tmain.main(cfg, device="cpu",
                       logger=types.SimpleNamespace(log=logged.append))[0]
        assert len(m["train_losses"]) == 4
        assert np.isfinite(m["train_losses"]).all()
        assert m["auc"] == m["detail"]["auc_fused"]
        want = {"loss", "loss3"} | ({"batch_sim_loss"} if rv else set())
        assert len(logged) == 1 and set(logged[0]["training"]) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: define_net(cfg), lambda: inference.main(cfg),
                 lambda: tmain.main(cfg)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()


def test_deformpathomic_entries_run_from_the_command_line_without_jax():
    """A fresh interpreter runs both entries with ``--mode deformpathomic
    --attn_dim 1 --device cpu`` and never loads jax, jaxlib or flax."""
    port = "disentangled_multimodal_learning_tpu_torch"
    code = (
        "import runpy, sys\n"
        "tiny = ['--config', sys.argv[1], '--mode', 'deformpathomic',"
        " '--attn_dim', '1', '--synthetic_data', 'true', '--fixdim', '64',"
        " '--batch_size', '2', '--synthetic_test_size', '2',"
        " '--device', 'cpu', '--debug']\n"
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
    assert "acc=" in proc.stdout and "[fold 0] acc=" in proc.stdout


# ------------------------------------------------- trajectories against JAX

def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("attn_dim,return_vgrid,key,steps", [
    pytest.param(1, False, 9, STEPS, id="1-False-9"),
    pytest.param(2, True, 7, STEPS, id="2-True-7"),
    pytest.param(1, False, 7, 10, id="1-False-7-before-its-branch")])
def test_deformpathomic_train_step_trajectory_matches_jax(
        monkeypatch, attn_dim, return_vgrid, key, steps):
    """20 AdamW steps (cosine schedule, ``loss3`` and with ``return_vgrid``
    ``0.5 bs_t + 0.5 bs_i``, gradient modulation of the top classifier) of
    the port's deformpathomic step and of the JAX step under
    ``deterministic_training``, at divisor 1 (the 1-D table, or K1's
    table), alternating two batches, from the same weights with every bias
    nudged off 0 (a zero CPB bias puts the table's relu inputs at exactly
    0, where JAX's ``maximum`` splits the gradient and torch's relu gives
    0).

    Step 0: the loss within 1e-5 relative, and every parameter's gradient
    after modulation within 1e-4 rel-L2 (JAX's read off AdamW's first
    moment, ``mu = 0.1 g``), except the CPB output biases, whose gradient is
    0 in exact arithmetic (the softmax over kv ignores a shift): both sides
    must hold them below 1e-5 of their weights' gradient.  Then every
    step's loss within 2e-4 relative (the teacher's bound; observed 2.2e-5
    at attn_dim 1 and 6.5e-6 at attn_dim 2), and the final classifiers and
    CPB ``mlp0`` weights within 1e-5 rel-L2.

    The init key: at attn_dim 1 the JAX init keys 7 and 8 reach a
    discrete branch at step 11 near which the port's trajectory forks by
    3e-4, and it forks the same way from its own weights perturbed by 1e-7
    relative, so that is the trajectory's sensitivity, not a port fault
    (from JAX's weights at steps 8-11 the port's gradients agree within
    2.3e-5 rel-L2 and its losses within 2.2e-7); keys 9-11 reach none in 20
    steps (at most 8.1e-5).  Key 9 is used there for all 20 steps, and key
    7, which was not picked for passing, for the 10 steps before its
    branch (the schedule still that of 20); key 7 at attn_dim 2."""
    _use_jax_divisor(monkeypatch, 1)
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    jmodel = JDeformPathomicNet(label_dim=4, input_size_omic_tumor=59,
                                input_size_omic_immune=361,
                                attn_dim=attn_dim, return_vgrid=return_vgrid)
    arrays = batch_to_arrays(batches[0])
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(key), arrays["x_path10"], arrays["x_omic"],
        arrays["x_omic_tumor"], arrays["x_omic_immune"])["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    jcfg = jconfig.Config(
        mode="deformpathomic", task_type="diag2021", label_dim=4,
        fixdim=FIXDIM, batch_size=B, epochs=STEPS, lr=2e-4,
        lr_policy="cosine", optimizer="adamw", weight_decay=0.01,
        gradient_modulate=True, attn_dim=attn_dim, return_vgrid=return_vgrid,
        deterministic_training=True, checkpoints="#",
        cpb_table_divisor=1).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jmodel, jcfg, tx))
    jax_losses = []
    for k in range(steps):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))
        if k == 0:
            jax_grads = export_torch_state_dict(
                jax.tree.map(lambda mu: np.asarray(mu) * 10,
                             state.opt_state[0].mu), "deformpathomic",
                attn_dim)
    jax_final = export_torch_state_dict(jax.device_get(state.params),
                                        "deformpathomic", attn_dim)

    cfg = Config(mode="deformpathomic", fixdim=FIXDIM, batch_size=B,
                 attn_dim=attn_dim, return_vgrid=return_vgrid,
                 cpb_table_divisor=1, epochs=STEPS,
                 deterministic_training=True).validate()
    model = jax_params.load_jax_params(define_net(cfg, "cpu"), params,
                                       "deformpathomic", attn_dim)
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    losses = []
    for k in range(steps):
        metrics = step(batch_to_tensors(batches[k % 2], "cpu"))
        losses.append(float(metrics["loss"]))
        if k == 0:
            want_keys = {"loss", "loss3"} | (
                {"batch_sim_loss"} if return_vgrid else set())
            assert set(metrics) == want_keys
            assert abs(losses[0] - jax_losses[0]) <= 1e-5 * abs(jax_losses[0])
            for name, p in model.named_parameters():
                want = np.asarray(jax_grads[name])
                if name.endswith("rel_pos_bias.mlp.2.bias"):
                    w = model.get_parameter(name[:-4] + "weight").grad
                    floor = 1e-5 * w.abs().max().item()
                    assert p.grad.abs().max().item() <= floor, name
                    assert np.abs(want).max() <= floor, name
                    continue
                assert _rel_l2(p.grad, want) <= 1e-4, name
    for k, (a, b) in enumerate(zip(losses, jax_losses)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (k, a, b)
    sd = model.state_dict()
    attn = "attn1d" if attn_dim == 1 else "attn2d"
    for name in ("classifier.weight", "classifier_tumor.0.weight",
                 "pathomic_net_tumor._fc2.weight",
                 f"pathomic_net_tumor.layer3.{attn}.rel_pos_bias.mlp.0.0.weight"):
        assert _rel_l2(sd[name], jax_final[name]) <= 1e-5, name

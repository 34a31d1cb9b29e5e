"""The port reads the JAX package's checkpoints (``utils/jax_checkpoint.py``)
on the CPU.  In each case the JAX package builds its ``TrainState`` (over
numpy-drawn variables of its ``init``'s shapes: ``_variables``), takes 3
``deterministic_training`` steps with its ``make_train_step`` on numpy
bags, writes the state with its own ``save_checkpoint``, restores the file
with its ``restore_state`` and takes 3 more steps; the port restores the same file into a model of another
seed, with a fresh optimizer and scheduler, and takes the same 3 steps.
Then a fold that JAX's ``run_training`` stopped after epoch 1 resumes in
the port's, and the reader's refusals.

Cases: the teacher at the preset's widths (dims 128, 8 heads, divisor 1,
gradient modulation) at fixdim 64 under ``adamw`` with a ``linear``
schedule, and in JAX's ``stacked_scales`` layout; deformpathomic at
``attn_dim`` 1 (the 1-D table CPB); pathomic with BilinearFusion (its
``batch_stats``); ``omic`` under ``adam``, ``sgd``, ``adagrad`` and
``plateau`` (whose injected lr JAX's watcher has cut to 0.2 of ``lr``
before the save).  B = 2; JAX at divisor
1 in the "kn" layout (on the CPU "auto" means "nk", which never takes the
table CPB).

Tolerances, as the port's trajectory tests hold them: the eval logits
after the restore within 1e-4 abs (the teacher's serving tolerance, JAX's
f32 CPU forward against the port's); each continued loss within 2e-4
relative (``test_torch_train.py``'s trajectory bound); every final
parameter within 1e-5 rel-L2 (that test's bound on the final weights),
but for the leaves whose gradient is 0, or nearly, in exact arithmetic,
where Adam turns rounding noise into full-size steps: the CPB MLPs'
output biases and their last hidden biases (units active at every
position shift every bias of a row alike), the attention pooling's score
biases (a softmax ignores a shift), the q and k rows of the TransFusion
layers' MHA (it attends to one kv token).  Those only within 3 updates of
the lr of JAX's (observed at most half of that).
"""

import functools
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.loader import BagLoader as JLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net, model_inputs as jmodel_inputs)
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jpda
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train import trainers as jtrainers
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_eval_step, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils import checkpoint as jckpt
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    Evaluator, model_type_of)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils import checkpoint
from disentangled_multimodal_learning_tpu_torch.utils.jax_checkpoint import (
    read_jax_checkpoint)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    jax_state_dict)

B, STEPS = 2, 3
LOGITS_TOL, LOSS_TOL, PARAM_TOL = 1e-4, 2e-4, 1e-5
ZERO_GRAD_LEAVES = ("rel_pos_bias.mlp.1.0.bias", "rel_pos_bias.mlp.2.bias",
                    "attention_1.bias", "attention_c.bias")
TEACHER = dict(fixdim=64, cpb_table_divisor=1, optimizer="adamw",
               lr_policy="linear")
# (mode, config settings)
CASES = [
    ("teacher", TEACHER),
    ("teacher", {**TEACHER, "branch_devices": 2}),
    ("deformpathomic", dict(fixdim=16, attn_dim=1, cpb_table_divisor=1,
                            optimizer="adamw", lr_policy="linear")),
    ("pathomic", dict(fixdim=16, fusion_type="pofusion", optimizer="adamw",
                      lr_policy="cosine")),
    ("omic", dict(fixdim=16, optimizer="adam", lr_policy="exp")),
    ("omic", dict(fixdim=16, optimizer="sgd", lr_policy="step")),
    ("omic", dict(fixdim=16, optimizer="adagrad", lr_policy="cosine")),
    ("omic", dict(fixdim=16, optimizer="adamw", lr_policy="plateau")),
]
IDS = ["teacher", "teacher-stacked", "deformpathomic-1d",
       "pathomic-bilinear", "omic-adam", "omic-sgd", "omic-adagrad",
       "omic-plateau"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_kn(monkeypatch):
    """JAX's module-level knobs, which its ``define_net`` sets, restored
    after the test; its attention layout forced to "kn"."""
    for mod, names in ((jda, ("CPB_REMAT", "CPB_TABLE_DIVISOR",
                              "FUSED_TABLE_ATTENTION", "ATTN_BF16_STREAMS")),
                       (jpda, ("TBL_BF16_OUT",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")


def _configs(mode, kw):
    kw = {**dict(batch_size=B, epochs=10, lr=2e-4, weight_decay=0.01,
                 deterministic_training=True, checkpoints="#"), **kw}
    return (jconfig.Config(mode=mode, **kw).validate(),
            Config(mode=mode, **kw).validate())


def _batches(fixdim, n=2 * STEPS):
    ds = JSynthetic(size=n * B, fixdim=fixdim, seed=0)
    return [ds.batch(list(range(k * B, (k + 1) * B))) for k in range(n)]


def _jax_logits(mode, out):
    """JAX's eval outputs as the port's ``Evaluator.step`` gives them."""
    if mode == "teacher":
        return out[2]
    if mode in ("pathomic", "deformpathomic"):
        return {"logits_fused": out[3][2]}
    return {"logits_simple": out[1]}


def _variables(model, jcfg, batch):
    """Numpy-drawn variables of the shapes of ``model.init`` (through
    ``jax.eval_shape``, so nothing compiles): kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.1), biases and running means N(0, 0.1), running
    variances U(0.5, 1.5); no bias at 0, where the divisor-1 table's centre
    entry would put a relu input exactly at 0 (JAX's ``maximum`` splits
    that gradient in half, torch's relu gives 0)."""
    shapes = jax.eval_shape(functools.partial(
        model.init, **jmodel_inputs(jcfg.mode, batch, train=False),
        deterministic=True), {"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(1)})
    rng = np.random.default_rng(3)

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


def _jax_fold(tmp_path, jcfg, plateau=False):
    """JAX's side of a case: ``(checkpoint path, eval logits after the
    restore, the 3 continued losses, final params, final batch_stats)``."""
    batches = _batches(jcfg.fixdim)
    model = jdefine_net(jcfg)
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create(_variables(model, jcfg, batches[0]), tx)
    step = jax.jit(jmake_train_step(model, jcfg, tx))
    for k in range(STEPS):
        state, _ = step(state, batch_to_arrays(batches[k]),
                        jax.random.PRNGKey(k))
    if plateau:  # as JAX's watcher cuts it
        state = joptim.set_learning_rate(state, 0.2 * jcfg.lr)
    path = jckpt.save_checkpoint(str(tmp_path), "fold", state, extra={
        "mode": jcfg.mode, "task": jcfg.task_type, "fold": 0})
    state = jckpt.restore_state(state, path)
    out = jax.jit(make_eval_step(model, jcfg, need_attention=False))(
        state.params, state.batch_stats, batch_to_arrays(batches[0]))
    logits = jax.device_get(_jax_logits(jcfg.mode, out))
    losses = []
    for k in range(STEPS, 2 * STEPS):
        state, m = step(state, batch_to_arrays(batches[k]),
                        jax.random.PRNGKey(k))
        losses.append(float(m["loss"]))
    return (path, logits, losses, jax.device_get(state.params),
            jax.device_get(state.batch_stats))


def _zero_grad_split(name, got, want):
    """``(got, want)`` of the part of leaf ``name`` held at ``PARAM_TOL``
    and of the part whose gradient is 0 in exact arithmetic (None where
    there is none): the ``ZERO_GRAD_LEAVES``, and the q and k rows of the
    TransFusion layers' MHA, which attends to one kv token (a softmax of
    one score is 1)."""
    if name.endswith(ZERO_GRAD_LEAVES):
        return None, (got, want)
    if ".transfusion_layer" in name and ".in_proj_" in name:
        n = 2 * got.shape[0] // 3
        return (got[n:], want[n:]), (got[:n], want[:n])
    return (got, want), None


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("mode,kw", CASES, ids=IDS)
def test_port_continues_a_fold_that_jax_wrote(tmp_path, jax_kn, mode, kw):
    jcfg, cfg = _configs(mode, kw)
    plateau = cfg.lr_policy == "plateau"
    path, jlogits, jlosses, jparams, jbs = _jax_fold(tmp_path, jcfg, plateau)
    batches = _batches(cfg.fixdim)
    model = define_net(cfg.replace(seed=cfg.seed + 1), "cpu")
    opt = toptim.make_optimizer(cfg, model.parameters())
    sched = toptim.make_scheduler(cfg, opt, 1, toptim.ReduceLROnPlateau())
    assert checkpoint.restore_state(model, opt, sched, path, mode,
                                    cfg.attn_dim) == STEPS
    assert sched.last_epoch == STEPS
    if plateau:
        assert toptim.current_learning_rate(opt) == pytest.approx(
            0.2 * cfg.lr, rel=1e-6)
    model_type = model_type_of(mode)
    got = Evaluator(model.eval(), cfg, "cpu", model_type).step(batches[0])
    assert set(got) == set(jlogits)
    for k, v in jlogits.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=LOGITS_TOL,
                                   rtol=0, err_msg=k)
    step = make_train_step(model, cfg, opt, sched)
    for k in range(STEPS, 2 * STEPS):
        loss = float(step(batch_to_tensors(batches[k], "cpu"))["loss"])
        want = jlosses[k - STEPS]
        assert abs(loss - want) <= LOSS_TOL * max(1.0, abs(want)), (k, loss,
                                                                     want)
    want = jax_state_dict(jparams, mode, cfg.attn_dim, jbs)
    lr_max = 0.2 * cfg.lr if plateau else cfg.lr
    for name, v in model.state_dict().items():
        held, noise = _zero_grad_split(name, v.numpy(), want[name])
        if held is not None:
            assert _rel_l2(*held) <= PARAM_TOL, (name, _rel_l2(*held))
        if noise is not None:
            assert np.abs(noise[0] - noise[1]).max() <= (
                STEPS * lr_max * 1.01), name


class _Stop(Exception):
    pass


def test_port_resumes_the_rolling_checkpoint_of_jax_run_training(
        tmp_path, monkeypatch, capsys):
    """JAX's ``run_training`` (``omic``, 2 epochs of 2 steps,
    ``save_every_epochs`` 1) stopped after epoch 1's rolling
    ``omic_fold_1_latest.ckpt``; the port's training entry with ``resume``
    takes it (no ``.pt`` is there), starts at epoch 1, and its 2 losses
    and final weights are those of JAX's own resumed run (the tolerances
    above)."""
    kw = dict(fixdim=16, synthetic_train_size=4, synthetic_test_size=2,
              kfold=1, epochs=2, save_every_epochs=1, eval_every_iters=100,
              optimizer="adamw", lr_policy="cosine")
    jcfg, cfg = _configs("omic", kw)
    jcfg = jcfg.replace(checkpoints=str(tmp_path))

    def loaders():
        ds = [JSynthetic(size=n, fixdim=16, seed=s, args=jcfg)
              for n, s in ((4, jcfg.seed), (2, jcfg.seed + 100))]
        return (JLoader(ds[0], B, shuffle=True, drop_last=True,
                        seed=jcfg.seed), JLoader(ds[1], B))

    save = jtrainers.save_checkpoint

    def killed_after_rolling_save(directory, name, *args, **kw):
        path = save(directory, name, *args, **kw)
        if name.endswith("_latest"):
            raise _Stop(path)
        return path

    monkeypatch.setattr(jtrainers, "save_checkpoint",
                        killed_after_rolling_save)
    with pytest.raises(_Stop):
        jtrainers.run_training(jcfg, jdefine_net(jcfg), loaders(),
                               model_type="simple")
    monkeypatch.setattr(jtrainers, "save_checkpoint", save)
    latest = tmp_path / "omic_fold_1_latest.ckpt"
    assert read_jax_checkpoint(str(latest))["extra"]["epoch"] == 1
    # JAX's own resumed run, on a copy (it rewrites its rolling file)
    (tmp_path / "jax").mkdir()
    shutil.copy(latest, tmp_path / "jax")
    jstate, jmetrics, _ = jtrainers.run_training(
        jcfg.replace(resume=True, checkpoints=str(tmp_path / "jax")),
        jdefine_net(jcfg), loaders(), model_type="simple")
    capsys.readouterr()
    got = tmain.main(cfg.replace(resume=True, checkpoints=str(tmp_path),
                                 synthetic_data=True, debug=True),
                     device="cpu")[0]
    assert f"[resume] {latest}: step 2 -> starting at epoch 1" in (
        capsys.readouterr().out)
    assert len(got["train_losses"]) == 2
    want = jmetrics["train_loss"]
    assert abs(got["train_loss"] - want) <= LOSS_TOL * max(1.0, abs(want))
    final, = tmp_path.glob("omic_fold_1_epoch_2_*.pt")
    params = checkpoint.load_checkpoint(str(final))["params"]
    for name, v in jax_state_dict(jax.device_get(jstate.params),
                                  "omic").items():
        assert _rel_l2(params[name], v) <= PARAM_TOL, name


class _Evil:
    def __reduce__(self):
        return (os.system, ("touch pwned",))


@pytest.mark.parametrize("name", ["os.system", "ml_dtypes"])
def test_reader_refuses_other_globals_and_runs_nothing(tmp_path,
                                                       monkeypatch, name):
    """A pickle that names any global outside the reader's list raises
    ``UnpicklingError`` naming it, and nothing of it runs."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "evil.ckpt"
    if name == "os.system":
        data = pickle.dumps({"params": _Evil()})
    else:  # a bfloat16 dtype: ml_dtypes is not on the reader's list
        data = b"cml_dtypes\nbfloat16\n."
    path.write_bytes(data)
    with pytest.raises(pickle.UnpicklingError,
                       match="system" if name == "os.system" else name):
        checkpoint.load_checkpoint(str(path), "teacher")
    assert not (tmp_path / "pwned").exists()


def test_orbax_and_mode_mismatch_are_refused(tmp_path, jax_kn):
    """A ``.orbax`` path raises with its reason, before anything is read;
    a JAX ``.ckpt`` of the student loaded for the teacher raises naming
    both modes; no path falls back to random weights."""
    with pytest.raises(ValueError, match="needs orbax"):
        checkpoint.load_checkpoint(str(tmp_path / "fold.orbax"), "teacher")
    jcfg, cfg = _configs("omic", dict(fixdim=16))
    path = _jax_fold(tmp_path, jcfg)[0]
    with pytest.raises(ValueError, match="'omic', not by 'pathomic'"):
        checkpoint.restore_state(define_net(cfg.replace(mode="pathomic"),
                                            "cpu"), None, None, path,
                                 "pathomic")
    payload = checkpoint.load_checkpoint(path)
    assert payload["extra"]["mode"] == "omic" and payload["step"] == STEPS


@pytest.mark.parametrize("numpy_core", ["numpy._core", "numpy.core"])
def test_reader_takes_numpy_2_and_1_names(tmp_path, monkeypatch,
                                          numpy_core):
    """numpy 2 names its array reconstructor ``numpy._core.numeric``,
    numpy 1 ``numpy.core.numeric`` (here written by naming the function
    so, which numpy 2's ``numpy.core`` shim resolves); the reader takes
    both, in JAX's protocol (``HIGHEST_PROTOCOL``), with flax's
    ``FrozenDict`` read as a dict and optax's states as the reader's
    stand-ins of the same fields."""
    from flax.core import frozen_dict

    frombuffer = np._core.numeric._frombuffer
    monkeypatch.setattr(frombuffer, "__module__", numpy_core + ".numeric")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"params": frozen_dict.FrozenDict({"w": a}), "step": 3,
            "opt_state": jax.device_get(joptim.make_optimizer(
                _configs("omic", {})[0], 1).init({"w": a}))}
    data = pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)
    assert (numpy_core + ".numeric").encode() in data
    path = tmp_path / "tree.ckpt"
    path.write_bytes(data)
    got = read_jax_checkpoint(str(path))
    assert type(got["params"]) is dict and got["step"] == 3
    np.testing.assert_array_equal(got["params"]["w"], a)
    adam, empty, sched = got["opt_state"]
    assert type(adam).__name__ == "ScaleByAdamState" and adam._fields == (
        "count", "mu", "nu")
    assert type(empty).__name__ == "EmptyState" and int(sched.count) == 0
    np.testing.assert_array_equal(adam.mu["w"], np.zeros_like(a))

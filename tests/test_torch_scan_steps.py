"""``scan_steps`` K > 1 in the port (``train/trainers.py run_training``,
``train/graph_chunk.py``) on the CPU, where a chunk's K steps run eagerly,
against the JAX package's ``run_training`` (``trainers.py:234-285``: the
batches buffered by bag shape, a full buffer's K updates as one
``lax.scan``, one eval-cadence check a chunk, the leftovers drained one by
one at each epoch's end).

Against JAX, under ``deterministic_training``, from the same numpy-drawn
weights (``utils/jax_params.py``): ``omic`` at K 2 over a bucketed loader
of two bag shapes whose epochs each leave a batch over (JAX compiles its
scan once a shape, so a cheap mode), and a teacher at fixdim 64 over 3
batches (one chunk and a leftover).  Held: the final parameters within the
trajectory tests' 1e-5 rel-L2, the same evaluations at the same updates
(a recording logger on both sides; each logged train loss within their
2e-4 relative), and every train metric in each logged dict.

Ports of JAX's scan tests: 3 batches at K 2 make 3 updates
(``test_train_e2e.py:231``); every batch of a bucketed loader makes an
update (``test_bucketing.py:206``); distillation through the
teacher-output cache bitwise equal to without it, at K 1 and 2
(``test_distill_cache.py:80``); each logged training dict keeps every
metric and the leftover drain evaluates too (``test_aux.py:157``); two
gloo ranks at K 2 equal the single-process run (``test_parallel.py:287``,
through ``tests/torch_parallel_worker.py``).  The port's own rules:
arrivals A B B A update as B B A A; the plateau watcher's epoch mean
covers every loss of a chunk; a fold stopped after its first epoch and
resumed at K 2 ends bitwise where the whole fold ends; the SGD and
Adagrad that a graph replays, with a tensor lr, step as the default ones.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.bucketing import (
    BucketedBagLoader as JBucketed)
from disentangled_multimodal_learning_tpu.data.loader import BagLoader as JLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net, model_inputs as jmodel_inputs)
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train import trainers as jtrainers
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.bucketing import (
    BucketedBagLoader)
from disentangled_multimodal_learning_tpu_torch.data.loader import BagLoader
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train import trainers
from disentangled_multimodal_learning_tpu_torch.train.trainers import (
    run_training, trainDistillation)
from disentangled_multimodal_learning_tpu_torch.utils import checkpoint
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    jax_state_dict, load_jax_params)

import torch_parallel_cases as pc

B = 2
LOSS_TOL, PARAM_TOL = 2e-4, 1e-5
# leaves whose gradient is 0 in exact arithmetic (softmaxes that ignore a
# shift), and the q and k rows of the TransFusion layers' attention (it
# attends to one kv token): Adam turns their rounding noise into
# full-size steps, so they are held within 3 updates of the lr
# (test_torch_jax_checkpoint.py)
ZERO_GRAD_LEAVES = ("rel_pos_bias.mlp.1.0.bias", "rel_pos_bias.mlp.2.bias",
                    "cluster_merge.score.bias")
# the teacher: test_torch_train.py's trajectory test holds its classifiers
# and the CPB's first layer at PARAM_TOL; from a fresh AdamW state each
# entry's first updates are lr x the sign of its gradient, so the entries
# whose gradient is at rounding level move the other leaves by up to
# 4.8e-5 rel-L2 in 3 updates (to_q), held within TEACHER_TOL
TEACHER_HELD = ("classifier.weight", "rel_pos_bias.mlp.0.0.weight")
TEACHER_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.logged = []

    def log(self, payload):
        self.logged.append(payload)


def _variables(model, jcfg, batch):
    """Numpy-drawn variables of ``model.init``'s shapes (nothing compiles;
    ``test_torch_jax_checkpoint.py``'s draw): kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.1), biases N(0, 0.1), so that no relu input sits
    exactly at 0, where JAX's ``maximum`` and torch's relu part ways."""
    shapes = jax.eval_shape(functools.partial(
        model.init, **jmodel_inputs(jcfg.mode, batch, train=False),
        deterministic=True), {"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(1)})
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "scale":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) < 2:
            x = 0.1 * rng.normal(size=shape)
        else:
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_leaf(name, got, want, tol, lr):
    """Leaf ``name`` within ``tol`` rel-L2, its parts whose gradient is 0
    in exact arithmetic within 3 updates of ``lr``."""
    got, want = np.asarray(got), np.asarray(want)
    if ".transfusion_layer" in name and ".in_proj_" in name:
        n = 2 * got.shape[0] // 3
        assert np.abs(got[:n] - want[:n]).max() <= 3 * lr, name
        got, want = got[n:], want[n:]
    if name.endswith(ZERO_GRAD_LEAVES):
        assert np.abs(got - want).max() <= 3 * lr, name
    else:
        assert _rel_l2(got, want) <= tol, (name, _rel_l2(got, want))


def _omic_loaders(lib):
    """Two epochs of [64, 64, 64, 16, 64] and [64, 64, 64, 64, 16]: a
    chunk of each shape and a 16 left over in each (seed 0, K 2)."""
    ds = JSynthetic(size=8, fixdim=64, label_dim=4, seed=0, min_len=5)
    test = JSynthetic(size=2, fixdim=64, label_dim=4, seed=2)
    if lib == "jax":
        return (JBucketed(ds, batch_size=B, buckets=(16, 64), shuffle=True,
                          drop_last=False, seed=0),
                JLoader(test, B, shuffle=False, drop_last=False))
    return (BucketedBagLoader(ds, B, buckets=(16, 64), shuffle=True,
                              drop_last=False, seed=0), BagLoader(test, B))


def _teacher_loaders(lib):
    """3 batches of fixdim 64 (2 x 2 kv points a head): one chunk and a
    leftover."""
    ds = JSynthetic(size=3 * B, fixdim=64, label_dim=4, seed=1)
    if lib == "jax":
        return JLoader(ds, B, shuffle=False, drop_last=False), None
    return BagLoader(ds, B), None


CASES = {
    "omic": (dict(fixdim=64, epochs=2, eval_every_iters=2), _omic_loaders,
             "simple"),
    "teacher": (dict(fixdim=64, epochs=1, eval_during_training=False),
                _teacher_loaders, "teacher"),
}


@pytest.mark.parametrize("mode", list(CASES))
def test_chunked_training_matches_jax_run_training(mode):
    """The port's ``run_training`` at K 2 against JAX's from the same
    weights (see the module docstring)."""
    kw, loaders, model_type = CASES[mode]
    kw = dict(mode=mode, task_type="diag2021", label_dim=4, batch_size=B,
              scan_steps=2, deterministic_training=True, checkpoints="#",
              debug=True, seed=0, lr=2e-4, optimizer="adamw",
              lr_policy="cosine", **kw)
    jcfg = jconfig.Config(**kw).validate()
    jloaders = loaders("jax")
    jmodel = jdefine_net(jcfg)
    variables = _variables(jmodel, jcfg, next(iter(jloaders[0])))
    tx = joptim.make_optimizer(jcfg, len(jloaders[0]))
    jlog = _Recorder()
    jstate, jmetrics, _ = jtrainers.run_training(
        jcfg, jmodel, jloaders, logger=jlog,
        state=TrainState.create(variables, tx), model_type=model_type)

    cfg = Config(**kw).validate()
    model = load_jax_params(define_net(cfg, "cpu"), variables["params"], mode)
    log = _Recorder()
    _, final, _ = run_training(cfg, model, loaders("port"), logger=log,
                               model_type=model_type)
    assert len(final["train_losses"]) == int(jstate.step) == (
        10 if mode == "omic" else 3)
    want = jmetrics["train_loss"]
    assert abs(final["train_loss"] - want) <= LOSS_TOL * max(1, abs(want))
    assert len(log.logged) == len(jlog.logged) == (5 if mode == "omic"
                                                   else 0)
    for got, want in zip(log.logged, jlog.logged):
        assert set(got["training"]) == set(want["training"]) == {
            "loss", "taskloss"}
        for k, w in want["training"].items():
            assert abs(got["training"][k] - w) <= LOSS_TOL * max(1, abs(w)), k
    params = model.state_dict()
    for name, w in jax_state_dict(jax.device_get(jstate.params),
                                  mode).items():
        tol = (TEACHER_TOL if mode == "teacher"
               and not name.endswith(TEACHER_HELD) else PARAM_TOL)
        _assert_leaf(name, params[name], w, tol, cfg.lr)


def _tiny(mode="teacher", **kw):
    """The JAX e2e tests' tiny config (``test_train_e2e.py tiny_cfg``) at
    fixdim 16."""
    return Config(**{**dict(mode=mode, fixdim=16, batch_size=B, epochs=1,
                            eval_during_training=False, checkpoints="#",
                            debug=True, seed=0), **kw}).validate()


def _synthetic(cfg, size, seed):
    return SyntheticBagDataset(size=size, fixdim=cfg.fixdim,
                               label_dim=cfg.label_dim, seed=seed)


def test_three_batches_at_k2_make_three_updates(tmp_path):
    """3 batches at K 2: one chunk and the leftover, 3 updates (JAX
    ``test_train_scan_steps_fuses_dispatches``), finite metrics."""
    cfg = _tiny(scan_steps=2, checkpoints=str(tmp_path))
    loaders = (BagLoader(_synthetic(cfg, 3 * B, 1), B, shuffle=True, seed=0),
               BagLoader(_synthetic(cfg, 4, 2), B))
    _, final, path = run_training(cfg, define_net(cfg, "cpu"), loaders)
    assert checkpoint.load_checkpoint(path)["step"] == 3
    assert checkpoint.load_checkpoint(path)["scheduler"]["last_epoch"] == 3
    assert len(final["train_losses"]) == 3
    assert np.isfinite(final["auc"]) and np.isfinite(final["train_loss"])


def test_every_bucketed_batch_makes_an_update(capsys):
    """A bucketed loader interleaves its two shapes; each buffer takes its
    own, and every batch becomes an update (JAX
    ``test_bucketing.py test_scan_steps_with_buckets``)."""
    cfg = _tiny(fixdim=64, scan_steps=2, buckets="16,64")
    ds = JSynthetic(size=12, fixdim=64, label_dim=4, seed=0, min_len=5)
    loader = BucketedBagLoader(ds, B, buckets=(16, 64), shuffle=True,
                               drop_last=False, seed=0)
    assert len({b.x_path10.shape[1] for b in loader}) == 2
    _, final, _ = run_training(cfg, define_net(cfg, "cpu"), (loader, None))
    assert len(final["train_losses"]) == len(loader)
    assert "[scan_steps] 2 updates a chunk: eager steps (no graphs on cpu)" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("k", [1, 2])
def test_cached_distillation_equals_uncached_at_k(k):
    """``trainDistillation`` with the teacher-output cache and without it,
    at ``scan_steps`` 1 and 2: bitwise equal losses and weights (the cache
    fills at a batch's arrival, before it is buffered)."""
    cfg = _tiny("distillation", synthetic_data=True, synthetic_train_size=6,
                synthetic_test_size=2, kfold=1, epochs=2, scan_steps=k)
    runs = []
    for cache in (True, False):
        student, teacher = define_net(cfg, "cpu")
        loaders = tmain.make_loaders(cfg, *tmain.synthetic_fold_datasets(
            cfg, 0))
        _, final, _ = trainDistillation(
            student, teacher, loaders, None, None, None,
            cfg.replace(distill_teacher_cache=cache))
        runs.append((final["train_losses"], student.state_dict()))
    (a, sa), (b, sb) = runs
    assert len(a) == 6 and a == b
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def test_logged_training_dict_keeps_every_metric():
    """At K 2 with an evaluation at every update: the chunk and the
    leftover drain both evaluate, and each logged training dict holds every
    train metric of the step, not the loss alone (JAX
    ``test_aux.py test_scan_path_logs_full_train_metrics``)."""
    cfg = _tiny(scan_steps=2, eval_during_training=True, eval_every_iters=1)
    loaders = (BagLoader(_synthetic(cfg, 3 * B, 1), B, shuffle=True, seed=0),
               BagLoader(_synthetic(cfg, 2, 2), B))
    log = _Recorder()
    run_training(cfg, define_net(cfg, "cpu"), loaders, logger=log)
    assert len(log.logged) == 2
    for payload in log.logged:
        assert set(payload["training"]) == {"loss", "taskloss", "batchloss"}


class _ListLoader:
    """Batches in a given order, as a loader gives them."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _recording_steps(monkeypatch, seen):
    """Wrap the trainer's step so that each update records its bag side."""
    make_step = trainers.make_step

    def recording(*args, **kw):
        step, cache = make_step(*args, **kw)

        def step_fn(tensors):
            seen.append(tensors["x_path10"].shape[1])
            return step(tensors)

        return step_fn, cache

    monkeypatch.setattr(trainers, "make_step", recording)


def test_arrivals_abba_update_as_bbaa(monkeypatch):
    """Bag sides A B B A at K 2: the B buffer fills first, so the updates
    run B B A A, and the evaluation every 2 updates logs each chunk's last
    step."""
    cfg = _tiny("omic", fixdim=64, scan_steps=2, eval_during_training=True,
                eval_every_iters=2)
    ds = JSynthetic(size=4 * B, fixdim=64, label_dim=4, seed=0)
    batches = [ds.batch(list(range(i * B, (i + 1) * B)), pad_to=n)
               for i, n in enumerate((16, 64, 64, 16))]
    seen = []
    _recording_steps(monkeypatch, seen)
    log = _Recorder()
    _, final, _ = run_training(
        cfg, define_net(cfg, "cpu"), (_ListLoader(batches),
                                      BagLoader(_synthetic(cfg, 2, 2), B)),
        logger=log, model_type="simple")
    assert seen == [64, 64, 16, 16]
    losses = final["train_losses"]
    assert [p["training"]["loss"] for p in log.logged] == pytest.approx(
        [losses[1], losses[3]], rel=1e-6)


def test_plateau_mean_covers_every_loss_of_a_chunk(monkeypatch):
    """Under ``plateau`` the watcher is fed each epoch's mean train loss:
    at K 2 every update of every chunk is in it."""
    cfg = _tiny(scan_steps=2, lr_policy="plateau", epochs=2)
    fed = []
    plain = toptim.ReduceLROnPlateau.step

    def step(self, metric):
        fed.append(metric)
        return plain(self, metric)

    monkeypatch.setattr(toptim.ReduceLROnPlateau, "step", step)
    loaders = (BagLoader(_synthetic(cfg, 4 * B, 1), B, shuffle=True, seed=0),
               None)
    _, final, _ = run_training(cfg, define_net(cfg, "cpu"), loaders)
    losses = torch.tensor(final["train_losses"]).reshape(2, 4)
    assert fed == pytest.approx(losses.mean(dim=1).tolist(), rel=1e-6)


class _Stop(Exception):
    pass


def test_fold_resumed_at_k2_equals_the_whole_fold(tmp_path, monkeypatch):
    """Under ``deterministic_training``, a fold of 2 epochs of 3 batches at
    K 2 (a chunk and a leftover each) killed after epoch 1's rolling
    checkpoint and resumed trains epoch 2 only and ends bitwise where the
    whole fold ends."""
    cfg = _tiny(synthetic_data=True, synthetic_train_size=3 * B,
                synthetic_test_size=2, kfold=1, epochs=2, scan_steps=2,
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
        str(tmp_path / "b" / "teacher_fold_1_latest.pt"))
    assert (latest["step"], latest["scheduler"]["last_epoch"]) == (3, 3)
    resumed = tmain.main(part.replace(resume=True), device="cpu")[0]
    assert resumed["train_losses"] == whole["train_losses"][3:]
    final = [checkpoint.load_checkpoint(str(next((tmp_path / d).glob(
        "teacher_fold_1_epoch_*.pt")))) for d in "ab"]
    assert final[0]["step"] == final[1]["step"] == 6
    for k, v in final[0]["params"].items():
        assert torch.equal(v, final[1]["params"][k]), k


def test_two_gloo_ranks_at_k2_equal_one_process(tmp_path):
    """The teacher's fold at K 2 (3 batches of 4: a chunk and a leftover)
    on two gloo ranks, data-parallel, against the same fold in this
    process (JAX ``test_parallel.py test_scan_steps_sharded_training_runs``):
    every rank's weights equal; the losses and the final weights within the
    parallel tests' tolerances of the teacher (``torch_parallel_cases.py``:
    the loss within its metrics' and its consistency loss's, the weights
    within its gradients' rel-L2, the parts whose gradient is 0 in exact
    arithmetic within 3 updates of the lr)."""
    kw = dict(mode="teacher", fixdim=64, batch_size=4, epochs=1,
              scan_steps=2, deterministic_training=True, checkpoints="#",
              debug=True, eval_during_training=False)
    cfg = Config(**kw).validate()
    model = define_net(cfg, "cpu")
    pc.nudge_biases(model)
    weights = tmp_path / "fold.weights.pt"
    torch.save(model.state_dict(), weights)
    case = {"name": "fold", "kind": "fold", "cfg": {**kw, "nodes": 2},
            "weights": str(weights), "size": 12, "seed": 1}
    ranks = pc.spawn(tmp_path, 2, [case])["fold"]
    loader = BagLoader(SyntheticBagDataset(size=12, fixdim=64, label_dim=4,
                                           seed=1), 4, shuffle=True, seed=1)
    _, final, _ = run_training(cfg, model, (loader, None))
    metric_tol, param_tol = pc.tolerance("teacher")
    for r in ranks:
        assert r["layout"] == ("data", 2, 1)
        np.testing.assert_allclose(
            r["losses"], final["train_losses"],
            rtol=metric_tol + pc.CONSISTENCY["batchloss"])
    for name, p in model.state_dict().items():
        got = ranks[0]["params"][name]
        assert torch.equal(got, ranks[1]["params"][name]), name
        _assert_leaf(name, got, p, param_tol, cfg.lr)


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_capturable_optimizer_with_a_tensor_lr_steps_as_the_default(name):
    """The optimizer a CUDA graph replays (``make_optimizer(...,
    capturable=True)``) with its lr a tensor, as the graph sets it, against
    the default optimizer at the same float lr: three steps on the same
    gradients (weight decay on) agree within 1e-6 relative; SGD's is the
    port's rule against torch's.  (torch's capturable Adam and AdamW step
    only on the card: ``tests/test_torch_cuda.py``.)"""
    cfg = _tiny(optimizer=name, weight_decay=0.01)
    rng = np.random.default_rng(0)
    start = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((4, 3), (3,))]
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
              for p in start] for _ in range(3)]
    runs = []
    for capturable in (False, True):
        params = [torch.nn.Parameter(p.clone()) for p in start]
        opt = toptim.make_optimizer(cfg, params, capturable=capturable)
        for k, gs in enumerate(grads):
            lr = 1e-2 * (k + 1)
            toptim.set_learning_rate(
                opt, torch.tensor(lr) if capturable else lr)
            for p, g in zip(params, gs):
                p.grad = g.clone()
            opt.step()
        runs.append([p.detach() for p in params])
    assert type(opt).__name__ == {"sgd": "CapturableSGD",
                                  "adagrad": "OptaxAdagrad"}[name]
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)

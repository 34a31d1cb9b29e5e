"""What the port's parallel tests share (``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_shard.py``): the cases' weights and batches,
the spawn of the gloo ranks (``tests/torch_parallel_worker.py``), the
port's single-process reference, JAX's single-device steps, and the
comparison.  fixdim 64, a global batch of 4, the real widths,
``deterministic_training``.

Each sharded step (its loss and metrics, every gradient after the
all-reduce and the modulation, the parameters after AdamW) is held
against the port's single-process step on the same global batch from the
same weights (every bias nudged off 0, as the JAX-parity tests do: at 0
some relu inputs tie exactly).  Tolerances (:func:`tolerance`):

- the metrics within 1e-6 relative and every gradient and parameter within
  1e-5 rel-L2 where the model's f32 forward does not depend on how the
  batch is split (the student, TransMIL, pathomic): only the sums' order
  differs;
- the modes whose omic encoders make attention queries (the teacher,
  multiscale, deformpathomic): those encoders' ``[b, 59] x [59, 128]``
  products round differently at b = 2 and b = 4 (3e-7 relative, measured
  in one process on the CPU), and the queries carry that to every
  sampling position: the teacher's logits and maps move by up to 4e-5
  relative, deformpathomic's logits by 1.6e-6, between a batch of 4 and
  two batches of 2, in one process.  They hold their metrics within 1e-5
  relative and their gradients within 5e-4 rel-L2 (observed at most
  1.3e-4, on the teacher's CPB MLP); distillation (its teacher's boundary
  tensors) its metrics within 1e-5 relative, its gradients within 1e-5;
- the CPB MLPs' hidden biases within 1e-4 rel-L2 (the tolerance of the
  JAX-parity gradient tests): the softmax over the kv points ignores a
  shift of the bias, so their gradients are sums of cotangents that nearly
  cancel (observed 1.3e-5 on the 1-D attention's);
- the consistency losses (``batchloss``, ``batch_sim_loss``) within 1e-4
  relative, the tolerance of ``tests/test_torch_train.py`` (1e4 x a
  variance of near-equal Gram entries, or squared differences of
  near-equal Grams: their cancellation amplifies the maps' last-bit
  differences, observed 1.5e-5), and the total loss within the sum of its
  parts' tolerances;
- the biases whose gradient is 0 in exact arithmetic (the CPB output
  biases, the student's cluster-score bias, the attention-pooling score
  biases) below 1e-5 of their weights' gradient (the 1-D attention's 1e-4,
  as ``chip_smoke.py`` holds it);
- the parameters after AdamW at the gradients' tolerance, over the
  entries whose single-process gradient is above 1e-6 (100 x AdamW's
  eps): the first AdamW step is ``lr g / (|g| + eps)`` an entry, so
  where ``|g|`` is near eps (the zero-gradient biases above, the
  TransFusionLayers' q and k projections, whose key is one token, an omic
  encoder's dead unit) it is set by the gradient's rounding residue, and a
  full-size step of either sign is right (those gradients are checked).

The ranks hold bitwise-equal parameters after the step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils.torch_export import (
    export_torch_state_dict)
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.ops import cluster
from disentangled_multimodal_learning_tpu_torch.train.optim import (
    make_optimizer, make_scheduler)
from disentangled_multimodal_learning_tpu_torch.train.trainers import (
    make_step)

FIXDIM, B = 64, 4
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
# (metrics relative, gradients and parameters rel-L2) by what the mode
# runs (see the module docstring); the consistency losses within 1e-4
EXACT_TOL, DISTILL_TOL, OMIC_TOL = (1e-6, 1e-5), (1e-5, 1e-5), (1e-5, 5e-4)
CONSISTENCY = {"batchloss": 1e-4, "batch_sim_loss": 1e-4}
# gradients 0 in exact arithmetic, held below this share of their weights'
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias",
                    "attention_1.bias", "attention_c.bias")
ZERO_GRAD_FLOOR, ZERO_GRAD_FLOOR_1D = 1e-5, 1e-4
# gradients that are sums of nearly cancelling cotangents, and their tolerance
CANCELLING, CANCELLING_TOL = ("rel_pos_bias.mlp.0.0.bias",
                              "rel_pos_bias.mlp.1.0.bias"), 1e-4
# the parameters are compared where the gradient is above this (module
# docstring)
ADAM_GRAD_FLOOR = 1e-6
PARALLEL_KEYS = ("nodes", "tp_devices", "branch_devices", "pipe_devices",
                 "pipe_microbatches", "seq_shard_devices", "seq_shard_dp")
BASE = dict(fixdim=FIXDIM, batch_size=B, deterministic_training=True,
            checkpoints="#", debug=True, epochs=1)


def global_batch(cfg, seed=0):
    ds = SyntheticBagDataset(size=B, fixdim=FIXDIM, label_dim=cfg.label_dim,
                             seed=seed)
    return ds.batch(list(range(B)))


def save_batch(path, batch):
    np.savez(path, **{k: getattr(batch, k) for k in (
        "x_path10", "x_path20", "x_omic", "x_omic_tumor", "x_omic_immune",
        "label")}, indices=np.arange(B))
    return str(path)


def start(out_dir: Path, world: int, cases: list):
    """Start ``world`` gloo ranks running ``cases`` (each rank's output to
    ``rank<r>.log`` in ``out_dir``); :func:`finish` collects them."""
    spec = out_dir / "spec.json"
    spec.write_text(json.dumps({"store": str(out_dir / "store"),
                                "world": world, "out": str(out_dir),
                                "cases": cases}))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(out_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(spec), str(r)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return out_dir, cases, procs


def finish(started, timeout: float = 600) -> dict:
    """The started ranks' results: ``{case: [rank results]}``."""
    out_dir, cases, procs = started
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        log = (out_dir / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return {c["name"]: [torch.load(out_dir / f"{c['name']}.rank{r}.pt")
                        for r in range(len(procs))] for c in cases}


def spawn(out_dir: Path, world: int, cases: list) -> dict:
    """Run ``cases`` on ``world`` gloo ranks; -> {case: [rank results]}."""
    return finish(start(out_dir, world, cases))


def step_case(out_dir, name, cfg_kw, model=None, teacher=None, noise=None,
              **extra):
    """A ``step`` case: the config, the weights (``model``'s, or the
    seeded init's), the global batch."""
    cfg = Config(**{**BASE, **cfg_kw}).validate()
    if model is None:
        model = define_net(cfg, "cpu")
        if cfg.mode == "distillation":
            model, teacher = model
        for m in (model, teacher):
            nudge_biases(m)
    case = {"name": name, "kind": "step",
            "cfg": {**BASE, **cfg_kw},
            "weights": str(out_dir / f"{name}.weights.pt"),
            "batch": save_batch(out_dir / f"{name}.batch.npz",
                                global_batch(cfg)), **extra}
    torch.save(model.state_dict(), case["weights"])
    if teacher is not None:
        case["teacher"] = str(out_dir / f"{name}.teacher.pt")
        torch.save(teacher.state_dict(), case["teacher"])
    if noise is not None:
        case["noise"] = str(out_dir / f"{name}.noise.npy")
        np.save(case["noise"], noise)
    return case


@torch.no_grad()
def nudge_biases(model, seed=3):
    """Every bias of ``model`` moved off 0 by N(0, 0.02) draws, as the
    JAX-parity tests nudge theirs: at the seeded init's zero biases some
    relu inputs sit exactly at 0 (the CPB MLP at the query's own
    position), where a last-bit difference picks the other branch."""
    if model is None:
        return
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.add_(0.02 * torch.randn(p.shape, generator=g))


def single_step(case):
    """The port's single-process step of ``case`` in this process (with
    the case's pinned DPC noise, where it has one)."""
    if case.get("noise"):
        noise = torch.from_numpy(np.load(case["noise"]))
        plain = cluster.pinned_density_noise
        cluster.pinned_density_noise = (
            lambda shape, device: noise[:shape[0], :shape[1]].to(device))
        try:
            return single_step({**case, "noise": None})
        finally:
            cluster.pinned_density_noise = plain
    cfg = Config.from_dict({k: v for k, v in case["cfg"].items()
                            if k not in PARALLEL_KEYS}).validate()
    model = define_net(cfg, "cpu")
    teacher = None
    if cfg.mode == "distillation":
        model, teacher = model
        teacher.load_state_dict(torch.load(case["teacher"]))
    model.load_state_dict(torch.load(case["weights"]))
    z = np.load(case["batch"])
    opt = make_optimizer(cfg, model.parameters())
    step, cache = make_step(cfg, model, opt, make_scheduler(cfg, opt, 1),
                            teacher, None, B if case.get("cache") else None)
    tensors = {k: torch.from_numpy(z[k]) for k in z.files if k != "indices"}
    tensors["label"] = tensors["label"].long()
    if cache is not None:
        tensors.update(cache.boundary(tensors, z["indices"]))
    metrics = step(tensors)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            model.state_dict())


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def zero_grad_ok(name, g, want, weight_grad) -> bool:
    floor = (ZERO_GRAD_FLOOR_1D if ".attn1d." in name else ZERO_GRAD_FLOOR
             ) * weight_grad.abs().max().item()
    return (g.abs().max().item() <= floor
            and want.abs().max().item() <= floor)


def tolerance(mode: str) -> tuple:
    """(metrics relative, gradients and parameters rel-L2) of ``mode``."""
    if mode in ("teacher", "uniteacher", "multiscale", "deformpathomic"):
        return OMIC_TOL
    return DISTILL_TOL if mode == "distillation" else EXACT_TOL


def assert_matches_single(ranks, case, skip=()):
    """Every rank's step against the port's single-process step of
    ``case``, at its mode's :func:`tolerance` (the metrics in ``skip``
    left out: the pipeline logs no ``batchloss``)."""
    metric_tol, grad_tol = tolerance(case["cfg"]["mode"])
    reference = single_step(case)
    metrics, grads, params = reference
    metrics = {k: v for k, v in metrics.items() if k not in skip}
    first = ranks[0]
    for r in ranks[1:]:  # the ranks hold the same step
        assert r["metrics"] == first["metrics"]
        for k, v in first["params"].items():
            assert torch.equal(r["params"][k], v), k
    assert set(first["metrics"]) == set(metrics)
    tols = {k: CONSISTENCY.get(k, metric_tol) * abs(v)
            for k, v in metrics.items()}
    tols["loss"] = metric_tol * abs(metrics["loss"]) + sum(
        t for k, t in tols.items() if k in CONSISTENCY)
    for k, v in metrics.items():
        got = first["metrics"][k]
        assert abs(got - v) <= tols[k], (k, got, v)
    for name, want in grads.items():
        got = first["grads"][name]
        if name.endswith(ZERO_GRAD_BIASES):
            w = grads[name[:-4] + "weight"]
            assert zero_grad_ok(name, got, want, w), name
            continue
        tol = (max(grad_tol, CANCELLING_TOL) if name.endswith(CANCELLING)
               else grad_tol)
        assert rel_l2(got, want) <= tol, (name, rel_l2(got, want))
    for name, g in grads.items():
        kept = g.abs() > ADAM_GRAD_FLOOR
        got, want = first["params"][name][kept], params[name][kept]
        assert rel_l2(got, want) <= grad_tol, (name, rel_l2(got, want))


def jax_params(model, inputs: dict, key: int, seed: int):
    """A JAX init of ``model`` on ``inputs`` with every bias nudged off 0
    (N(0, 0.02) draws, as ``tests/test_torch_train.py`` nudges them)."""
    params = jax.jit(model.init)(jax.random.PRNGKey(key), **inputs)["params"]
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)


def jax_step(model, mode: str, params, batch, teacher=None, **cfg_kw):
    """One JAX single-device AdamW step of ``mode`` on ``batch`` (cosine,
    ``deterministic_training``): ``(metrics, reference-named gradients)``,
    the gradients read off AdamW's first moment (``mu = 0.1 g``)."""
    from disentangled_multimodal_learning_tpu import config as jconfig

    jcfg = jconfig.Config(
        mode=mode, task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=1, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, deterministic_training=True,
        checkpoints="#", **cfg_kw).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    args = (batch_to_arrays(batch), jax.random.PRNGKey(0))
    if teacher is not None:
        args += ({"params": teacher[1]},)
    state, m = jax.jit(jmake_train_step(
        model, jcfg, tx, teacher_model=teacher and teacher[0]))(state, *args)
    grads = export_torch_state_dict(jax.tree.map(
        lambda mu: np.asarray(mu) * 10, state.opt_state[0].mu),
        "student" if mode == "distillation" else mode)
    return {k: float(v) for k, v in m.items()}, grads


def assert_matches_jax(rank, jax_metrics, jax_grads, consistency_tol=1e-4,
                       skip=()):
    """A rank's step against JAX's single-device step, at the tolerance
    of ``tests/test_torch_train.py``: the metrics within 1e-5 relative (the
    consistency losses ``consistency_tol``; those in ``skip`` left out),
    every gradient within 1e-4 rel-L2, the zero-gradient biases below their
    floor on both sides."""
    jax_metrics = {k: v for k, v in jax_metrics.items() if k not in skip}
    assert set(rank["metrics"]) == set(jax_metrics)
    for k, v in jax_metrics.items():
        tol = consistency_tol if k == "batchloss" else 1e-5
        if k == "loss" and "batchloss" in jax_metrics:
            tol = 1e-5 + consistency_tol * abs(
                jax_metrics["batchloss"] / v)
        assert abs(rank["metrics"][k] - v) <= tol * abs(v), (
            k, rank["metrics"][k], v)
    assert set(rank["grads"]) == set(jax_grads)
    for name, g in rank["grads"].items():
        want = torch.from_numpy(np.asarray(jax_grads[name]))
        if name.endswith(ZERO_GRAD_BIASES):
            w = rank["grads"][name[:-4] + "weight"]
            assert zero_grad_ok(name, g, want, w), name
            continue
        assert rel_l2(g, want) <= 1e-4, (name, rel_l2(g, want))

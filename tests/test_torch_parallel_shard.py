"""The port's scale-branch parallelism and pipelined distillation on the
CPU, in one gloo process group of 4 ranks (``tests/torch_parallel_worker.py``:
the ``(data 2, scale 2)`` cases and the ``(data 2, stage 2)`` case in one
spawn), its conversion of JAX's ``stacked_scales`` param trees, and both
entries in a 2-process group.  Each sharded step is held against the
port's single-process step at the tolerances of
``tests/torch_parallel_cases.py``; the branch-parallel multiscale step and
the pipelined distillation step also against JAX's single-device steps,
from JAX's weights and JAX's pinned DPC noise, at the tolerances of
``tests/test_torch_multiscale.py`` and ``tests/test_torch_distill.py``:
the metrics within 1e-5 relative (multiscale's ``batchloss`` 5e-4, which
JAX's f32 ``omic_domain_scale_loss`` needs), every gradient within 1e-4
rel-L2.  The pipeline logs no ``batchloss`` (JAX's pipe leaves it out).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models.teacher_student import (
    MultiScaleNet as JMultiScaleNet, StudentsNet as JStudentsNet,
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.train.steps import batch_to_arrays
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors)
from disentangled_multimodal_learning_tpu_torch.utils import jax_params as tjp
from disentangled_multimodal_learning_tpu_torch.utils.checkpoint import (
    load_checkpoint)
from torch_parallel_cases import (B, BASE, FIXDIM, assert_matches_jax,
                                  assert_matches_single, finish, global_batch,
                                  jax_params, jax_step, start, step_case)

REPO = Path(__file__).resolve().parents[1]
TEACHER_INPUTS = ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (as every port test file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_noise():
    """JAX's pinned DPC noise of the global batch, ``uniform(PRNGKey(0),
    [B, N])`` (the draw its eval-mode students take)."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, FIXDIM),
                                         jnp.float32))


def _teacher():
    return JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                        input_size_omic_immune=361)


def _multiscale_params(s_params, t_params):
    """A JAX ``MultiScaleNet`` tree made of a teacher's and a student's
    (per scale: the teacher's omic encoders, its teacher net and the
    student net), so that no third init compiles."""
    return {f"scale{s}_net": {
        "omic_net_tumor": t_params["omic_net_tumor"],
        "omic_net_immune": t_params["omic_net_immune"],
        "student_net": s_params[f"student{s}_net"],
        "teacher_net": t_params[f"teacher{s}_net"]} for s in ("10", "20")}


BRANCH_MODES = {"multiscale_branch": dict(mode="multiscale"),
                "teacher_branch": dict(mode="teacher"),
                "student_branch": dict(mode="student")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's student and teacher inits (biases nudged) and a multiscale
    tree of them; one spawn of 4 ranks running the ``(data 2, scale 2)``
    cases (multiscale from JAX's weights) and the ``(data 2, stage 2)``
    distillation (JAX's student and teacher, two microbatches of 1 row a
    rank), all with JAX's pinned noise; and while it runs, JAX's
    single-device multiscale and distillation steps on the global batch
    (the consistency losses on, divisor 0): ``{"cases", "ranks", "jax":
    {mode: (metrics, gradients)}, "teacher": JAX's teacher params}``."""
    cfg = Config(**BASE).validate()
    batch = global_batch(cfg)
    arrays = batch_to_arrays(batch)
    x = {k: arrays[k] for k in TEACHER_INPUTS}
    student, teacher = JStudentsNet(label_dim=4), _teacher()
    s_params = jax_params(student, {k: x[k] for k in TEACHER_INPUTS[:2]},
                          7, 3)
    t_params = jax_params(teacher, x, 8, 4)
    ms_params = _multiscale_params(s_params, t_params)
    out = tmp_path_factory.mktemp("shard")
    noise = _jax_noise()
    cases = []
    for name, kw in BRANCH_MODES.items():
        model = None
        if name == "multiscale_branch":
            model = tjp.load_jax_params(define_net(cfg.replace(**kw), "cpu"),
                                        ms_params, "multiscale")
        cases.append(step_case(out, name, {**kw, "nodes": 4,
                                           "branch_devices": 2},
                               model=model, noise=noise))
    s_net, t_net = define_net(cfg.replace(mode="distillation"), "cpu")
    cases.append(step_case(
        out, "distillation_pipe", dict(
            mode="distillation", nodes=4, pipe_devices=2,
            pipe_microbatches=2, distill_teacher_cache=False),
        model=tjp.load_jax_params(s_net, s_params, "student"),
        teacher=tjp.load_jax_params(t_net, t_params, "teacher"),
        noise=noise))
    started = start(out, 4, cases)
    ms = JMultiScaleNet(label_dim=4, input_size_omic_tumor=59,
                        input_size_omic_immune=361)
    refs = {"multiscale": jax_step(ms, "multiscale", ms_params, batch,
                                   multiscale_attention=True),
            "distillation": jax_step(student, "distillation", s_params,
                                     batch, teacher=(teacher, t_params),
                                     multiscale_attention=True)}
    return {"cases": {c["name"]: c for c in cases}, "ranks": finish(started),
            "jax": refs, "teacher": t_params}


@pytest.mark.parametrize("name", list(BRANCH_MODES))
def test_branch_step_matches_single_process(runs, name):
    """The two magnifications on their own ranks (with data parallelism,
    2 rows a rank): multiscale (the teacher's cross-Gram term on the 10x
    rank from the 20x maps, the students' Grams exchanged), the teacher
    (gradient modulation on each rank's own classifier, the omic
    encoders' two partial gradients summed) and the student."""
    ranks = runs["ranks"][name]
    assert ranks[0]["layout"] == ("scale", 2, 2)
    assert_matches_single(ranks, runs["cases"][name])


def test_branch_multiscale_step_matches_jax(runs):
    """The ``(data 2, scale 2)`` multiscale step against JAX's
    single-device step (``batchloss`` within 5e-4, as
    ``tests/test_torch_multiscale.py`` holds it)."""
    assert_matches_jax(runs["ranks"]["multiscale_branch"][0],
                       *runs["jax"]["multiscale"], consistency_tol=5e-4)


def test_pipe_step_matches_single_process(runs):
    """Distillation as a two-stage pipeline (stage 0 the frozen teacher,
    stage 1 the student, two microbatches, with data parallelism) against
    the single-process uncached step, its logged ``batchloss`` left out."""
    ranks = runs["ranks"]["distillation_pipe"]
    assert ranks[0]["layout"] == ("stage", 2, 2)
    assert_matches_single(ranks, runs["cases"]["distillation_pipe"],
                          skip=("batchloss",))


def test_pipe_distillation_step_matches_jax(runs):
    """The pipelined distillation step against JAX's single-device
    uncached step, from JAX's student and teacher."""
    assert_matches_jax(runs["ranks"]["distillation_pipe"][0],
                       *runs["jax"]["distillation"], skip=("batchloss",))


def test_stacked_jax_params_load_and_serve_as_unstacked(runs):
    """A JAX param tree in the ``stacked_scales`` layout (JAX's
    ``TeachersNet(stacked_scales=True)``: one ``teacher_nets`` subtree of
    leading axis 2, here the teacher's tree stacked, its structure that of
    the stacked model's init) loads into the port, which serves it as JAX's
    stacked model does (logits within 1e-4, the port's card-vs-CPU
    tolerance); ``unstack_scale_params`` inverts ``stack_scale_params``."""
    batch = global_batch(Config(**BASE).validate())
    arrays = batch_to_arrays(batch)
    x = {k: arrays[k] for k in TEACHER_INPUTS}
    model = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                         input_size_omic_immune=361, stacked_scales=True)
    params = tjp.stack_scale_params(jax.device_get(runs["teacher"]))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), **x)["params"]
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    assert "teacher_nets" in params and "teacher10_net" not in params
    want = jax.jit(model.apply)({"params": params}, **x)[2]
    port = tjp.load_jax_params(
        define_net(Config(**BASE).validate(), "cpu"),
        jax.device_get(params), "teacher")
    with torch.no_grad():
        got = port(**{k: v for k, v in batch_to_tensors(batch, "cpu").items()
                      if k in TEACHER_INPUTS})[2]
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=k)
    again = tjp.unstack_scale_params(params)
    assert set(again) == set(runs["teacher"])
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(runs["teacher"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(entry: str, args: list) -> list:
    """``python -m <the port>.<entry> args`` as ranks 0 and 1 of a group
    (the ``DMLT_*`` rendezvous on a free local port); their outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               DMLT_COORDINATOR=f"127.0.0.1:{_free_port()}",
               DMLT_NUM_PROCESSES="2")
    cmd = [sys.executable, "-m",
           f"disentangled_multimodal_learning_tpu_torch.{entry}", *args]
    procs = [subprocess.Popen(cmd, cwd=REPO,
                              env={**env, "DMLT_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def test_entries_in_a_two_process_group(tmp_path):
    """``python -m ...main --nodes 2`` in two processes (the
    ``DMLT_COORDINATOR`` rendezvous, gloo on the CPU, a tensor-parallel
    layout): rank 0 alone writes the fold's checkpoint, which is the
    single-process one (its reference names load into a fresh model); the
    serving entry in two processes: rank 0 alone restores it, evaluates
    and prints the metrics."""
    common = ["--synthetic_data", "true", "--fixdim", str(FIXDIM),
              "--batch_size", "2", "--synthetic_test_size", "2", "--debug",
              "--nodes", "2", "--device", "cpu"]
    logs = _two_ranks("main", common + [
        "--kfold", "1", "--epochs", "1", "--synthetic_train_size", "4",
        "--checkpoints", str(tmp_path / "ckpt"), "--tp_devices", "2"])
    assert "model layout, data 1 x model 2" in logs[0]
    assert "ckpt=" in logs[0] and "ckpt=" not in logs[1]
    (ckpt,) = (tmp_path / "ckpt").glob("teacher_fold_1_epoch_1_*.pt")
    payload = load_checkpoint(str(ckpt))
    assert payload["step"] == 2
    model = define_net(Config(fixdim=FIXDIM).validate(), "cpu")
    model.load_state_dict(payload["params"], strict=True)
    logs = _two_ranks("inference", common + ["--checkpoint", str(ckpt)])
    for log, lead in zip(logs, (True, False)):
        assert ("[inference] loaded checkpoint" in log) == lead
        assert ("auc_teas=" in log) == lead

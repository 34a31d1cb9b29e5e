"""The port's data parallelism, TransMIL's sequence sharding and tensor
parallelism over the 2-D attention's heads on the CPU, in gloo process
groups of 2 and 4 ranks (``tests/torch_parallel_worker.py``: one spawn of
2 ranks for the data-parallel cases, one of 4 for the ``(data 2, seq 2)``
and ``(data 2, model 2)`` cases; rendezvous through a ``FileStore`` under
the test's temporary directory).  Each sharded step is held against the
port's single-process step at the tolerances of
``tests/torch_parallel_cases.py``.  Against JAX: the data-parallel and the
tensor-parallel teacher steps against JAX's single-device step on the
global batch, from JAX's weights, at the tolerance of
``tests/test_torch_train.py`` (the loss 1e-5 relative, the gradients 1e-4
rel-L2); the ``(data 2, seq 2)`` Nystrom core against JAX's
``nystrom_attention_seq_sharded`` on ``make_dp_seq_mesh(2, 2)`` at 2e-5,
as ``tests/test_parallel.py`` holds it.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models.teacher_student import (
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.parallel.seq_shard import (
    make_dp_seq_mesh, nystrom_attention_seq_sharded as jseq_sharded)
from disentangled_multimodal_learning_tpu.train.steps import batch_to_arrays
from disentangled_multimodal_learning_tpu_torch import config as tconfig
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.ops import nystrom
from disentangled_multimodal_learning_tpu_torch.parallel import (
    mesh, seq_shard, tp_shard)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)
from torch_parallel_cases import (BASE, assert_matches_jax,
                                  assert_matches_single, finish, global_batch,
                                  jax_params, jax_step, start, step_case)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (as every port test file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX teacher init (biases nudged); the spawn of 2 ranks running
    every data-parallel case and the spawn of 4 running the ``(data 2, seq
    2)`` and ``(data 2, model 2)`` cases, started together (the teachers
    from JAX's weights); JAX's single-device teacher step on the global
    batch (gradient modulation, the consistency loss) while they run."""
    batch = global_batch(Config(**BASE).validate())
    model = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                         input_size_omic_immune=361)
    arrays = batch_to_arrays(batch)
    params = jax_params(model, {k: arrays[k] for k in (
        "x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")}, 7, 3)
    teacher = load_jax_params(define_net(Config(**BASE).validate(), "cpu"),
                              params, "teacher")
    dp = _dp_cases(tmp_path_factory.mktemp("dp2"), teacher)
    four, core = _four_cases(tmp_path_factory.mktemp("four"), teacher)
    started = (start(*dp), start(*four))
    jax_metrics, jax_grads = jax_step(model, "teacher", params, batch,
                                      gradient_modulate=True,
                                      multiscale_attention=True)
    return {"dp": ({c["name"]: c for c in dp[2]}, finish(started[0])),
            "four": ({c["name"]: c for c in four[2]}, core,
                     finish(started[1])),
            "jax": (jax_metrics, jax_grads)}


# ----------------------------------------------------------- dp 2

DP_MODES = {  # case -> config
    "teacher": dict(mode="teacher"),
    "student": dict(mode="student"),
    "distillation": dict(mode="distillation", distill_teacher_cache=False),
    "distillation_cached": dict(mode="distillation"),
    "deformpathomic": dict(mode="deformpathomic", attn_dim=1,
                           cpb_table_divisor=1),
    "multiscale": dict(mode="multiscale"),
    "transmil": dict(mode="transmil"),
    "pathomic": dict(mode="pathomic", fusion_type="pofusion"),
}


def _dp_cases(out, teacher):
    """``(out, 2, cases)``: every data-parallel case (the teacher's
    weights ``teacher``'s)."""
    return out, 2, [step_case(out, name, {**kw, "nodes": 2},
                              model=teacher if name == "teacher" else None,
                              cache=name == "distillation_cached")
                    for name, kw in DP_MODES.items()]


@pytest.fixture(scope="module")
def dp_runs(runs):
    return runs["dp"]


@pytest.mark.parametrize("name", list(DP_MODES))
def test_dp_step_matches_single_process(dp_runs, name):
    """Data parallelism over 2 ranks (2 rows each) of every training
    family: the teacher (gradient modulation, the teachers' consistency
    loss), the student (the Gram loss, DPC-KNN), distillation uncached and
    through the teacher-output cache, deformpathomic at ``attn_dim`` 1,
    multiscale, TransMIL (the pinv's maxima over both ranks' rows) and
    pathomic with BilinearFusion (BatchNorm's statistics over both
    ranks' rows) against the single-process step."""
    cases, runs = dp_runs
    assert runs[name][0]["layout"] == ("data", 2, 1)
    assert_matches_single(runs[name], cases[name])


def test_dp_teacher_step_matches_jax(runs):
    """The data-parallel teacher step against JAX's single-device step on
    the global batch, from JAX's weights (the consistency loss within
    1e-4, ``tests/test_torch_train.py``'s tolerance for it)."""
    assert_matches_jax(runs["dp"][1]["teacher"][0], *runs["jax"])


# ------------------------------------- dp 2 x seq 2 and dp 2 x tp 2

SEQ_CORE = dict(B=4, H=2, N=250, D=16, m=16)
TP_MODES = {  # case -> config
    "teacher_tp": dict(mode="teacher"),
    "teacher_tp_divisor1": dict(mode="teacher", cpb_table_divisor=1),
    "student_tp": dict(mode="student"),
    "deformpathomic_tp_vgrid": dict(mode="deformpathomic", attn_dim=2,
                                    return_vgrid=True,
                                    gradient_modulate=False),
}


def _grouped_pinv(dp):
    """The single-process pinv with JAX's ``(data, seq)`` normalisation:
    each data group's rows by their own maxima."""
    plain = nystrom.moore_penrose_pinv

    def pinv(x, iters=6, group=None):
        return torch.cat([plain(c, iters) for c in x.chunk(dp)])

    return pinv


def _four_cases(out, teacher):
    """``((out, 4, cases), core arrays)``: TransMIL's step and the bare
    core over a ``(data 2, seq 2)`` layout, and the tensor-parallel cases
    over a ``(data 2, model 2)`` one (the first teacher's weights
    ``teacher``'s)."""
    cases = [step_case(out, "transmil_dp_seq", dict(
        mode="transmil", nodes=4, seq_shard_devices=2, seq_shard_dp=2))]
    cases += [step_case(out, name, {**kw, "nodes": 4, "tp_devices": 2},
                        model=teacher if name == "teacher_tp" else None)
              for name, kw in TP_MODES.items()]
    c = SEQ_CORE
    r = np.random.default_rng(1)
    shape = (c["B"], c["H"], c["N"], c["D"])
    arrays = {"q": r.normal(size=shape).astype(np.float32) * 0.3,
              "k": r.normal(size=shape).astype(np.float32) * 0.3,
              "v": r.normal(size=shape).astype(np.float32),
              "g": r.normal(size=shape).astype(np.float32)}
    np.savez(out / "core.npz", **arrays)
    core = {"name": "core", "kind": "core", "arrays": str(out / "core.npz"),
            "dp": 2, "seq": 2, "landmarks": c["m"]}
    return (out, 4, cases + [core]), arrays


@pytest.fixture(scope="module")
def four_runs(runs):
    return runs["four"]


def test_seq_dp_transmil_step_matches_single_process(four_runs, monkeypatch):
    """TransMIL over a ``(data 2, seq 2)`` layout (its 65 tokens padded to
    256 for the 256 landmarks, a rank's chunk 128 whole segments) against
    the single-process step whose pinv normalises each data group's rows
    by their own maxima, JAX's ``seq_shard_dp`` semantics."""
    cases, _, runs = four_runs
    assert runs["transmil_dp_seq"][0]["layout"] == ("seq", 2, 2)
    monkeypatch.setattr(nystrom, "moore_penrose_pinv", _grouped_pinv(2))
    assert_matches_single(runs["transmil_dp_seq"], cases["transmil_dp_seq"])


def test_seq_dp_core_matches_jax(four_runs):
    """The sharded core (front-padded 250 -> 256 tokens, 16 landmarks of
    16 tokens, a rank's chunk 8 segments) against JAX's
    ``nystrom_attention_seq_sharded`` on a ``(data 2, seq 2)`` mesh: the
    output and the gradients of q, k and v under the cotangent ``g``
    within 2e-5."""
    _, arrays, runs = four_runs
    q, k, v, g = (jnp.asarray(arrays[n]) for n in "qkvg")
    jmesh = make_dp_seq_mesh(2, 2)

    @jax.jit
    def forward_backward(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: jseq_sharded(
            q, k, v, SEQ_CORE["m"], jmesh), q, k, v)
        return out, vjp(g)

    want, dqkv = forward_backward(q, k, v, g)
    grads = dict(zip(("dq", "dk", "dv"), dqkv))
    for rank in runs["core"]:
        off, b = rank["rows"]
        np.testing.assert_allclose(rank["out"].numpy(),
                                   np.asarray(want)[off:off + b],
                                   rtol=2e-5, atol=2e-5)
        for n, w in grads.items():
            np.testing.assert_allclose(rank[n].numpy(),
                                       np.asarray(w)[off:off + b],
                                       rtol=2e-5, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("name", list(TP_MODES))
def test_tp_step_matches_single_process(four_runs, name):
    """Tensor parallelism over the heads of every 2-D attention (4 heads a
    rank) with data parallelism (2 rows a rank): the teacher at divisor 0
    (the exact CPB) and 1 (the table), the student, and deformpathomic's
    2-D attention with its vgrids gathered for ``batch_loss_vgrid``."""
    cases, _, runs = four_runs
    assert runs[name][0]["layout"] == ("model", 2, 2)
    assert_matches_single(runs[name], cases[name])


def test_tp_teacher_step_matches_jax(runs):
    """The ``(data 2, model 2)`` teacher step against JAX's single-device
    step on the global batch, from JAX's weights."""
    assert_matches_jax(runs["four"][2]["teacher_tp"][0], *runs["jax"])


def test_tp_splits_every_2d_attention():
    """The modules a ``model`` layout splits: the teacher's four 2-D
    attentions (JAX ``count_tp_modules``), the student's two."""
    for mode, n in (("teacher", 4), ("student", 2)):
        model = define_net(Config(**BASE, mode=mode).validate(), "cpu")
        assert len(tp_shard.tp_module_names(model)) == n


# --------------------------------------------------- layout and config

def test_chunk_alignment_refusals():
    """The padded length must split into the ranks' chunks, each of whole
    landmark segments (JAX ``seq_shard.py:94-103``)."""
    assert seq_shard.check_chunks(250, 16, 2) == (6, 256, 16)
    with pytest.raises(ValueError, match="whole landmark"):
        seq_shard.check_chunks(64, 4, 8)  # 16 tokens a segment, chunks of 8
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        seq_shard.check_chunks(256, 16, 3)


def _layouts(monkeypatch, world):
    """``choose_layout`` over a fake group of ``world`` ranks, returning
    the ``make_layout`` call it makes."""
    monkeypatch.setattr(mesh, "world_rank", lambda: (world, 0))
    monkeypatch.setattr(mesh, "make_layout",
                        lambda kind, dp, inner, pinv_local=False:
                        (kind, dp, inner, pinv_local))


@pytest.mark.parametrize("world,kw,want", [
    (4, dict(mode="distillation", pipe_devices=2, tp_devices=2),
     ("stage", 2, 2, False)),
    (4, dict(mode="teacher", tp_devices=2, branch_devices=2),
     ("model", 2, 2, False)),
    (8, dict(mode="multiscale", branch_devices=2, batch_size=2),
     ("scale", 2, 2, False)),
    (4, dict(mode="transmil", seq_shard_devices=2, seq_shard_dp=2),
     ("seq", 2, 2, True)),
    (4, dict(mode="transmil", seq_shard_devices=4), ("seq", 1, 4, False)),
    (4, dict(mode="teacher", branch_devices=2, pipe_devices=2),
     ("scale", 2, 2, False)),
    (2, dict(mode="student"), ("data", 2, 1, False)),
])
def test_choose_layout_follows_jax(monkeypatch, world, kw, want):
    """JAX's precedence (``trainers.py:68-118``): the pipeline (distillation
    only), tensor parallelism, the scale branches (the two-scale modes),
    then TransMIL's token axis and data parallelism, the data axis halved
    until the batch divides."""
    _layouts(monkeypatch, world)
    cfg = Config(**{"batch_size": 4, **kw})
    assert mesh.choose_layout(cfg, has_teacher=True) == want


def test_indivisible_batch_warns_and_runs_whole(monkeypatch):
    """A batch that does not divide over the ranks: JAX's warning, and
    every rank runs the whole batch (no layout)."""
    _layouts(monkeypatch, 2)
    with pytest.warns(UserWarning, match="not divisible by the 2 processes"):
        assert mesh.choose_layout(Config(batch_size=3)) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mesh.choose_layout(Config(batch_size=4)) == ("data", 2, 1,
                                                            False)


def test_config_takes_the_parallel_keys():
    """``LATER`` is empty: the cluster keys JAX reads are fields, at any
    value; the ones it reads nowhere are ignored with their reason."""
    assert tconfig.LATER == {}
    cfg = Config.from_dict({"seq_shard_devices": 4, "seq_shard_dp": 2,
                            "tp_devices": 2, "branch_devices": 2,
                            "pipe_devices": 2, "pipe_microbatches": 4,
                            "nodes": 3, "gpus": 8, "world_size": 8})
    assert (cfg.seq_shard_devices, cfg.seq_shard_dp, cfg.tp_devices,
            cfg.branch_devices, cfg.pipe_devices, cfg.pipe_microbatches,
            cfg.nodes) == (4, 2, 2, 2, 2, 4, 3)
    assert "reads it nowhere" in tconfig.IGNORED["gpus"]

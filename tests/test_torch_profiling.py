"""The port's span recorder (``utils/profiling.py``) on the CPU: when spans
record, their parents, the bounded buffer, the clock shared with the
profiler's events, the ``h2d`` byte counts of ``batch_to_tensors`` and
``model_inputs`` and their CPU tensors, the slices the card's staging
copies, the set-up spans, and the read-back of device marks
(with stand-ins for CUDA events: the card's own marks are checked in
``tests/test_torch_cuda.py``)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.ops import build
from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
    model_inputs)
from disentangled_multimodal_learning_tpu_torch.train import steps
from disentangled_multimodal_learning_tpu_torch.train.optim import (
    make_optimizer)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    MODEL_INPUTS, batch_to_tensors)
from disentangled_multimodal_learning_tpu_torch.utils import profiling

CPU = torch.device("cpu")
MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_recorder():
    """Each test starts from an empty buffer with tracing off, and leaves
    it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def batch():
    return SyntheticBagDataset(size=2, fixdim=16, path_dim=8, seed=0).batch(
        [0, 1])


def _names():
    return [s.name for s in profiling.spans()]


def test_nothing_records_while_tracing_is_off(batch):
    assert not profiling.tracing()
    with profiling.span("chunk") as s:
        assert s is None
        profiling.device_mark("step.start", CPU)
    batch_to_tensors(batch, CPU)
    model_inputs(batch, CPU, "teacher")
    assert profiling.spans() == []
    assert profiling.dropped() == profiling.unresolved() == 0


def test_spans_record_with_their_parents_under_the_profiler(batch):
    """Under a CPU ``torch.profiler`` (and after ``enable``, without one)
    each span records with the index of the span open when it began."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
        with profiling.span("eval_batch") as outer:
            batch_to_tensors(batch, CPU)
            with profiling.span("chunk", bytes=3) as inner:
                pass
        batch_to_tensors(batch, CPU)
    assert not profiling.tracing()
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("eval_batch", -1), ("h2d", 0), ("chunk", 0), ("h2d", -1)]
    assert got[0] is outer and got[2] is inner
    assert inner.counts == {"bytes": 3}
    assert all(s.start_ns <= s.end_ns for s in got)
    assert got[0].start_ns <= got[1].start_ns <= got[1].end_ns \
        <= got[2].start_ns <= got[2].end_ns <= got[0].end_ns
    profiling.enable(True)
    batch_to_tensors(batch, CPU)
    profiling.enable(False)
    batch_to_tensors(batch, CPU)
    assert _names() == ["eval_batch", "h2d", "chunk", "h2d", "h2d"]


def test_a_full_buffer_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.enable(True)
    handles = []
    for i in range(5):
        with profiling.span("h2d", bytes=i) as s:
            handles.append(s)
    assert [s.counts["bytes"] for s in profiling.spans()] == [0, 1, 2]
    assert handles[3:] == [None, None]
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_share_the_buffer_without_losing_a_span(monkeypatch):
    """32 threads (more than the cores) record nested spans at once with a
    short switch interval: every span is kept or counted as dropped, and
    each inner span's parent is its own thread's outer span."""
    import sys
    import threading

    monkeypatch.setattr(profiling, "CAPACITY", 4000)
    profiling.enable(True)

    def work(i):
        for _ in range(100):
            with profiling.span("outer", thread=i):
                with profiling.span("inner", thread=i):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = profiling.spans()
    assert len(got) == 4000 and profiling.dropped() == 2400
    for s in got:
        if s.name == "inner" and s.parent >= 0:
            assert got[s.parent].name == "outer"
            assert got[s.parent].counts == s.counts


def test_a_span_encloses_its_own_annotation_on_the_profilers_clock(batch):
    """Under the profiler a span opens a ``record_function`` of its name;
    the span's stamps and the annotation's kineto times are one clock, so
    the span encloses its annotation within 1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch_to_tensors(batch, CPU)
        with profiling.span("chunk"):
            torch.ones(64, 64).sum()
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    for s in profiling.spans():
        start, end = events[s.name]
        assert s.start_ns - MS <= start <= end <= s.end_ns + MS, s.name
        assert abs(start - s.start_ns) < MS and abs(end - s.end_ns) < MS


def test_h2d_counts_the_host_arrays_bytes(batch):
    profiling.enable(True)
    batch_to_tensors(batch, CPU)
    want = sum(getattr(batch, k).nbytes for k in (
        "x_path10", "x_path20", "x_omic_tumor", "x_omic_immune", "x_omic",
        "label"))
    for mode in ("teacher", "student", "deformpathomic", "omic"):
        model_inputs(batch, CPU, mode)
    got = profiling.spans()
    assert [s.name for s in got] == ["h2d"] * 5
    assert got[0].counts == {"bytes": want, "staged": 0}
    for s, mode in zip(got[1:], ("teacher", "student", "deformpathomic",
                                 "omic")):
        assert s.counts == {"bytes": sum(
            getattr(batch, key).nbytes
            for key in MODEL_INPUTS[mode].values()), "staged": 0}, mode
    assert got[2].counts["bytes"] == batch.x_path10.nbytes * 2


@pytest.mark.parametrize("mode", ["teacher", "student", "deformpathomic",
                                  "transmil", "omic"])
def test_cpu_inputs_are_the_host_arrays(batch, mode):
    """On the CPU nothing is staged: each forward input is its host array
    itself, and of the step's tensors every field but the int64 labels."""
    got = model_inputs(batch, CPU, mode)
    for arg, key in MODEL_INPUTS[mode].items():
        assert np.shares_memory(got[arg].numpy(), getattr(batch, key)), arg
    step = batch_to_tensors(batch, CPU)
    for key, t in step.items():
        assert np.shares_memory(t.numpy(), getattr(batch, key)) == (
            key != "label"), key
    assert step["label"].dtype == torch.int64


# (shape, dtype) -> the slices the card's staging fills and copies: a bag
# a slice for a field of several bags of at least 4 MiB (the preset's
# 2,500 x 1,024 f32 bags), the whole field otherwise
SLICES_CASES = [
    ((16, 2500, 1024), np.float32, list(range(16))),
    ((4, 1600, 1024), np.float32, list(range(4))),
    ((1, 2500, 1024), np.float32, [...]),
    ((16, 1000, 1024), np.float32, [...]),
    ((4096, 431), np.float32, [...]),
    ((16, 12), np.int32, [...]),
    ((), np.float32, [...]),
]


@pytest.mark.parametrize("shape,dtype,want", SLICES_CASES)
def test_staging_slices_follow_the_bag_size(shape, dtype, want):
    """``_slices`` of the host array and of its tensor (zero-stride
    stand-ins of the full size)."""
    a = np.broadcast_to(np.zeros((), dtype), shape)
    assert steps._slices(a) == want
    assert steps._slices(torch.from_numpy(np.zeros((), dtype)).expand(
        shape)) == want


def test_setup_spans_record_with_tracing_off(monkeypatch, tmp_path):
    """``make_optimizer`` and the kernel library's first load (stood in
    for: no ``nvcc`` here) record their set-up spans whatever the switch
    says; ``built`` is 1 where the library had to be built."""
    make_optimizer(Config(optimizer="adamw").validate(),
                   [torch.nn.Parameter(torch.ones(2))])
    monkeypatch.setattr(build, "library_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_load", lambda path: ("library", path))
    built = []

    def fake_build():
        built.append(True)
        (tmp_path / build.LIB_NAME).touch()
        return tmp_path / build.LIB_NAME

    monkeypatch.setattr(build, "build", fake_build)
    for _ in range(2):  # each a process's first load
        monkeypatch.setattr(build, "_lib", None)
        assert build.kernels() == ("library", tmp_path / build.LIB_NAME)
        assert build.kernels() == ("library", tmp_path / build.LIB_NAME)
    got = profiling.spans()
    assert [s.name for s in got] == ["setup.optimizer", "setup.kernels",
                                     "setup.kernels"]
    assert [s.counts for s in got[1:]] == [{"built": 1}, {"built": 0}]
    assert len(built) == 2


class _Event:
    """A stand-in for a timed CUDA event: ``t`` ms, or None until done."""

    def __init__(self, t=None):
        self.t = t

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return other.t - self.t


def test_marks_read_back_when_done_and_unresolved_before_a_replay():
    """A span's marks are read back as ms after its first once every event
    has completed; a graph's, not completed before the graph replays
    again, are counted as unresolved and left out; eager ones wait."""
    profiling.enable(True)
    graph, other = object(), object()
    with profiling.span("chunk") as first:
        pass
    with profiling.span("chunk") as second:
        pass
    with profiling.span("eval_batch") as eager:
        pass
    done = [("step.start", _Event(2.0)), ("step.loss", _Event(3.5)),
            ("step.end", _Event(7.0))]
    late = [("step.start", _Event(1.0)), ("step.end", _Event())]
    profiling.attach(first, done, graph)
    profiling.attach(second, late, graph)
    profiling.attach(eager, [("forward.start", _Event(0.0)),
                             ("forward.end", _Event())])
    profiling.attach(None, done, graph)  # nothing recorded: nothing kept
    profiling.resolve(other)
    assert first.marks == [("step.start", 0.0), ("step.loss", 1.5),
                           ("step.end", 5.0)]
    assert second.marks == [] and profiling.unresolved() == 0
    profiling.resolve(graph)
    assert second.marks == [] and profiling.unresolved() == 1
    assert eager.marks == []
    eager_end = profiling._pending[0][1][1][1]
    eager_end.t = 4.0
    profiling.spans()
    assert eager.marks == [("forward.start", 0.0), ("forward.end", 4.0)]
    assert profiling._pending == []


def test_layer_marks_read_back_apart_from_the_step_marks():
    """A layer's marks (a capture's ``Marks.layer``) read back into
    ``layer_marks`` on the clock of the span's step marks, and leave the
    run of step marks unbroken; a span with layer marks alone reads them
    after its first."""
    profiling.enable(True)
    graph = object()
    with profiling.span("chunk") as chunk:
        pass
    with profiling.span("eval_batch") as eager:
        pass
    marks = profiling.Marks()
    marks += [("step.start", _Event(2.0)), ("step.loss", _Event(9.0))]
    marks.layer += [("nystrom.fwd.start", _Event(3.0)),
                    ("nystrom.fwd.end", _Event(5.5))]
    profiling.attach(chunk, marks, graph)
    alone = profiling.Marks()
    alone.layer += [("nystrom.fwd.start", _Event(1.0)),
                    ("nystrom.fwd.end", _Event(1.25))]
    profiling.attach(eager, alone)
    profiling.spans()
    assert chunk.marks == [("step.start", 0.0), ("step.loss", 7.0)]
    assert chunk.layer_marks == [("nystrom.fwd.start", 1.0),
                                 ("nystrom.fwd.end", 3.5)]
    assert eager.marks == []
    assert eager.layer_marks == [("nystrom.fwd.start", 0.0),
                                 ("nystrom.fwd.end", 0.25)]
    assert profiling._pending == [] and not profiling.capturing()


def test_eager_marks_need_a_card_and_an_open_span():
    profiling.enable(True)
    profiling.device_mark("step.start", CPU)  # no span open
    with profiling.span("eval_batch") as s:
        profiling.device_mark("forward.start", CPU)  # not a card
    assert s.marks == [] and profiling._pending == []


def test_the_chrome_trace_holds_the_span_names(batch, tmp_path):
    with profiling.trace(str(tmp_path)) as path:
        with profiling.span("eval_batch"):
            batch_to_tensors(batch, CPU)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"eval_batch", "h2d"} <= names
    assert _names() == ["eval_batch", "h2d"]
    assert np.all([s.end_ns > s.start_ns for s in profiling.spans()])

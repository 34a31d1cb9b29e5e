"""The readers of the program's own spans (``spans.py`` and the metrics
that use it) on a synthetic trace and synthetic spans: known bytes, gaps
and marks give known numbers, and a run with nothing to read gives
None."""

import pytest

from bench_port import harness, spans
from bench_port import trace as tr
from disentangled_multimodal_learning_tpu_torch.utils.profiling import Span

MS = 1_000_000  # ns


def _span(name, start, end, parent=-1, marks=(), **counts):
    s = Span(name, start, parent, counts)
    s.end_ns, s.marks = end, list(marks)
    return s


def _steps(*parts):
    """Step marks of consecutive steps, each ``(fwd, bwd, opt)`` ms."""
    out, t = [], 0.0
    for fwd, bwd, opt in parts:
        for name, dt in zip(spans.STEP_MARKS, (0.0, fwd, bwd, opt)):
            t += dt
            out.append((name, t))
        t += 0.1
    return out


# train: 2 traced calls of 4 updates; two h2d spans of 1 GB each, 10 and
# 20 ms on the host; the card busy over [0, 100], [300, 550] and [600,
# 850] ms of a 1 s stretch, the last two HtoD copies (0.5 s)
TRAIN_SPANS = [
    _span("setup.kernels", -5000 * MS, -3000 * MS, built=1),
    _span("setup.optimizer", -2000 * MS, -1500 * MS),
    _span("setup.capture", -1000 * MS, -750 * MS),
    _span("h2d", 150 * MS, 160 * MS, bytes=10 ** 9),
    _span("h2d", 330 * MS, 350 * MS, bytes=10 ** 9),
    _span("chunk", 360 * MS, 361 * MS,
          marks=_steps((1.0, 2.0, 0.5), (1.0, 3.0, 1.0))),
    _span("chunk", 900 * MS, 901 * MS,
          marks=_steps((2.0, 4.0, 0.75))),
]
TRAIN_DEVICE = [("k1", 0, 100 * MS),
                ("Memcpy HtoD (Pageable -> Device)", 300 * MS, 550 * MS),
                ("Memcpy HtoD (Pageable -> Device)", 600 * MS, 850 * MS)]
# eval: 4 traced batches, each an eval_batch span with an h2d inside
EVAL_SPANS = [_span("setup.kernels", -3000 * MS, -2500 * MS, built=0)]
for i, fwd in enumerate((5.0, 7.0, 6.0, 9.0)):
    EVAL_SPANS += [
        _span("eval_batch", 200 * i * MS, (200 * i + 150) * MS,
              marks=[("forward.start", 0.0), ("forward.end", fwd)]),
        _span("h2d", 200 * i * MS, (200 * i + 40) * MS,
              parent=len(EVAL_SPANS), bytes=2 * 10 ** 8)]
EVAL_DEVICE = [("Memcpy HtoD (Pageable -> Device)", 200 * i * MS,
                (200 * i + 20) * MS) for i in range(4)] + [
    ("k3", (200 * i + 30) * MS, (200 * i + 100) * MS) for i in range(4)]


def _run(train: bool, trace=True):
    device = TRAIN_DEVICE if train else EVAL_DEVICE
    return harness.Run(
        cell=None, setup_s=10.0, bags_per_call=16,
        updates_per_call=4 if train else 0, spans=[], window_s=20.0,
        calls=100, forward_done=[],
        trace=tr.Trace(device, [], 1.0) if trace else None,
        traced_calls=2 if train else 4)


@pytest.fixture
def program(monkeypatch):
    """Hand the readers ``program.spans`` in place of the port's buffer
    (None: a program that keeps no spans)."""
    class Program:
        spans = []

    monkeypatch.setattr(spans, "program_spans", lambda: Program.spans)
    return Program


# metric -> (train cell's value, eval cell's value); None: nothing to read
WANT = {
    # 2 GB over 0.5 s of HtoD; 0.8 GB over 0.08 s
    "h2d_gbps.train": (4.0, None), "h2d_gbps.eval": (None, 10.0),
    # 30 ms over 8 updates; 160 ms over 4 batches
    "h2d_host_ms.train": (3.75, None), "h2d_host_ms.eval": (None, 40.0),
    # the three replayed updates' medians
    "fwd_ms.train": (1.0, None), "bwd_ms.train": (3.0, None),
    "opt_ms.train": (0.75, None),
    # the four batches' forwards
    "fwd_ms.eval": (None, 6.5),
    # h2d [150, 160] ms all idle (10); [330, 350] ms under a copy (0)
    # eval: each h2d's [20, 30] of 40 ms idle, 4 x 10 ms of the second
    "idle_in_h2d_pct.train": (1.0, None),
    "idle_in_h2d_pct.eval": (None, 4.0),
    "setup_kernels_s": (2.0, 0.5), "setup_optimizer_s": (0.5, None),
    "setup_capture_s": (0.25, None),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_every_reader_reads_its_number(program, name):
    read = harness.reader(name)
    for train, want in zip((True, False), WANT[name]):
        program.spans = TRAIN_SPANS if train else EVAL_SPANS
        got = read(_run(train))
        if want is None:
            assert got is None, (name, train)
        else:
            assert got == pytest.approx(want, rel=1e-9), (name, train)


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_gives_none(program, name):
    """No recorder in the program (the parent of this metric), an empty
    buffer, and no trace (the hot-path readers)."""
    read = harness.reader(name)
    for train in (True, False):
        program.spans = None
        assert read(_run(train)) is None
        program.spans = []
        assert read(_run(train)) is None
        if not name.startswith("setup_"):
            program.spans = TRAIN_SPANS if train else EVAL_SPANS
            assert read(_run(train, trace=False)) is None


def test_marks_missing_or_unread_are_left_out(program):
    """A replay whose marks were not read back (empty) or are cut adds no
    step."""
    program.spans = [
        _span("chunk", 0, 1),
        _span("chunk", 1, 2, marks=_steps((1.0, 2.0, 3.0))[:3]),
        _span("chunk", 2, 3, marks=_steps((4.0, 5.0, 6.0)))]
    assert spans.step_ms(_run(True), 1) == 5.0


def test_the_port_reports_what_its_buffer_lost(capsys, monkeypatch):
    """``program_spans`` reads the port's own buffer, and says once how
    many spans it dropped and replays it left out."""
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    monkeypatch.setattr(spans, "_reported", False)
    profiling.reset()
    with profiling.span("setup.kernels", always=True):
        pass
    got = spans.program_spans()
    assert [s.name for s in got] == ["setup.kernels"]
    spans.program_spans()
    err = capsys.readouterr().err
    assert err.count("program spans 1 dropped 0 unresolved replays 0") == 1
    profiling.reset()

"""What the readers of the program's own spans share
(``disentangled_multimodal_learning_tpu_torch/utils/profiling.py``).

The program records its hot-path spans and device marks only while a
``torch.profiler`` is active, so in a traced run they cover the profiled
stretch, and its set-up spans always.  A reader calls
:func:`program_spans` in the run's own process, after the window's
synchronize; where the program has no recorder, or recorded nothing that
the reader reads, the reader returns None.  A span is read by its
attributes: ``name``, ``start_ns`` and ``end_ns`` (the profiler's clock,
the one of ``Trace.device``), ``parent``, ``counts`` and ``marks``
(``[(name, ms after the span's first mark)]``)."""

from __future__ import annotations

import bisect
import statistics
import sys

from . import readers
from . import trace as tr

# the train step's marks in a replay, in order, and the eval forward's
STEP_MARKS = ("step.start", "step.loss", "step.optimizer", "step.end")
FORWARD_MARKS = ("forward.start", "forward.end")

_reported = False


def program_spans():
    """The program's recorded spans, or None where it keeps none."""
    global _reported
    try:
        from disentangled_multimodal_learning_tpu_torch.utils import \
            profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    out = profiling.spans()
    if not _reported:  # once a run: what the buffer lost
        _reported = True
        print(f"program spans {len(out)} dropped {profiling.dropped()} "
              f"unresolved replays {profiling.unresolved()}",
              file=sys.stderr)
    return out


def named(name: str) -> list:
    return [s for s in program_spans() or () if s.name == name]


def _h2d(run, train: bool):
    """The ``h2d`` spans of a traced run of the right kind, or None."""
    if readers.is_train(run) != train or run.trace is None:
        return None
    return named("h2d") or None


def h2d_gbps(run, train: bool):
    """The host bytes of the ``h2d`` spans over the HtoD copies' device
    time in the profiled stretch, in GB/s."""
    spans = _h2d(run, train)
    if spans is None:
        return None
    seconds = tr.total_s([ev for ev in run.trace.device if tr.is_h2d(ev[0])])
    n = sum(s.counts.get("bytes", 0) for s in spans)
    return n / seconds / 1e9 if seconds > 0 and n else None


def h2d_host_ms(run, train: bool):
    """Host ms inside ``h2d`` spans, an update (training) or a batch."""
    spans = _h2d(run, train)
    if spans is None:
        return None
    return readers.per_traced(
        run, train, sum(s.end_ns - s.start_ns for s in spans) / 1e9)


def idle_in_h2d_pct(run, train: bool):
    """Share of the profiled stretch in which the card runs no kernel and
    no copy while the host is inside an ``h2d`` span, in %."""
    spans = _h2d(run, train)
    if spans is None:
        return None
    busy = tr.busy_intervals(run.trace.device)
    ends = [e for _, e in busy]
    idle_ns = 0
    for a, b in tr.busy_intervals([(s.name, s.start_ns, s.end_ns)
                                   for s in spans]):
        idle_ns += b - a
        for start, end in busy[bisect.bisect_right(ends, a):]:
            if start >= b:
                break
            idle_ns -= min(b, end) - max(a, start)
    return 100.0 * idle_ns / 1e9 / run.trace.stretch_s


def mark_steps(spans, names) -> list:
    """Each complete run of the marks ``names``, in order, in each span's
    marks: ``[[ms between consecutive marks]]``."""
    out = []
    for s in spans:
        marks = list(s.marks)
        for i in range(len(marks) - len(names) + 1):
            if tuple(n for n, _ in marks[i:i + len(names)]) == names:
                t = [ms for _, ms in marks[i:i + len(names)]]
                out.append([b - a for a, b in zip(t, t[1:])])
    return out


def step_ms(run, part: int):
    """The median over the profiled stretch's replayed updates of the
    device ms of a step's ``part``: 0 the forward and loss, 1 the backward
    (with the zero fills and the modulation), 2 the optimizer."""
    if not readers.is_train(run) or run.trace is None:
        return None
    steps = mark_steps(named("chunk"), STEP_MARKS)
    return statistics.median(s[part] for s in steps) if steps else None


def forward_ms(run):
    """The median over the profiled stretch's batches of the forward's
    device ms."""
    if readers.is_train(run) or run.trace is None:
        return None
    fwd = mark_steps(named("eval_batch"), FORWARD_MARKS)
    return statistics.median(f[0] for f in fwd) if fwd else None


def setup_span_s(name: str, train_only: bool = False):
    """A reader of the set-up span ``name``'s seconds (the first one)."""
    def read(run):
        if train_only and not readers.is_train(run):
            return None
        spans = named(name)
        return (spans[0].end_ns - spans[0].start_ns) / 1e9 if spans else None

    return read

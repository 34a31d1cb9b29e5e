"""What the readers of the Nystrom cores share (TransMIL's cell): the
layer marks that the program records around each core call's forward and
backward inside a graph replay (``Span.layer_marks`` of each ``chunk``
span, on the clock of its step marks: the port's ``utils/profiling.py``),
the core calls that a replay adds (the span's count ``nystrom_calls``),
and TransMIL's flops
(``counts/transmil_flops.py``).  Where the program records no layer marks,
or the cell is not TransMIL's, a reader returns None."""

from __future__ import annotations

import statistics

from . import readers, spans
from .counts import transmil_flops
from .counts.peaks import BF16_DENSE_FLOPS_PER_S

CORE = "nystrom"


def _intervals(marks) -> list:
    """``[(start, end)]`` ms of each core forward and backward in
    ``marks``: each ``.start`` paired with the next ``.end`` of its part."""
    out = []
    for part in ("fwd", "bwd"):
        start = None
        for name, ms in marks:
            if name == f"{CORE}.{part}.start":
                start = ms
            elif name == f"{CORE}.{part}.end" and start is not None:
                out.append((start, ms))
                start = None
    return out


def update_ms(span) -> list:
    """The cores' marked ms in each update of a replay: the intervals that
    start between the update's ``step.start`` and ``step.end``."""
    first, last = spans.STEP_MARKS[0], spans.STEP_MARKS[-1]
    starts = [ms for name, ms in span.marks if name == first]
    ends = [ms for name, ms in span.marks if name == last]
    cores = _intervals(getattr(span, "layer_marks", ()))
    return [sum(e - s for s, e in cores if a <= s <= b)
            for a, b in zip(starts, ends)]


def _replays(run):
    """The traced replays whose layer marks were read back, or None."""
    if (not readers.is_train(run) or run.trace is None
            or run.cell.settings.get("mode") != "transmil"):
        return None
    return [s for s in spans.named("chunk")
            if getattr(s, "layer_marks", None)] or None


def core_ms(run):
    """The median over the traced replays' updates of the cores' marked
    device ms."""
    replays = _replays(run)
    if replays is None:
        return None
    per_update = [ms for s in replays for ms in update_ms(s)]
    return statistics.median(per_update) if per_update else None


def roofline_pct(run):
    """The cores' bound times their counted calls over their marked device
    time in the traced replays, in %."""
    replays = _replays(run)
    if replays is None:
        return None
    calls = sum(s.counts.get(f"{CORE}_calls", 0) for s in replays)
    seconds = sum(e - s for r in replays
                  for s, e in _intervals(r.layer_marks)) / 1e3
    if not calls or seconds <= 0:
        return None
    bound = transmil_flops.core_bound(run.cell.settings,
                                      readers.batch_bags(run))
    return 100.0 * bound * calls / seconds


def mfu_pct(run):
    """TransMIL's model flops of the updates before the profiler over their
    window, against the dense bf16 peak, in %."""
    settings = run.cell.settings
    if (not readers.is_train(run) or not run.calls
            or settings.get("mode") != "transmil"):
        return None
    flops = (transmil_flops.train(settings, readers.batch_bags(run))
             * run.updates_per_call)
    return 100.0 * flops * run.calls / run.window_s / BF16_DENSE_FLOPS_PER_S

"""The device trace of a run's profiled stretch, reduced from
``torch.profiler``'s events in memory (no Chrome trace is written).

``Trace.device`` holds every operation that ran on the card (kernels,
copies, sets) as ``(name, start_ns, end_ns)``; ``Trace.host`` holds the
host's operator events of the main thread, for naming what the host was
doing while the card sat idle."""

from __future__ import annotations

import re
from typing import NamedTuple


class Trace(NamedTuple):
    device: list   # [(name, start_ns, end_ns)]
    host: list     # [(name, start_ns, end_ns)]
    stretch_s: float


def collect(prof, stretch_s: float) -> Trace:
    """``prof``: a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU and not e.is_user_annotation():
            tid = e.start_thread_id()
            host.append((e.name(), start, end, tid))
    # the main thread: the one with the most operator events
    tids: dict = {}
    for *_, tid in host:
        tids[tid] = tids.get(tid, 0) + 1
    main = max(tids, key=tids.get) if tids else None
    host = [(n, s, t) for n, s, t, tid in host if tid == main]
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Trace(device, host, stretch_s)


def busy_intervals(events) -> list:
    """The union of ``events``' ``(start, end)`` intervals, in order."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace.device)) / 1e9


def matching(trace: Trace, names) -> list:
    """The device events whose name holds one of ``names`` as a whole
    identifier."""
    if not names:
        return []
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")
    return [ev for ev in trace.device if pat.search(ev[0])]


def total_s(events) -> float:
    return sum(e - s for _, s, e in events) / 1e9


def is_h2d(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


def top_ops(trace: Trace, n: int = 10) -> list:
    """The ``n`` device operations that took most time, by name."""
    by_name: dict = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[_short(name), ns / 1e9] for name, ns in top]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """The ``n`` longest idle gaps between device operations, each named
    by the innermost host operation running at its start."""
    busy = busy_intervals(trace.device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        inner = [h for h in trace.host if h[1] <= s < h[2]]
        name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                else "host outside any operator")
        out.append([_short(name), (e - s) / 1e9])
    return out


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."

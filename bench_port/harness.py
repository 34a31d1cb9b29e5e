"""The benchmark's machinery, driven by data: ``BENCHMARK.json`` names the
cells and metrics; a cell's traffic is ``workloads/<cell>.json``, its
configuration ``configs/<config>.json`` with the plain reference that the
configuration names (``reference/<module>.py``), its driver
``drivers/<driver>.py``, and every metric a reader ``metrics/<name>.py``
whose ``read(run)`` returns the number, or None where the run has nothing
to read.

One run: set-up (the driver builds the program and warms up every shape
the cell uses), a window of ``--seconds`` of timed calls, the failures
counted, the program's state freed, the comparison with the reference,
and the check that no JAX module was loaded.  With ``--trace 1`` the
profiler covers the window's last ``PROFILE_S`` seconds (at most half of
it) and the per-layer metrics are read instead of the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
PACKAGE = "bench_port"
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "disentangled_multimodal_learning_tpu")
# the profiled stretch at the end of a traced run's window, in seconds
PROFILE_S = 1.5


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict      # the cell's entry in BENCHMARK.json
    traffic: dict    # workloads/<cell>.json
    config: dict     # configs/<config>.json
    settings: dict   # the configuration's settings, as run
    reference: object
    driver: object


def load_manifest(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict, settings_override=None) -> Cell:
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(entries)}")
    entry = entries[name]
    traffic = _json(ROOT / "workloads" / f"{name}.json")
    config = _json(ROOT / "configs" / f"{entry['config']}.json")
    settings = dict(config["settings"])
    settings.update(settings_override or {})
    reference = importlib.import_module(
        f"{PACKAGE}.reference.{config['reference']}")
    driver = importlib.import_module(f"{PACKAGE}.drivers.{traffic['driver']}")
    return Cell(name, entry, traffic, config, settings, reference, driver)


def metrics_of(cell: str, manifest: dict, trace: bool) -> list:
    """The metric entries a cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; an entry without ``workloads`` is
    every cell's."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.metrics.reader_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def process_age_s() -> float:
    """Seconds since this process started (Linux: from ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    bags_per_call: int
    updates_per_call: int
    spans: list            # [(start, end)] host clock of every timed call
    window_s: float        # the untraced stretch, closed by a synchronize
    calls: int             # calls in that stretch
    forward_done: list     # eval: host clock when each forward returned
    trace: object = None   # trace.Trace of the profiled stretch
    traced_calls: int = 0
    launches: dict = dataclasses.field(default_factory=dict)


def timed_window(session, seconds: float, profile_s: float = 0.0):
    """Run timed calls for ``seconds``; with ``profile_s``, the calls from
    ``seconds - profile_s`` on run under the profiler, for ``profile_s``
    after it has started.  Returns ``(spans, window_s, calls, trace,
    traced_calls, launches)``: ``window_s`` and ``calls`` are of the
    stretch before the profiler (the whole window without one), both
    stretches closed by a synchronize."""
    spans = []
    t0 = time.perf_counter()
    untraced = seconds - profile_s if profile_s else seconds
    while time.perf_counter() - t0 < untraced:
        a = time.perf_counter()
        session.call()
        spans.append((a, time.perf_counter()))
    session.sync()
    window_s, calls = time.perf_counter() - t0, len(spans)
    if not profile_s:
        return spans, window_s, calls, None, 0, {}
    from . import trace as tr

    prof, counts0, tp = _start_profiler()
    while time.perf_counter() - tp < profile_s:
        a = time.perf_counter()
        session.call()
        spans.append((a, time.perf_counter()))
    session.sync()
    end = time.perf_counter()
    prof.stop()
    launches = _launch_delta(counts0)
    return (spans, window_s, calls, tr.collect(prof, end - tp),
            len(spans) - calls, launches)


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from disentangled_multimodal_learning_tpu_torch.ops import launches

    counts0 = launches.counts()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof, counts0, time.perf_counter()


def _launch_delta(counts0: dict) -> dict:
    from disentangled_multimodal_learning_tpu_torch.ops import launches

    now = launches.counts()
    return {k: now[k] - counts0.get(k, 0) for k in now
            if now[k] - counts0.get(k, 0)}


def device_line(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: Cell, manifest: dict, seed: int, seconds: float,
             trace: bool, device, setup_clock=process_age_s) -> dict:
    """One run of ``cell``: the result line's object, with ``compared``
    (name -> value and limit) as its last key."""
    import torch

    device = torch.device(device)
    session = cell.driver.start(cell, seed, device)
    setup_s = setup_clock()
    spans, window_s, calls, tr, traced_calls, launches = timed_window(
        session, seconds, min(PROFILE_S, 0.5 * seconds) if trace else 0)
    failed = session.failed()
    dev = device_line(device)
    run = Run(cell, setup_s, session.bags_per_call,
              session.updates_per_call, spans, window_s, calls,
              list(getattr(session, "forward_done", [])), tr, traced_calls,
              launches)
    metrics = {}
    for m in metrics_of(cell.name, manifest, trace):
        value = reader(m["name"])(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": False, "attempted": len(spans), "failed": failed,
            "metrics": metrics, "device": dev}
    if tr is not None:
        from . import trace as trmod

        dev["busy_s"] = trmod.busy_s(tr)
        dev["window_s"] = tr.stretch_s
        line["breakdown"] = {"device_ops": trmod.top_ops(tr),
                             "idle_gaps": trmod.idle_gaps(tr)}
    session.release()
    values = session.check()
    limits = cell.traffic["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    line["correct"] = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    line["setup_phases"] = getattr(session, "phases", {})
    if tr is not None:  # the profiled stretch's kernel launches, by wrapper
        line["launches"] = launches
    line["compared"] = compared
    return line


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive)."""
    values = sorted(values)
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]

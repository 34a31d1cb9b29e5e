"""What the metric readers under ``metrics/`` share.  Each reader takes
the ``harness.Run`` of one run and returns a number, or None where the
run has nothing for it to read (a train metric in an eval cell, a
device metric without a trace)."""

from __future__ import annotations

from . import trace as tr
from .counts import kernels, model_flops
from .counts.peaks import BF16_DENSE_FLOPS_PER_S


def is_train(run) -> bool:
    return run.updates_per_call > 0


def bags_per_s(run, train: bool):
    if is_train(run) != train or not run.calls:
        return None
    return run.calls * run.bags_per_call / run.window_s


def call_ms(run):
    """Host ms of each timed call before the profiler."""
    return [1e3 * (b - a) for a, b in run.spans[:run.calls]]


def batch_bags(run) -> int:
    """Bags of one batch: of one update in training."""
    return run.bags_per_call // max(run.updates_per_call, 1)


def mfu_pct(run, train: bool):
    """Model flops of the calls before the profiler over their window,
    against the dense bf16 peak, in %."""
    if is_train(run) != train or not run.calls:
        return None
    settings = run.cell.settings
    if train:
        flops = model_flops.train(settings, batch_bags(run)) \
            * run.updates_per_call
    else:
        flops = model_flops.forward(settings, batch_bags(run))
    return 100.0 * flops * run.calls / run.window_s / BF16_DENSE_FLOPS_PER_S


def per_traced(run, train: bool, seconds: float):
    """``seconds`` of the profiled stretch a traced update (training) or
    batch (eval), in ms."""
    if is_train(run) != train or run.trace is None or not run.traced_calls:
        return None
    per = run.traced_calls * (run.updates_per_call if train else 1)
    return 1e3 * seconds / per


def h2d_ms(run, train: bool):
    if run.trace is None:
        return None
    copies = [ev for ev in run.trace.device if tr.is_h2d(ev[0])]
    return per_traced(run, train, tr.total_s(copies))


def roofline_pct(run, train: bool):
    """The hand kernels' summed bounds over their summed device time in
    the profiled stretch, in %."""
    if is_train(run) != train or run.trace is None:
        return None
    settings, bags = run.cell.settings, batch_bags(run)
    known = {k: n for k, n in run.launches.items()
             if k in kernels.LAUNCH_BOUNDS}
    if not known:
        return None
    bound = sum(n * kernels.LAUNCH_BOUNDS[k](settings, bags)
                for k, n in known.items())
    names = sorted({name for k in known for name in kernels.KERNEL_NAMES[k]})
    seconds = tr.total_s(tr.matching(run.trace, names))
    return 100.0 * bound / seconds if seconds > 0 else None


def idle_pct(run, train: bool):
    if is_train(run) != train or run.trace is None:
        return None
    return 100.0 * (1.0 - tr.busy_s(run.trace) / run.trace.stretch_s)

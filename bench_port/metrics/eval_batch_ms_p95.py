"""The 95th percentile of the window's batches before the profiler, each
timed on the host clock from the hand-over of the host batch to its
logits on the host."""

from bench_port import harness, readers


def read(run):
    if readers.is_train(run) or not run.calls:
        return None
    return harness.p95(readers.call_ms(run))

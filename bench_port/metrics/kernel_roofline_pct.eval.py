"""The hand kernels' bounds over their device time, in the profiled
stretch of an eval cell."""

from bench_port import readers


def read(run):
    return readers.roofline_pct(run, train=False)

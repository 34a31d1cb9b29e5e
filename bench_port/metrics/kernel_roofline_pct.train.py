"""The hand kernels' bounds (counts/kernels.py, from the launches the
port counted) over their device time by name, in the profiled stretch."""

from bench_port import readers


def read(run):
    return readers.roofline_pct(run, train=True)

"""Bags of all updates completed in the window over the window's seconds
(host clock; the window closes with a synchronize)."""

from bench_port import readers


def read(run):
    return readers.bags_per_s(run, train=True)

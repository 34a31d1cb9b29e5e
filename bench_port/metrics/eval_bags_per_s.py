"""Bags whose logits reached the host in the window over the window's
seconds (host clock)."""

from bench_port import readers


def read(run):
    return readers.bags_per_s(run, train=False)

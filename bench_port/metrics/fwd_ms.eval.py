"""Median device ms of a batch's forward, between its forward.start and
forward.end marks, in the profiled stretch."""

from bench_port import spans


def read(run):
    return spans.forward_ms(run)

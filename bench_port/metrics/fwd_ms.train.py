"""Median device ms of a replayed update's forward and loss, between
its step.start and step.loss marks, in the profiled stretch."""

from bench_port import spans


def read(run):
    return spans.step_ms(run, 0)

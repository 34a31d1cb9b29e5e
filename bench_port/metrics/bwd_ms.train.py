"""Median device ms of a replayed update's backward (with the zero
fills and the modulation), between its step.loss and step.optimizer
marks, in the profiled stretch."""

from bench_port import spans


def read(run):
    return spans.step_ms(run, 1)

"""Median device ms of a replayed update's optimizer step, between its
step.optimizer and step.end marks, in the profiled stretch."""

from bench_port import spans


def read(run):
    return spans.step_ms(run, 2)

"""Median device ms of the Nystrom cores in a replayed update (forward
and backward of both of TransMIL's layers), between their layer marks, in
the profiled stretch."""

from bench_port import cores


def read(run):
    return cores.core_ms(run)

"""Device ms of host-to-device copies a batch in the profiled stretch."""

from bench_port import readers


def read(run):
    return readers.h2d_ms(run, train=False)

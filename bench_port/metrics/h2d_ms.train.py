"""Device ms of host-to-device copies an update in the profiled stretch."""

from bench_port import readers


def read(run):
    return readers.h2d_ms(run, train=True)

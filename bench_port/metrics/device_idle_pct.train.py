"""Share of the profiled stretch with no kernel and no copy on the card."""

from bench_port import readers


def read(run):
    return readers.idle_pct(run, train=True)

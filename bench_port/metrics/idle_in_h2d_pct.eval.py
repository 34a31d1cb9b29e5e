"""Share of the profiled stretch with no kernel and no copy on the card
while the host is inside an h2d span."""

from bench_port import spans


def read(run):
    return spans.idle_in_h2d_pct(run, train=False)

"""Host ms inside the h2d spans a batch in the profiled stretch: the
copies and the wait for the card before a pageable copy starts."""

from bench_port import spans


def read(run):
    return spans.h2d_host_ms(run, train=False)

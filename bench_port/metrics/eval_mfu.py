"""Model flops of the window's forwards over its seconds, against 989
TFLOP/s of dense bf16, in %."""

from bench_port import readers


def read(run):
    return readers.mfu_pct(run, train=False)

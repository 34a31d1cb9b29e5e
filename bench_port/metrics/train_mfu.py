"""Model flops of the window's updates (counts/model_flops.py, backward
at 2x the differentiable forward) over its seconds, against 989 TFLOP/s of
dense bf16, in %."""

from bench_port import readers


def read(run):
    return readers.mfu_pct(run, train=True)

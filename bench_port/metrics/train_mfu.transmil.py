"""TransMIL's model flops of the window's updates
(counts/transmil_flops.py, backward at 2x the differentiable forward)
over its seconds, against 989 TFLOP/s of dense bf16, in %."""

from bench_port import cores


def read(run):
    return cores.mfu_pct(run)

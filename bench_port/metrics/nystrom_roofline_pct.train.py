"""The Nystrom cores' bound (counts/transmil_flops.py) times the core
calls the traced replays counted, over the cores' marked device time, in
%."""

from bench_port import cores


def read(run):
    return cores.roofline_pct(run)

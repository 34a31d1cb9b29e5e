"""The shapes of the two-scale models' deformable attention, worked out
from a configuration's settings as the port's modules work them out:
``N = fixdim`` tokens on a ``side x side`` grid, the offset conv's deformed
``gh x gw`` grid of ``K`` kv points (kernel 6, stride 4, padding 1), 8
heads of 64 in 8 offset groups, and the CPB table's ``tn x tn`` lattice
(``ops/cpb.py table_consts`` at the configuration's divisor)."""

from __future__ import annotations

import math
from typing import NamedTuple

HEADS, DIM_HEAD, GROUPS = 8, 64, 8
DOWNSAMPLE, OFFSET_KERNEL, OFFSET_SCALE = 4, 6, 4.0
CPB_HID = 32  # dim // 4 at dim 128
KNN_K = 5


class AttnShape(NamedTuple):
    n: int        # query tokens
    side: int
    grid: int     # gh = gw
    k: int        # kv points
    dim: int      # token width (path_dim)
    inner: int    # heads * dim_head
    tn: int       # CPB table side (0: exact CPB)
    divisor: int


def table_consts(side: int, kv_bound: float, divisor: int = 1):
    h = (2.0 / (side - 1)) / divisor
    n_lo = int(-(-(1.0 + kv_bound) // h)) + 2
    rn = -(-(2 * n_lo + 1) // divisor)
    return h, -n_lo * h, rn * divisor


def attn_shape(settings: dict) -> AttnShape:
    n = int(settings["fixdim"])
    side = math.isqrt(n)
    pad = (OFFSET_KERNEL - DOWNSAMPLE) // 2
    grid = (side + 2 * pad - OFFSET_KERNEL) // DOWNSAMPLE + 1
    divisor = int(settings["cpb_table_divisor"]) if grid > 1 else 0
    kv_bound = 1.0 + 2.0 * OFFSET_SCALE / (grid - 1) if grid > 1 else 0.0
    tn = table_consts(side, kv_bound, divisor)[2] if divisor > 0 else 0
    return AttnShape(n, side, grid, grid * grid, int(settings["path_dim"]),
                     HEADS * DIM_HEAD, tn, divisor)


def clusters(settings: dict) -> int:
    """The student's cluster tokens a bag (at least 2)."""
    return max(math.ceil(int(settings["fixdim"])
                         * float(settings["path_cluster_num"])), 1, 2)

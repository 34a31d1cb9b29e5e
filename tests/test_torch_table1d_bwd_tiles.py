"""The tile decomposition of K4-bwd (``csrc/cpb_table_1d_bwd.cu``) restated
in torch, from the plan the wrapper hands the kernels
(``ops/cpb1d.py table1d_bwd_plan``), against the plain backward
(``table1d_interp_backward_reference``) in float64.

The restatement walks the kernels' blocks: which rows of its group a tile
lists (the window ``[ox, ox + n_q]`` meets the tile), which rows a warp
takes (the window meets its 128 entries), where a lane reads its row's
cotangent (the segment of row ``r`` and channel ``c`` in the ``[BG, O, K,
n_q]`` layout, minus the tap), the value below each entry (from the lane
below, lane 0 from lane 31 of the strip below or, in the warp's first
strip, the halo read), and which entry owns each shift term.  Then it adds
the groups' partial tables in the finishing kernel's order (strided runs
of groups, then the runs) and each row's (row, tile) shift sums over the
tiles the finishing kernel enumerates, which must be exactly the tiles
whose blocks wrote them.  The card runs the same plan
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

WARPS, STRIP, SLICES = 8, 4, 8  # kWarps, kStrip, kSlices of the kernels


def _case(rng, n_out, tn, n_q, kv, bg, overshoot=1.5, pin=()):
    """A random float64 table ``[n_out, tn]``, the taps and fractions of
    ``bg * kv`` random shifts up to ``overshoot`` cells past either end
    (the first two rows clipped at the low and the high end), rows pinned
    to the shifts of ``pin`` after those, and a cotangent ``[bg, n_out, kv,
    n_q]``."""
    rows = bg * kv
    table = torch.from_numpy(rng.normal(size=(n_out, tn)))
    hi = tn - n_q - 2
    shifts = rng.uniform(-overshoot, hi + overshoot, size=rows)
    shifts[0], shifts[1] = -0.9 * overshoot, hi + 0.9 * overshoot
    shifts[2:2 + len(pin)] = pin
    taps, fracs = cpb1d.table1d_taps(torch.from_numpy(shifts), n_q=n_q,
                                     tn=tn)
    dout = torch.from_numpy(rng.normal(size=(bg, n_out, kv, n_q)))
    return table, taps, fracs.double(), dout


def restated_backward(table, taps, fracs, dout, n_q, kv, plan):
    """``(dtable, dshifts)`` as the kernels compute them under ``plan``, in
    float64, and per group the tiles its rows met."""
    n_out, tn = table.shape
    R = taps.shape[0]
    flat = dout.flatten()
    oxs = taps.long().clamp(0, tn - n_q - 1).tolist()
    tile = plan.tile
    lanes = torch.arange(32)
    partial = torch.zeros(plan.groups, n_out, tn, dtype=torch.float64)
    owner = torch.zeros(plan.groups, n_out, tn, dtype=torch.int64)
    dpart = {}
    met = []
    for g in range(plan.groups):
        rows = range(g * plan.rows_per_group,
                     min(R, (g + 1) * plan.rows_per_group))
        met.append(set())
        for c in range(n_out):
            T = table[c]
            for t in range(plan.tiles_c):
                t0 = t * tile
                listed = [r for r in rows
                          if oxs[r] < t0 + tile and oxs[r] + n_q >= t0]
                if listed:
                    met[g].add((c, t))
                red = {r: torch.zeros(WARPS, dtype=torch.float64)
                       for r in listed}
                for w in range(WARPS):
                    wb = t0 + w * 32 * STRIP
                    e = wb + 32 * torch.arange(STRIP)[:, None] + lanes  # [S, 32]
                    nxt = torch.where(e + 1 < tn, e + 1, 0)
                    diff = torch.where(e + 1 < tn, T[nxt] - T[e.clamp(max=tn - 1)],
                                       0.0)
                    acc = torch.zeros(STRIP, 32, dtype=torch.float64)
                    for r in listed:  # the block's list, in row order
                        ox = oxs[r]
                        if not (ox < wb + 32 * STRIP and ox + n_q >= wb):
                            continue  # the warp skips the row
                        b, k = divmod(r, kv)
                        seg = ((b * n_out + c) * kv + k) * n_q - ox
                        inside = (e - ox >= 0) & (e - ox < n_q)
                        v = torch.where(inside, flat[(seg + e).clamp(0, flat.numel() - 1)],
                                        0.0)
                        halo = (flat[seg + wb - 1] if 0 <= wb - 1 - ox < n_q
                                else torch.tensor(0.0, dtype=torch.float64))
                        # the value below each entry: the lane below; lane 0
                        # that of lane 31 a strip down, or the halo
                        below = torch.cat([torch.stack([halo]), v[:-1, 31]])
                        prev = torch.cat([below[:, None], v[:, :-1]], dim=1)
                        f = fracs[r]
                        acc += v * (1 - f) + prev * f
                        red[r][w] = (v * diff).sum()
                    inside = e < tn
                    partial[g, c, e[inside]] = acc[inside]
                    owner[g, c, e[inside]] += 1
                for r in listed:  # the warps' sums in warp order
                    dpart[(r, c * plan.tiles_c + t)] = red[r].sum()
    assert (owner == 1).all(), "every entry has one owner in every group"
    # the finishing kernel: strided runs of the groups, then the runs
    runs = [partial[s::SLICES].sum(dim=0) for s in range(SLICES)]
    dtable = torch.stack(runs).sum(dim=0)
    dshifts = torch.zeros(R, dtype=torch.float64)
    read = set()
    for r in range(R):
        for c in range(n_out):
            for t in range(oxs[r] // tile, (oxs[r] + n_q) // tile + 1):
                dshifts[r] += dpart[(r, c * plan.tiles_c + t)]
                read.add((r, c * plan.tiles_c + t))
    assert read == set(dpart), "the finish reads the pairs the blocks wrote"
    return dtable, dshifts, met


# (n_out, tn, n_q, kv, bg, groups): tn no multiple of the tile; n_q short
# (a window in one tile or across a boundary) and long (2-3 tiles); O 1 and
# 3; one group, a group a row, and groups in between
CASES = [
    (2, 2600, 37, 3, 4, None),
    (1, 2100, 37, 5, 3, 4),
    (3, 2300, 9, 2, 3, 3),
    (2, 3100, 1500, 3, 2, 2),
    (1, 1030, 1000, 4, 1, 1),
    (3, 700, 101, 7, 1, 3),
]


@pytest.mark.parametrize("n_out,tn,n_q,kv,bg,groups", CASES)
def test_restated_tiles_match_the_plain_backward(n_out, tn, n_q, kv, bg,
                                                 groups):
    """The kernels' decomposition under the wrapper's plan (or at a forced
    group count) gives the plain backward's cotangents, clipped rows at
    both ends included, with tables no multiple of the tile wide and O 1
    to 3."""
    rng = np.random.default_rng(tn + n_q + kv)
    table, taps, fracs, dout = _case(rng, n_out, tn, n_q, kv, bg)
    assert fracs[0] < 0 and fracs[1] > 1  # clipped at both ends
    assert tn % cpb1d.TABLE1D_BWD_TILE
    plan = cpb1d.table1d_bwd_plan(n_out, tn, bg * kv, groups)
    got = restated_backward(table, taps, fracs, dout, n_q, kv, plan)
    want = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                   n_q, kv)
    for g, w in zip(got[:2], want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_rows_in_one_tile_and_groups_that_miss_tiles():
    """Short windows pinned inside one tile, across a tile boundary, and
    ending exactly on a warp's and on a tile's first entry (whose only term
    takes the halo): a row that meets one tile only, rows that meet two,
    and a group whose rows meet some tiles and not others, against the
    plain backward."""
    tile = cpb1d.TABLE1D_BWD_TILE
    n_q, kv, bg = 20, 4, 3
    pin = (5.25, tile - 7.5, 256 - n_q + 0.25, tile - n_q + 0.5, 1.5, 7.0,
           2 * tile - 20.75, 30.0, 100.5, 640.25)
    rng = np.random.default_rng(5)
    table, taps, fracs, dout = _case(rng, 2, 3 * tile - 100, n_q, kv, bg,
                                     pin=pin)
    plan = cpb1d.table1d_bwd_plan(2, table.shape[1], kv * bg, 2)
    assert plan.groups == 2 and plan.tiles_c == 3
    dtable, dshifts, met = restated_backward(table, taps, fracs, dout, n_q,
                                             kv, plan)
    oxs = taps.long().tolist()
    assert oxs[2] // tile == (oxs[2] + n_q) // tile  # one tile only
    assert oxs[3] // tile != (oxs[3] + n_q) // tile  # across a boundary
    assert (oxs[4] + n_q) % 128 == 0 and (oxs[5] + n_q) % tile == 0
    assert len(met[1]) < 2 * plan.tiles_c  # tiles group 1 misses
    want = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                   n_q, kv)
    torch.testing.assert_close(dtable, want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dshifts, want[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_out,tn,rows", [(2, 5023, 10000), (1, 67, 16),
                                           (2, 5023, 1), (3, 40000, 300),
                                           (2, 5023, 2_000_000)])
def test_plan_fits_the_kernels(n_out, tn, rows):
    """The plan's blocks fit the kernels: tiles of 8 warps of 4 strips of
    32 entries covering the table, no empty row group, at most
    ``TABLE1D_BWD_ROWS_MAX`` rows a group, the grid inside its limits, and
    about ``TABLE1D_BWD_BLOCKS`` blocks where there are enough rows."""
    plan = cpb1d.table1d_bwd_plan(n_out, tn, rows)
    assert plan.tile == WARPS * STRIP * 32
    assert plan.tiles_c * plan.tile >= tn > (plan.tiles_c - 1) * plan.tile
    assert plan.rows_per_group <= cpb1d.TABLE1D_BWD_ROWS_MAX
    assert plan.rows_per_group * plan.groups >= rows
    assert plan.rows_per_group * (plan.groups - 1) < rows
    assert plan.groups <= cpb1d.GRID_Y_MAX
    blocks = plan.tiles * plan.groups
    if rows >= cpb1d.TABLE1D_BWD_BLOCKS:
        assert cpb1d.TABLE1D_BWD_BLOCKS <= 2 * blocks
        assert (blocks <= 2 * cpb1d.TABLE1D_BWD_BLOCKS
                or plan.rows_per_group == cpb1d.TABLE1D_BWD_ROWS_MAX)
    # forced group counts are taken as they are, within the same limits
    forced = cpb1d.table1d_bwd_plan(n_out, tn, rows, 7)
    asked = min(rows, max(7, -(-rows // cpb1d.TABLE1D_BWD_ROWS_MAX)))
    assert forced.rows_per_group == -(-rows // asked)


def test_plan_names_its_limit():
    """More rows than ``GRID_Y_MAX`` groups of ``TABLE1D_BWD_ROWS_MAX`` rows
    hold is refused with a ``ValueError`` that names both limits."""
    rows = cpb1d.GRID_Y_MAX * cpb1d.TABLE1D_BWD_ROWS_MAX + 1
    with pytest.raises(ValueError, match="TABLE1D_BWD_ROWS_MAX.*GRID_Y_MAX"):
        cpb1d.table1d_bwd_plan(2, 5023, rows)

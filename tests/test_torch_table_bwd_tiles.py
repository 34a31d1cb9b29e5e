"""The tile decomposition of K1-bwd and K5-bwd (``csrc/table_bwd_tiles.cuh``)
restated in torch, from the plan the wrapper hands the kernels
(``ops/cpb.py table_bwd_plan``), against the plain backward
(``table_interp_backward_reference``) in float64.

The restatement walks the kernels' blocks: which rows of its group a tile
takes (the window meets the tile), which (row, warp) pairs a warp takes,
the halo a warp reads (at divisor 1 the window row above its strip and the
left neighbour of each column), and which entry owns each shift-sum term.
Then it adds the groups' partial tables in group order and each row's
(row, tile) shift sums over the tiles the finishing kernel enumerates,
which must be exactly the tiles whose blocks wrote them.  The card runs
the same plan (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu_torch.ops import cpb


def _case(rng, side, divisor, rows, extra=7, overshoot=1.5):
    """A random float64 table ``extra`` lines larger than a window at
    ``divisor`` (times the divisor, as the lattice is), the taps and
    fractions of ``rows`` random shifts up to ``overshoot`` cells past
    either end (clipped rows) and a window cotangent."""
    reach = side + 1 if divisor == 1 else divisor * (side - 1) + 2
    tn = -(-(reach + extra) // divisor) * divisor
    table = torch.from_numpy(rng.normal(size=(tn, tn)))
    hi = tn - reach
    shifts = torch.from_numpy(rng.uniform(-overshoot, hi + overshoot,
                                          size=(rows, 2)))
    shifts[0] = torch.tensor([-0.9 * overshoot, hi + 0.9 * overshoot])
    taps, fracs = cpb.table_taps(shifts, side=side, tn=tn, divisor=divisor)
    dout = torch.from_numpy(rng.normal(size=(rows, side, side)))
    return table, taps, fracs.double(), dout


def _at(x, i, j):
    """``x[i, j]`` with zeros outside ``x``; ``i`` and ``j`` broadcast."""
    i, j = torch.broadcast_tensors(torch.as_tensor(i), torch.as_tensor(j))
    ok = (i >= 0) & (i < x.shape[0]) & (j >= 0) & (j < x.shape[1])
    return torch.where(ok, x[i.clamp(0, x.shape[0] - 1),
                             j.clamp(0, x.shape[1] - 1)], 0.0)


def restated_backward(table, taps, fracs, dout, side, plan):
    """``(dtable, dfracs)`` as the kernels compute them under ``plan``, in
    float64, and the (row, tile) pairs whose shift sums the blocks wrote."""
    d, S = plan.divisor, plan.strip
    tn_r, tn_c = table.shape
    R = taps.shape[0]
    y0s = taps[:, 0].long().clamp(0, tn_r - plan.reach).tolist()
    x0s = taps[:, 1].long().clamp(0, tn_c - plan.reach).tolist()
    partial = torch.zeros(plan.groups, tn_r, tn_c, dtype=torch.float64)
    owner = torch.zeros(plan.groups, tn_r, tn_c, dtype=torch.int64)
    dpart = {}
    lanes = torch.arange(32)

    def meets(r, ty, tx):
        return (y0s[r] < (ty + 1) * plan.tile_h
                and y0s[r] + plan.reach > ty * plan.tile_h
                and x0s[r] < (tx + 1) * plan.tile_w
                and x0s[r] + plan.reach > tx * plan.tile_w)

    for g in range(plan.groups):
        rows = range(g * plan.rows_per_group,
                     min(R, (g + 1) * plan.rows_per_group))
        for z in range(plan.nz):
            for ty in range(plan.tiles_y):
                for tx in range(plan.tiles_x):
                    tile = (z * plan.tiles_y + ty) * plan.tiles_x + tx
                    sums = {r: torch.zeros(2, dtype=torch.float64)
                            for r in rows if meets(r, ty, tx)}
                    for warp in range(plan.phases * plan.warps_per_phase):
                        ph = z * plan.phases + warp // plan.warps_per_phase
                        if ph >= d * d:
                            continue
                        py, px = divmod(ph, d)
                        a0 = (ty * plan.tile_h + py
                              + d * (warp % plan.warps_per_phase) * S)
                        a = a0 + d * torch.arange(S)[:, None]      # [S, 1]
                        b = tx * plan.tile_w + px + d * lanes      # [32]
                        if d == 1:  # lane 0 holds the halo column
                            b = (b - 1)[1:]
                        acc = torch.zeros(S, len(b), dtype=torch.float64)
                        for r in sums:  # the block's list, in row order
                            got = _warp_row(table, dout[r], y0s[r], x0s[r],
                                            fracs[r], side, d, S, py, px, a,
                                            b, tx * plan.tile_w)
                            if got is None:
                                continue
                            acc += got[0]
                            sums[r] += got[1]
                        inside = (a < tn_r) & (b < tn_c)
                        ai, bi = torch.broadcast_tensors(a, b)
                        partial[g, ai[inside], bi[inside]] = acc[inside]
                        owner[g, ai[inside], bi[inside]] += 1
                    for r, s in sums.items():
                        dpart[(r, tile)] = s
    assert (owner == 1).all(), "every entry has one owner in every group"
    dtable = torch.zeros(tn_r, tn_c, dtype=torch.float64)
    for g in range(plan.groups):
        dtable = dtable + partial[g]
    dfracs = torch.zeros(R, 2, dtype=torch.float64)
    read = set()
    for r in range(R):
        for z in range(plan.nz):
            for ty in range(y0s[r] // plan.tile_h,
                            (y0s[r] + plan.reach - 1) // plan.tile_h + 1):
                for tx in range(x0s[r] // plan.tile_w,
                                (x0s[r] + plan.reach - 1) // plan.tile_w + 1):
                    t = (z * plan.tiles_y + ty) * plan.tiles_x + tx
                    dfracs[r] += dpart[(r, t)]
                    read.add((r, t))
    assert read == set(dpart), "the finish reads the pairs the blocks wrote"
    return dtable, dfracs


def _warp_row(table, dw, y0, x0, frac, side, d, S, py, px, a, b, tx0):
    """One warp's work on one row: ``None`` where the warp skips the row,
    else its entries' terms ``[S, lanes]`` and its shift sums ``(dfy,
    dfx)``.  Table entries past the table read as 0, as in the kernel."""
    fy, fx = frac.tolist()
    gy, gx = 1 - fy, 1 - fx
    a0 = a[0, 0].item()
    W = lambda i, j: _at(table, i, j)  # noqa: E731
    if d == 1:
        if not (a0 <= y0 + side and a0 + S > y0):
            return None
        xp = b - x0                                   # [32]
        # the strip's window rows and the one above, with their left
        # neighbours: the halo of m
        yy = a - y0                                   # [S, 1]
        v = lambda y: _at(dw, y, xp)                  # noqa: E731
        m = lambda y: v(y) * gx + _at(dw, y, xp - 1) * fx  # noqa: E731
        terms = m(yy) * gy + m(yy - 1) * fy
        dfy = (m(yy) * (W(a + 1, b) - W(a, b))).sum()
        dfx = (v(yy) * ((W(a, b + 1) - W(a, b)) * gy
                        + (W(a + 1, b + 1) - W(a + 1, b)) * fy)).sum()
        return terms, torch.stack([dfy, dfx])
    Y, X = (py - y0) % d, (px - x0) % d
    i0 = (a0 - y0 - Y) // d
    j0 = (tx0 + px - x0 - X) // d
    if not (Y <= 1 and X <= 1 and i0 < side and i0 + S > 0 and j0 < side
            and j0 + 32 > 0):
        return None
    i = (a - y0 - Y) // d                             # [S, 1]
    j = (b - x0 - X) // d                             # [32]
    v = _at(dw, i, j)
    wy, wx = (fy if Y else gy), (fx if X else gx)
    terms = (v * wx) * wy
    # a term's d/dfx part dx(w00) gy + dx(w10) fy is held by the phases of
    # w00 and w10 (X = 0), its d/dfy part dy(w00) gx + dy(w01) fx by those
    # of w00 and w01 (Y = 0), each with its own entry's difference
    dfx = (v * (W(a, b + 1) - W(a, b))).sum() * wy if X == 0 else 0.0
    dfy = (v * (W(a + 1, b) - W(a, b))).sum() * wx if Y == 0 else 0.0
    return terms, torch.tensor([float(dfy), float(dfx)], dtype=torch.float64)


CASES = [(1, 3, 5), (1, 7, 9), (1, 1, 3), (1, 2, 1), (2, 4, 6), (2, 2, 3),
         (3, 3, 5), (4, 3, 4), (4, 1, 2)]


@pytest.mark.parametrize("divisor,side,rows", CASES)
def test_restated_tiles_match_the_plain_backward(divisor, side, rows):
    """The kernels' decomposition under the wrapper's plan (here one row a
    group: fewer rows than row groups) gives the plain backward's
    cotangents, clipped rows included, at small odd shapes, divisors 1-4,
    side 1 and 2, R = 1."""
    rng = np.random.default_rng(100 * divisor + 10 * side + rows)
    table, taps, fracs, dout = _case(rng, side, divisor, rows)
    plan = cpb.table_bwd_plan(*table.shape, rows, side, divisor)
    assert plan.groups == rows  # fewer rows than the groups it would take
    got = restated_backward(table, taps, fracs, dout, side, plan)
    want = cpb.table_interp_backward_reference(table, taps, fracs, dout, side,
                                               divisor)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("divisor", [1, 2, 3, 4])
def test_restated_tiles_with_rows_in_groups(divisor):
    """Several rows a group (each entry's sum over a group's rows in row
    order) and tables wider than one tile, clipped rows within a few cells
    of the lattice: the same cotangents as the plain backward."""
    side = 9 if divisor == 1 else 5
    rng = np.random.default_rng(7 + divisor)
    table, taps, fracs, dout = _case(rng, side, divisor, 11, extra=40)
    assert ((fracs < 0) | (fracs > 1)).any()
    assert (fracs.abs() < 4).all()
    plan = cpb.table_bwd_plan(*table.shape, 11, side, divisor)
    plan = plan._replace(groups=3, rows_per_group=4)
    want = cpb.table_interp_backward_reference(table, taps, fracs, dout, side,
                                               divisor)
    got = restated_backward(table, taps, fracs, dout, side, plan)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("divisor", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("tn_side", [12, 139, 600])
def test_plan_fits_the_kernels(divisor, tn_side):
    """The plan's blocks fit the kernels: at most 16 warps (8 at divisor 1),
    phases of one divisor only, tiles whose origin is a multiple of the
    divisor (so a warp's phase is that of its rows) and 32 phase columns
    wide (31 at divisor 1, whose lane 0 reads the halo); every phase in exactly one block of a tile; the grid inside its
    limits; no empty row group; about ``TABLE_BWD_WARPS`` warps at 4608
    rows."""
    side = 50 if tn_side > 100 else 4
    tn = max(tn_side, divisor * (side - 1) + 2)
    plan = cpb.table_bwd_plan(tn, tn, 4608, side, divisor)
    warps = plan.phases * plan.warps_per_phase
    assert warps <= (8 if divisor == 1 else 16)
    assert plan.phases <= divisor ** 2 < plan.nz * plan.phases + 1
    assert (plan.nz - 1) * plan.phases < divisor ** 2
    assert plan.tile_h % divisor == 0
    assert plan.tile_w == (31 if divisor == 1 else 32 * divisor)
    assert plan.tile_h == divisor * plan.strip * plan.warps_per_phase
    assert plan.tiles_y * plan.tile_h >= tn > (plan.tiles_y - 1) * plan.tile_h
    assert plan.nz * plan.groups <= 65535 and plan.tiles_y <= 65535
    assert plan.rows_per_group <= cpb.TABLE_BWD_ROWS_MAX
    assert plan.rows_per_group * plan.groups >= 4608
    assert plan.rows_per_group * (plan.groups - 1) < 4608
    blocks = plan.tiles * plan.groups
    # whole rows a group: at least half the warps asked for
    assert 2 * blocks * warps > cpb.TABLE_BWD_WARPS or plan.groups == 4608

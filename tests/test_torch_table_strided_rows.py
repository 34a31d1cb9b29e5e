"""The plan of K5-fwd (``csrc/cpb_table_strided.cu``, the table CPB's
forward at divisor d >= 2) restated in Python.

- The x-phase pair planes its first kernel writes at d >= 3, ``Q[px][Y,
  ox] = (T[Y, ox*d + px], T[Y, ox*d + px + 1])`` (0 past the table's
  columns): the JAX package's phase-decomposed table (``cpb_bias_table``'s
  divisor-d build, its padding left out), decomposed in x only, each
  entry paired with its right neighbour.
- Which pair each of an output's four taps reads: taps ``(y0 + d*y + ay,
  x0 + d*x + ax)`` are the pairs at column ``x0 // d + x`` of rows
  ``y0 + d*y`` (ay = 0) and ``y0 + d*y + 1`` (ay = 1) of plane ``x0 % d``,
  ax choosing the pair's half; the tap right of phase d - 1 is phase 0 one
  column on, which the pair holds (the wrap).  At d = 2 the kernel reads
  the table itself.
- The grid: a block a row, every row once.
- How a block's 128 threads store a row: an output a thread a step, the
  32 lanes of a warp on 32 consecutive outputs (128 bytes in f32, 64 in
  bf16), each thread stepping to its outputs' (y, x) from one division a
  row.  (Packing bf16 outputs two a 4-byte store, and so a scalar head and
  tail at odd sides, measured slower on the card: PERF.md, PR 12.)

Then a torch gather through that mapping is bitwise equal to
``table_interp_reference`` at divisors 2, 3 and 4 with clipped rows, in
f32 and with the bf16 store, and within 1e-6 of the JAX package's own
interpolation of its phase table.  The card holds the kernel bitwise
against the same plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2e).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu_torch.ops import cpb

THREADS = 128  # kThreads: the block of a row


def uses_pairs(d: int) -> bool:
    return d >= 3


def scratch_bytes(tn_rows: int, tn_cols: int, d: int) -> int:
    return 8 * d * tn_rows * -(-tn_cols // d) if uses_pairs(d) else 0


def pair_planes(table: torch.Tensor, d: int) -> torch.Tensor:
    """The first kernel's ``[d, tn_rows, ceil(tn_cols / d), 2]``."""
    tn_rows, tn_cols = table.shape
    rn_x = -(-tn_cols // d)
    padded = torch.zeros(tn_rows, rn_x * d + 1, dtype=table.dtype)
    padded[:, :tn_cols] = table
    x = torch.arange(rn_x)[None, :] * d + torch.arange(d)[:, None]  # [d, ox]
    return torch.stack([padded[:, x], padded[:, x + 1]], -1).permute(
        1, 0, 2, 3)


def clamped(taps, table_shape, side: int, d: int) -> torch.Tensor:
    reach = d * (side - 1) + 2
    return torch.stack([taps[:, 0].clamp(0, table_shape[0] - reach),
                        taps[:, 1].clamp(0, table_shape[1] - reach)], 1).long()


def window_taps(table, taps, side: int, d: int) -> list[torch.Tensor]:
    """The four taps ``t00, t01, t10, t11`` ``[R, side, side]`` of every
    output as the kernel reads them: from the pair planes at d >= 3 (the
    pairs of rows y0 + d*y and y0 + d*y + 1 at column x0 // d + x of plane
    x0 % d), from the table at d = 2."""
    t = clamped(taps, table.shape, side, d)
    y = d * torch.arange(side)[None, :, None] + t[:, 0, None, None]
    x = torch.arange(side)[None, None, :]
    if not uses_pairs(d):
        xs = d * x + t[:, 1, None, None]
        return [table[y, xs], table[y, xs + 1], table[y + 1, xs],
                table[y + 1, xs + 1]]
    q = pair_planes(table, d)
    px = (t[:, 1] % d)[:, None, None]
    ox = (t[:, 1] // d)[:, None, None] + x
    a, b = q[px, y, ox], q[px, y + 1, ox]
    return [a[..., 0], a[..., 1], b[..., 0], b[..., 1]]


def gather(table, taps, fracs, side: int, d: int, out_dtype=torch.float32):
    """The kernel's arithmetic on its taps: y-blends then the x-blend,
    each op rounded."""
    t00, t01, t10, t11 = window_taps(table, taps, side, d)
    fy = fracs[:, 0, None, None]
    fx = fracs[:, 1, None, None]
    gy, gx = 1 - fy, 1 - fx
    a = t00 * gy + t10 * fy
    b = t01 * gy + t11 * fy
    return (a * gx + b * fx).to(out_dtype)


def case(rng, d: int, side: int, rows: int, spread: float = 1.25):
    """A table at divisor d and rows up to ``spread`` times past the bound
    of a 12 x 12 deformed grid (clipped rows)."""
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    tn = cpb.table_consts(side, kv_bound, d)[2]
    table = torch.from_numpy(rng.normal(size=(tn, tn)).astype(np.float32))
    gkv = torch.from_numpy(rng.uniform(-1, 1, size=(1, rows, 2))
                           .astype(np.float32)) * kv_bound * spread
    shifts = cpb.table_shifts(gkv, side=side, kv_bound=kv_bound, divisor=d)
    taps, fracs = cpb.table_taps(shifts, side=side, tn=tn, divisor=d)
    return table, taps, fracs, shifts


@pytest.mark.parametrize("d", [3, 4])
def test_pair_planes_are_the_phase_table_in_x(rng, d):
    """The pairs' first halves, rows of phase py, are JAX's phase plane
    (py, px) (``cpb_bias_table``'s reshape at divisor d); their second
    halves are plane (py, px + 1), and for px = d - 1 plane (py, 0) one
    column on (the wrap), 0 past the table."""
    table, _, _, _ = case(rng, d, 7, 8)
    rn = table.shape[0] // d
    assert rn * d == table.shape[0]  # cpb_table's tn is a multiple of d
    tablep = jnp.asarray(table.numpy()).reshape(rn, d, rn, d)
    tablep = np.asarray(tablep.transpose(1, 3, 0, 2))  # [py, px, oy, ox]
    q = pair_planes(table, d).numpy()                  # [px, Y, ox, 2]
    for py in range(d):
        for px in range(d):
            assert np.array_equal(q[px, py::d, :, 0], tablep[py, px])
            second = q[px, py::d, :, 1]
            if px < d - 1:
                assert np.array_equal(second, tablep[py, px + 1])
            else:
                assert np.array_equal(second[:, :-1], tablep[py, 0][:, 1:])
                assert not second[:, -1].any()


@pytest.mark.parametrize("d", [2, 3, 4])
def test_each_tap_reads_its_table_entry(rng, d):
    """Every output's four taps, read through the pair planes (d >= 3) or
    the table (d = 2), are the table entries (y0 + d*y + ay, x0 + d*x +
    ax), for rows whose taps cover phases 0 and d - 1 in x (the wrap); at
    d >= 3 the pairs' rows and columns are those of ``_tbl_idx``, whose
    phase table row (py*d + px)*rn + oy is table row oy*d + py of plane px
    and whose column ox is the pair column."""
    side = 7
    table, taps, _, shifts = case(rng, d, side, 64)
    t = clamped(taps, table.shape, side, d)
    assert {int(x) % d for x in t[:, 1]} >= {0, d - 1}
    got = window_taps(table, taps, side, d)
    y = t[:, 0, None, None] + d * torch.arange(side)[None, :, None]
    x = t[:, 1, None, None] + d * torch.arange(side)[None, None, :]
    for (ay, ax), g in zip(((0, 0), (0, 1), (1, 0), (1, 1)), got):
        assert torch.equal(g, table[y + ay, x + ax])
    if uses_pairs(d):
        rn = table.shape[0] // d
        idx, _ = jda._tbl_idx(jnp.asarray(shifts.numpy()), side, d, rn)
        idx = torch.from_numpy(np.array(idx)).long()
        phase, oy = idx[:, 0] // rn, idx[:, 0] % rn
        assert torch.equal(oy * d + phase // d, t[:, 0])
        assert torch.equal(phase % d, t[:, 1] % d)
        assert torch.equal(idx[:, 4], t[:, 1] // d)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("side", [2, 7, 50])
def test_gather_through_the_plan_is_the_plain_version_bitwise(
        rng, d, out_dtype, side):
    """The kernel's plan, as a torch gather, equals
    ``table_interp_reference`` bitwise (clipped rows included), and the
    JAX package's interpolation of its own phase table within 1e-6."""
    table, taps, fracs, shifts = case(rng, d, side, 300, spread=3.0)
    assert ((fracs < 0) | (fracs > 1)).any()
    got = gather(table, taps, fracs, side, d, out_dtype)
    want = cpb.table_interp_reference(table, taps, fracs, side, d, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if out_dtype == torch.float32 and side == 7:
        rn = table.shape[0] // d
        tablep = jnp.asarray(table.numpy()).reshape(rn, d, rn, d)
        tablep = tablep.transpose(1, 3, 0, 2).reshape(d * d * rn, rn)
        tablep = jnp.pad(tablep, ((0, jda._tbl_win_rows(side)), (0, 0)))
        jax_wins = jda._tbl_interp_ref(tablep, jnp.asarray(shifts.numpy()),
                                       side, d, rn)
        np.testing.assert_allclose(np.asarray(jax_wins), got.numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,d", [((274, 274), 2), ((544, 544), 4),
                                     ((279, 279), 3), ((40, 37), 3),
                                     ((600, 600), 40)])
def test_the_scratch_holds_the_pair_planes(shape, d):
    """The scratch is the pair planes, ``[d, tn_rows, ceil(tn_cols / d)]``
    float2 (2.4 MB at the teacher's 544^2 table, d = 4), at d >= 3 and
    nothing at d = 2."""
    nbytes = scratch_bytes(*shape, d)
    assert nbytes == (pair_planes(torch.zeros(shape), d).numel() * 4
                      if uses_pairs(d) else 0)
    if shape == (544, 544):
        assert nbytes == 2_367_488


def row_steps(side: int):
    """``write_row``'s outputs of one row: per thread its outputs t, t +
    THREADS, ... and the (y, x) it stepped to for each."""
    n = side * side
    step_y, step_x = divmod(THREADS, side)
    steps = []
    for t in range(THREADS):
        y, x = divmod(t, side)
        for i in range(t, n, THREADS):
            steps.append((t, i, (y, x)))
            x, y = x + step_x, y + step_y
            if x >= side:
                x, y = x - side, y + 1
    return steps


@pytest.mark.parametrize("side", [1, 2, 3, 7, 33, 50, 109])
def test_every_output_stored_once_a_warp_contiguous(side):
    """A row (the grid's block r writes row r): each output stored once;
    each thread's stepped (y, x) is its output's own; at every step the
    lanes of a warp store consecutive outputs."""
    n = side * side
    steps = row_steps(side)
    assert sorted(i for _, i, _ in steps) == list(range(n))
    assert all(pos == divmod(i, side) for _, i, pos in steps)
    for i0 in range(0, n, THREADS):
        for w in range(THREADS // 32):
            lanes = [i for t, i, _ in steps
                     if t // 32 == w and i0 <= i < i0 + THREADS]
            assert lanes == list(range(i0 + 32 * w,
                                       min(n, i0 + 32 * w + 32)))

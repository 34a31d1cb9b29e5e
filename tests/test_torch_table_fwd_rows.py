"""The row pipeline of K1-fwd (``csrc/cpb_table.cu``) restated in Python:
which rows each block of its one-wave grid takes, and how a block's
threads split a row's
``side * side`` outputs into a scalar head up to the first vector-aligned
output, 4-output vector stores (16 B in f32, 8 B with the bf16 store) and
a scalar tail, each thread finding its vectors' window positions by one
division a row and then a fixed (row, column) step.  Every output must be
written exactly once, every vector store must be aligned, each stepped
position must be the output's own, and a vector's four outputs must lie
where its window reads (one window row, or the generic path across rows),
at the f32 and bf16 alignments of rows 0-7 and at odd sides.  The card
holds the kernel bitwise against its plain version
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import pytest

THREADS, VEC = 512, 4  # kThreads, kVec of the kernel


def row_writes(side: int, elt: int, start: int):
    """``(scalars, vectors)`` of one row whose first output lies at byte
    ``start``: the outputs threads store alone, and per vector store its
    first output, the positions ``(y, x)`` the thread stepped to for its
    four outputs, and whether it took the one-window-row path."""
    n = side * side
    align = VEC * elt
    head = min(n, ((align - start % align) % align) // elt)
    body = (n - head) // VEC
    tail = head + VEC * body
    step_y, step_x = divmod(THREADS * VEC, side)
    scalars, vectors = [], []
    for t in range(THREADS):
        if t < head + n - tail:
            scalars.append(t if t < head else tail + t - head)
        if t >= body:
            continue
        y, x = divmod(head + VEC * t, side)
        for j in range(t, body, THREADS):
            pos, yk, xk = [], y, x
            for _ in range(VEC):
                pos.append((yk, xk))
                xk += 1
                if xk == side:
                    xk, yk = 0, yk + 1
            vectors.append((head + VEC * j, pos, x + VEC <= side))
            x, y = x + step_x, y + step_y
            if x >= side:
                x, y = x - side, y + 1
    return scalars, vectors


@pytest.mark.parametrize("side", [1, 2, 3, 7, 33, 50, 109])
@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
def test_every_output_written_once_with_aligned_vectors(side, elt):
    """Rows 0-7 of an aligned output: each of the row's outputs is stored
    once, by a scalar or by one lane of an aligned vector, at the window
    position of its own index; a vector inside one window row takes the
    path that reuses its y-blends."""
    n = side * side
    for r in range(8):
        start = r * n * elt
        scalars, vectors = row_writes(side, elt, start)
        written = list(scalars)
        for first, pos, one_row in vectors:
            assert (start + first * elt) % (VEC * elt) == 0
            idx = [first + k for k in range(VEC)]
            assert pos == [divmod(i, side) for i in idx]
            assert one_row == (pos[0][0] == pos[-1][0])
            written += idx
        assert sorted(written) == list(range(n))
        assert len(scalars) <= 2 * (VEC - 1)


@pytest.mark.parametrize("rows,blocks", [(1, 264), (5, 264), (4608, 264),
                                         (4608, 528), (33, 7)])
def test_the_wave_takes_every_row_once(rows, blocks):
    """A grid of ``min(rows, blocks)`` blocks, block b taking rows b, b +
    grid, ...: every row once, and no block more than ``ceil(rows /
    grid)`` rows."""
    grid = min(rows, blocks)
    seen = [r for b in range(grid) for r in range(b, rows, grid)]
    assert sorted(seen) == list(range(rows))
    assert max(len(range(b, rows, grid)) for b in range(grid)) == -(
        -rows // grid)

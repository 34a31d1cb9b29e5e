"""K3's launch plan and its split-and-merge (``ops/dpc_knn.py dpc_plan``,
``csrc/dpc_knn.cu``), restated in torch on the CPU.

The card's K3-knn and K3-parent split the neighbour axis across blocks.
The work is the (token tile of 64, neighbour tile of 128) pairs, token
tile major; block p of P takes the pairs [ceil(p I / P), ceil((p + 1) I /
P)) of the I pairs, one or two runs of one token tile each.  Within a
tile, a warp's four lanes per token take 8 neighbours each of every
32-wide pass and keep their own k-smallest multiset; they merge at the
end of a run, the block writes the run's partials, and a finishing kernel
merges the partials of the blocks that cover a token tile in block order.
This restates that decomposition on the full ``d2`` of the plain version
and holds it against ``torch.topk`` of the full row, the row max and the
masked min, exactly: the merge takes the k smallest of a union of
multisets as the k smallest of the parts' k smallest (duplicates kept),
and min and max, so no block count, tile edge or tie may change a bit.
The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2c).
"""

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu_torch.ops import dpc_knn

TOKENS, TILE = 64, 128  # csrc/dpc_knn.cu kTM, kTN
PASS, LANES = 32, 4     # a pass's neighbours, the lanes that share a token
BLOCKS = 132 * 2


def plan(B: int, N: int):
    """The plan restated: ``(token tiles a bag, neighbour tiles, items,
    blocks)``."""
    tt, nt = -(-N // TOKENS), -(-N // TILE)
    items = B * tt * nt
    return tt, nt, items, max(min(BLOCKS, items), B * tt)


def lo(p: int, items: int, blocks: int) -> int:
    """The first item of block ``p``, as the kernels have it."""
    return -(-p * items // blocks)


def block_of(item: int, items: int, blocks: int) -> int:
    """The block whose items hold ``item``, as the finishing kernel has
    it."""
    return item * blocks // items


def runs(B: int, N: int, blocks: int | None = None):
    """Per block (the plan's, or ``blocks``), its runs ``(token tile, first
    neighbour tile, end)``."""
    tt, nt, items, P = plan(B, N)
    P = blocks or P
    out = []
    for p in range(P):
        first, hi = lo(p, items, P), lo(p + 1, items, P)
        mine = []
        while first < hi:
            t = first // nt
            end = min(hi, (t + 1) * nt)
            mine.append((t, first % nt, first % nt + end - first))
            first = end
        out.append(mine)
    return out


def merge(best: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The ``k`` smallest of ``best [..., k]`` and ``values`` per row,
    ascending, with duplicates: what the kernels' insertion keeps."""
    return torch.sort(torch.cat([best, values], dim=-1), dim=-1).values[
        ..., :best.shape[-1]]


def split_and_merge(d2: torch.Tensor, higher: torch.Tensor, k: int,
                    blocks: int | None = None):
    """K3-knn's ``(knn2, rowmax2)`` and K3-parent's ``parent2`` from the
    full ``d2 [B, N, N]`` as the kernels decompose it: per block its runs,
    per run its neighbour tiles, per tile four passes of 32 neighbours, 8
    of them per lane and 4 lanes per token, each lane's own multiset; the
    lanes merged at the end of a run, the runs' partials in block order."""
    B, N, _ = d2.shape
    tt = -(-N // TOKENS)
    masked = torch.where(higher, d2, torch.full_like(d2, dpc_knn.BIG))
    flat = d2.reshape(B * N, N)
    flat_masked = masked.reshape(B * N, N)
    partials = {}  # token tile -> [(knn, rowmax, parent)] in block order
    for mine in runs(B, N, blocks):
        for t, u0, u1 in mine:
            b, i0 = divmod(t, tt)
            rows = slice(b * N + i0 * TOKENS,
                         b * N + min(N, (i0 + 1) * TOKENS))
            # the lanes' columns of tiles u0 .. u1: lane l takes columns
            # whose offset in their 32-wide pass is in [8 l, 8 l + 8)
            cols = torch.arange(u0 * TILE, min(N, u1 * TILE))
            lane_of = (cols % PASS) // (PASS // LANES)
            best = torch.full((rows.stop - rows.start, k), dpc_knn.BIG)
            for lane in range(LANES):
                mine_cols = cols[lane_of == lane]
                if len(mine_cols):
                    best = merge(best, torch.sort(
                        flat[rows][:, mine_cols], dim=-1).values[:, :k])
            partials.setdefault(t, []).append((
                best, flat[rows][:, cols].amax(-1),
                flat_masked[rows][:, cols].amin(-1)))
    knn2 = torch.empty(B * N, k)
    rmax2, parent2 = torch.empty(B * N), torch.empty(B * N)
    for t, parts in partials.items():
        b, i0 = divmod(t, tt)
        rows = slice(b * N + i0 * TOKENS, b * N + min(N, (i0 + 1) * TOKENS))
        best, row_max, pmin = parts[0]
        for other, m, p in parts[1:]:
            best, row_max = merge(best, other), torch.maximum(row_max, m)
            pmin = torch.minimum(pmin, p)
        knn2[rows], rmax2[rows], parent2[rows] = best, row_max, pmin
    return knn2.view(B, N, k), rmax2.view(B, N), parent2.view(B, N)


def _case(B, N, C, seed):
    """Tokens with exact ties: the last third repeats one vector of +-1
    entries (its distances are exactly 0 in any summation order), and
    tokens 1 and 2 are equal."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    x[:, N - N // 3:] = torch.from_numpy(rng.choice([-1.0, 1.0], size=C)
                                         .astype(np.float32))
    if N > 2:
        x[:, 2] = x[:, 1]
    density = torch.from_numpy(rng.uniform(size=(B, N)).astype(np.float32))
    return x, (x * x).sum(-1), density


@pytest.mark.parametrize("B,N", [
    (4, 2500), (1, 1), (1, 64), (1, 129), (2, 1345), (16, 5000), (1, 20000),
    (3, 700)])
def test_plan_is_restated(B, N):
    got = dpc_knn.dpc_plan(B, N)
    assert (got.token_tiles, got.tiles, got.items, got.blocks) == plan(B, N)


@pytest.mark.parametrize("B,N,blocks", [
    (4, 2500, None), (1, 1, None), (1, 129, None), (2, 1345, None),
    (4, 2500, 160), (4, 2500, 161), (4, 2500, 3200), (16, 5000, None),
    (1, 20000, None), (1, 20000, 313), (3, 700, 77)])
def test_runs_cover_every_pair_once(B, N, blocks):
    """From the token tiles to the items, any block count gives each block
    at most two runs, every pair once, and the finishing kernel's lookups
    (the blocks of a token tile from either end of its pairs, a block's
    run from its first pair) agree with the runs."""
    tt, nt, items, P = plan(B, N)
    P = blocks or P
    assert B * tt <= P <= items
    seen = []
    for p, mine in enumerate(runs(B, N, blocks)):
        assert 1 <= len(mine) <= 2
        for t, u0, u1 in mine:
            seen += [t * nt + u for u in range(u0, u1)]
            assert (block_of(t * nt, items, P) <= p
                    <= block_of(t * nt + nt - 1, items, P))
            assert (lo(p, items, P) // nt == t) == (mine[0][0] == t)
    assert seen == list(range(items))


def test_plan_at_the_production_shape():
    """B=4, N=2500 (the student's ClusterMergeNet): 40 token tiles a bag,
    20 neighbour tiles, 3,200 pairs over 264 blocks (one wave of two blocks
    an SM), 12 or 13 pairs each."""
    p = dpc_knn.dpc_plan(4, 2500)
    assert (p.token_tiles, p.tiles, p.items, p.blocks) == (40, 20, 3200, 264)
    assert {lo(i + 1, p.items, p.blocks) - lo(i, p.items, p.blocks)
            for i in range(p.blocks)} == {12, 13}


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("blocks", [22, 23, 30, 44, 45, 97, 160, 241, 242])
def test_split_and_merge_is_exact_at_every_block_count(blocks, k):
    """N = 1345 (11 neighbour tiles, the last 65 wide; 22 token tiles, the
    last 1 wide): block counts from one token tile a block (22) to one pair
    (242), most of them not dividing the 242 pairs, give topk of the full
    row, its max and its masked min, bit for bit, ties included."""
    B, N, C = 1, 10 * TILE + 65, 8
    x, x2, density = _case(B, N, C, seed=blocks)
    d2 = dpc_knn.squared_distances(x, x2)
    higher = density[:, None, :] > density[:, :, None]
    knn2, rmax2, parent2 = split_and_merge(d2, higher, k, blocks)
    want_knn, want_rmax = dpc_knn.knn_stream_reference(x, x2, k)
    assert torch.equal(knn2, want_knn)
    assert torch.equal(rmax2, want_rmax)
    assert torch.equal(parent2, dpc_knn.parent_stream_reference(x, x2,
                                                                 density))
    # the ties are there: a repeated token's multiset is all zeros
    assert (knn2[:, -1] == 0).all()


@pytest.mark.parametrize("B,N,k", [(1, 1, 1), (1, 30, 8), (3, 64, 5),
                                   (2, 130, 8)])
def test_split_and_merge_below_and_at_one_tile(B, N, k):
    """At most two tiles of neighbours: lanes with nothing to take, a pass
    cut short, every block one run."""
    x, x2, density = _case(B, N, 4, seed=N)
    d2 = dpc_knn.squared_distances(x, x2)
    higher = density[:, None, :] > density[:, :, None]
    knn2, rmax2, parent2 = split_and_merge(d2, higher, k)
    want_knn, want_rmax = dpc_knn.knn_stream_reference(x, x2, k)
    assert torch.equal(knn2, want_knn) and torch.equal(rmax2, want_rmax)
    assert torch.equal(parent2, dpc_knn.parent_stream_reference(x, x2,
                                                                 density))

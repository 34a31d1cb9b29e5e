"""Why the fused attentions' products (K6 and K7-fwd, ``csrc/tf32_mma.cuh``)
run on the tensor cores as three TF32 passes and not one.

The card's TF32 products keep 10 mantissa bits of each operand.  The
kernels split each f32 operand as ``hi = rna(a)``, ``lo = rna(a - hi)``
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero) and form
``a b`` as ``hi_a hi_b + hi_a lo_b + lo_a hi_b`` with an f32 accumulator.
This emulates that on the CPU at K6's shapes (k ``[144, 64]`` against a
256-query slice of q for ``sim``, then ``out = p^T v``) and holds it
against float64: three passes stay well inside ``K6_ATTN_TOL`` and
``K6_OUT_TOL`` (the card's tolerances for K6-fwd against its plain
version), one pass does not.  Each product of two TF32 values is exact in
float64; the accumulator is rounded to f32 after each k8 step, as one
``mma.sync`` m16n8k8 adds its eight products to it.  The tensor cores'
own rounding inside a step differs in detail; the kernels themselves are
held to the tolerances on the card (``chip_smoke.py`` phase 2e,
``tests/test_torch_cuda.py``).

K7-fwd (``csrc/fused_exact.cu``) forms the same products with its own
operands: sim = k q^T over the head dims and out^T = v^T drop(p)^T over the
kv points, each with the large and the small terms in accumulators of
their own, added at the end.  At both of phase 2f's shapes (the teacher's
K 144, D 64; the 1-D attention's K 625, D 16, in kv chunks of 160 with a
running max and sum) the emulated kernel's map and out stay well inside
``K2_TOL``, K7's tolerance against its plain version, and one pass does
not.
"""

import numpy as np
import pytest
import torch

K6_ATTN_TOL, K6_OUT_TOL = 1e-6, 1e-5
K2_TOL = 1e-4  # K7-fwd's out and map against its plain version
# "well inside": three passes within a tenth of each tolerance
MARGIN = 0.1


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on an f32 tensor: the 13 low mantissa bits
    rounded off, to nearest, ties away from zero (adding half of the last
    kept bit to the magnitude, then truncating), on an int32 view."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a [M, Kd] @ b [Kd, N]`` as the kernels form it: per k8 step the
    products of the passes (``lo_a hi_b``, ``hi_a lo_b`` first, then
    ``hi_a hi_b``; one pass: ``hi_a hi_b`` only), each step's sum added to
    an f32 accumulator."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
            acc = (acc.double() + step).float()
    return acc


def _k6_operands(seed: int = 0, kv: int = 144, nq: int = 256, d: int = 64):
    """k, v ``[144, 64]`` and 256 queries of q (pre-scaled by d^-1/2), as
    K6's phase-2e inputs are drawn, and a bias of O(1)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32))

    return (f32(rng.normal(size=(kv, d))), f32(rng.normal(size=(kv, d))),
            f32(rng.normal(size=(nq, d)) * d ** -0.5),
            f32(rng.normal(size=(kv, nq))))


def _errors(passes: int, seed: int = 0) -> tuple[float, float]:
    """Max abs error against float64 of the softmax over kv of ``k q^T +
    bias`` (the map) and of ``out = p^T v`` with ``p`` the float64 map
    rounded to f32, at ``passes`` TF32 passes."""
    k, v, q, bias = _k6_operands(seed)
    sim64 = k.double() @ q.double().T + bias.double()
    sim = tf32_matmul(k, q.T.contiguous(), passes).double() + bias.double()
    attn_err = (torch.softmax(sim, 0) - torch.softmax(sim64, 0)).abs().max()
    p = torch.softmax(sim64, 0).float()
    out64 = p.double().T @ v.double()
    out = tf32_matmul(p.T.contiguous(), v, passes).double()
    return attn_err.item(), (out - out64).abs().max().item()


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),      # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),   # a tie above an odd bit
    (2.0 - 2.0 ** -11, 2.0),                   # the carry into the exponent
])
def test_tf32_rounding_is_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32)).item()
    assert got == np.float32(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_about_22_bits(seed):
    """hi + lo reconstructs an f32 value to within 2^-21 relative: the
    two halves hold 11 significant bits each."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_passes_hold_the_k6_tolerances(seed):
    attn_err, out_err = _errors(3, seed)
    assert attn_err <= MARGIN * K6_ATTN_TOL, attn_err
    assert out_err <= MARGIN * K6_OUT_TOL, out_err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_tf32_pass_does_not(seed):
    attn_err, out_err = _errors(1, seed)
    assert attn_err > K6_ATTN_TOL, attn_err
    assert out_err > K6_OUT_TOL, out_err


def tf32_matmul_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, Kd] @ b [Kd, N]`` as ``mma_3xtf32(big, small, ...)`` forms
    it: per k8 step the small terms (``lo_a hi_b``, then ``hi_a lo_b``)
    into one f32 accumulator, ``hi_a hi_b`` into another, the two added
    at the end."""
    ah, al = split(a)
    bh, bl = split(b)
    big = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl)):
            small = (small.double() + x[:, s].double() @ y[s].double()).float()
        big = (big.double() + ah[:, s].double() @ bh[s].double()).float()
    return big + small


def _k7_emulated(q, k, v, bias, chunk: int = 160, passes: int = 3):
    """K7-fwd's arithmetic for one bh: sim = k q^T (3xTF32, the head dims
    padded to 8 with zeros) + bias per kv chunk, the running max and sum of
    exp over the chunks, p = exp(sim - max) / sum, out^T = v^T p^T
    (3xTF32, the chunks' k8 steps in order into the same accumulators).
    ``passes=1`` forms both products in one TF32 pass instead.
    ``q [N, D]``, ``k, v [K, D]``, ``bias [K, N]`` -> ``(out [N, D],
    attn [K, N])``."""
    def matmul(a, b):
        return tf32_matmul_split(a, b) if passes == 3 else tf32_matmul(a, b, 1)

    D = q.shape[1]
    pad = -D % 8
    qp = torch.nn.functional.pad(q, (0, pad))
    kp = torch.nn.functional.pad(k, (0, pad))
    sims = [matmul(kp[c:c + chunk], qp.T.contiguous())
            + bias[c:c + chunk] for c in range(0, k.shape[0], chunk)]
    mx = torch.full((q.shape[0],), -float("inf"))
    total = torch.zeros(q.shape[0])
    for s in sims:
        m = torch.maximum(mx, s.max(0).values)
        total = total * torch.exp(mx - m) + torch.exp(s - m).sum(0)
        mx = m
    attn = torch.cat([torch.exp(s - mx) / total for s in sims])
    out_t = matmul(v.T.contiguous(), attn)
    return out_t.T, attn


def _k7_errors(K: int, D: int, passes: int) -> tuple[float, float]:
    """Max abs error against float64 of the emulated K7-fwd's map and out
    at ``passes`` TF32 passes, on 96 queries drawn as phase 2f draws them
    (q pre-scaled by D^-1/2, an O(1) bias)."""
    rng = np.random.default_rng(K)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    q, k, v, bias = (f32(96, D, scale=D ** -0.5), f32(K, D), f32(K, D),
                     f32(K, 96))
    out, attn = _k7_emulated(q, k, v, bias, passes=passes)
    sim64 = k.double() @ q.double().T + bias.double()
    attn64 = torch.softmax(sim64, 0)
    out64 = attn64.T @ v.double()
    return ((attn.double() - attn64).abs().max().item(),
            (out.double() - out64).abs().max().item())


K7_SHAPES = pytest.mark.parametrize("K,D", [(144, 64), (625, 16)],
                                    ids=["teacher", "1-D chunked"])


@K7_SHAPES
def test_three_tf32_passes_hold_k7_tolerance(K, D):
    """K7-fwd's 3xTF32 sim and PV at phase 2f's shapes: the map and out
    within a tenth of ``K2_TOL`` of float64."""
    attn_err, out_err = _k7_errors(K, D, 3)
    assert attn_err <= MARGIN * K2_TOL, attn_err
    assert out_err <= MARGIN * K2_TOL, out_err


@K7_SHAPES
def test_one_tf32_pass_misses_k7_tolerance(K, D):
    """At the same shapes one TF32 pass puts the map and out outside
    ``K2_TOL``: K7-fwd's limit tells the 3xTF32 products from one pass."""
    attn_err, out_err = _k7_errors(K, D, 1)
    assert attn_err > K2_TOL, attn_err
    assert out_err > K2_TOL, out_err

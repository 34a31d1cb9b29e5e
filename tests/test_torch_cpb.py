"""The port's CPB ops (``disentangled_multimodal_learning_tpu_torch/ops``)
against the JAX package: the plain versions of kernels K1 (table CPB) and
K2 (exact CPB) on the CPU, the wrapper routing rules, and the kernel build
key.  The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.

Tolerances: 1e-5 abs on biases of O(1) in f32 (the port and JAX sum the MLP
in other orders and JAX's exact path uses log(|x|+1) for log1p).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models.deform_attention import _cpb_mlp
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu_torch.ops import build, cpb

TOL = 1e-5


def _mlp(rng, o=1):
    h = cpb.HID
    w = [rng.normal(size=(2, h)) / np.sqrt(2), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, o)) / np.sqrt(h), rng.normal(size=(o,)) * 0.1]
    return [a.astype(np.float32) for a in w]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("side,kv_bound", [(12, 1.4), (50, 1.0 + 8.0 / 11)])
def test_table_cpb_matches_jax(rng, side, kv_bound):
    """Plain K1 + table build + taps == JAX ``cpb_bias_table`` at divisor 1,
    through its interpret-mode Pallas kernel and through its jnp
    interpolation.  side 50 is the production lattice (tn 139, where JAX
    uses its lane-split layout).  Two kv points lie four lattice cells past
    the bound, so that their clipped rows extrapolate (fractions down to
    about -2 and up to 3; far beyond that, the blend's cancellation
    amplifies the f32 rounding of the table past the tolerance)."""
    BH, K = 2, 8
    gkv = rng.uniform(-kv_bound, kv_bound, size=(BH, K, 2)).astype(np.float32)
    far = kv_bound + 4.0 * 2.0 / (side - 1)  # four lattice cells past
    gkv[0, :2] = [[far, -far], [-far, far]]
    w = _mlp(rng)
    got = cpb.cpb_bias_table(torch.from_numpy(gkv), *_t(w), side=side,
                             kv_bound=kv_bound).numpy()
    shifts = cpb.table_shifts(torch.from_numpy(gkv), side=side,
                              kv_bound=kv_bound)
    _, fracs = cpb.table_taps(shifts, side=side,
                              tn=cpb.table_consts(side, kv_bound)[2])
    assert (fracs < -0.5).any() and (fracs > 1.5).any()
    for use_kernel in (True, False):
        want = jda.cpb_bias_table(jnp.asarray(gkv), *map(jnp.asarray, w),
                                  side=side, divisor=1, kv_bound=kv_bound,
                                  use_kernel=use_kernel, interpret=True)
        assert got.shape == want.shape == (BH, K, side * side)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_table_consts_match_jax():
    for side, kv_bound in [(12, 1.4), (50, 1.0 + 8.0 / 11), (8, 9.0)]:
        h, t0, rn, tn = jda._tbl_consts(side, 1, kv_bound)
        assert cpb.table_consts(side, kv_bound) == (h, t0, tn)
        assert rn == tn


def test_table_taps_match_jax_tbl_idx(rng):
    """The taps/fractions port of ``_tbl_idx`` at divisor 1 (no lane
    split): row tap, column tap and both fractions, clipped rows included."""
    side, tn = 12, 33
    shifts = rng.uniform(-5, tn + 5, size=(64, 2)).astype(np.float32)
    idx, frac = jda._tbl_idx(jnp.asarray(shifts), side, 1, tn)
    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=side, tn=tn)
    np.testing.assert_array_equal(taps.numpy()[:, 0], np.asarray(idx)[:, 0])
    np.testing.assert_array_equal(taps.numpy()[:, 1], np.asarray(idx)[:, 4])
    np.testing.assert_array_equal(fracs.numpy(), np.asarray(frac))
    assert taps.dtype == torch.int32 and fracs.dtype == torch.float32


@pytest.mark.parametrize("o", [1, 2])
def test_exact_cpb_matches_jax(rng, o):
    """Plain K2 == JAX ``cpb_bias_transposed`` (interpret-mode Pallas) and
    the XLA ``_cpb_mlp`` path, in the kv-major layout; O=2 is the
    multichannel layout ``[BH, O, K, N]``."""
    BH, K, N = 3, 5, 24
    gq = rng.uniform(-1, 1, size=(N, 2)).astype(np.float32)
    gkv = rng.uniform(-1.5, 1.5, size=(BH, K, 2)).astype(np.float32)
    w = _mlp(rng, o)
    got = cpb.cpb_bias_transposed(torch.from_numpy(gq), torch.from_numpy(gkv),
                                  *_t(w)).numpy()
    jw = list(map(jnp.asarray, w))
    kern = np.asarray(jda.cpb_bias_transposed(jnp.asarray(gq), jnp.asarray(gkv),
                                              *jw, interpret=True))
    mlp = np.asarray(_cpb_mlp(jnp.asarray(gq), jnp.asarray(gkv), *jw, True,
                              jnp.float32))          # [BH, N, K, O]
    mlp = np.moveaxis(mlp, 3, 1).swapaxes(2, 3)      # [BH, O, K, N]
    if o == 1:
        mlp = mlp[:, 0]
    want_shape = (BH, K, N) if o == 1 else (BH, o, K, N)
    assert got.shape == kern.shape == mlp.shape == want_shape
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, mlp, atol=TOL, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu_without_counting(rng):
    table = torch.from_numpy(rng.normal(size=(20, 20)).astype(np.float32))
    taps = torch.tensor([[0, 3], [9, 0]], dtype=torch.int32)
    fracs = torch.tensor([[0.25, -0.5], [1.0, 0.75]])
    before = cpb.table_interp.launches
    np.testing.assert_array_equal(
        cpb.table_interp(table, taps, fracs, 10).numpy(),
        cpb.table_interp_reference(table, taps, fracs, 10).numpy())
    assert cpb.table_interp.launches == before

    gq, gkv = torch.zeros(4, 2), torch.zeros(1, 3, 2)
    w = _t(_mlp(rng))
    before = cpb.cpb_bias_transposed.launches
    np.testing.assert_array_equal(
        cpb.cpb_bias_transposed(gq, gkv, *w).numpy(),
        cpb.cpb_bias_transposed_reference(gq, gkv, *w).numpy())
    assert cpb.cpb_bias_transposed.launches == before


def test_table_interp_reference_blend_order():
    """y-blend first, then x-blend, of the four taps; a fraction outside
    [0, 1] extrapolates linearly."""
    table = torch.arange(36, dtype=torch.float32).reshape(6, 6) ** 2
    taps = torch.tensor([[1, 2]], dtype=torch.int32)
    fy, fx = 0.25, 1.5
    out = cpb.table_interp_reference(table, taps, torch.tensor([[fy, fx]]), 3)
    t = table.numpy()
    for y in range(3):
        for x in range(3):
            a = t[1 + y, 2 + x] * (1 - fy) + t[2 + y, 2 + x] * fy
            b = t[1 + y, 3 + x] * (1 - fy) + t[2 + y, 3 + x] * fy
            assert out[0, y, x].item() == pytest.approx(a * (1 - fx) + b * fx)


def test_wrappers_raise_off_cpu_instead_of_falling_back(rng):
    """A tensor that is neither on the CPU nor on a CUDA device is refused:
    no wrapper falls back to the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cpb.table_interp(torch.empty(20, 20, **meta),
                         torch.empty(2, 2, dtype=torch.int32, **meta),
                         torch.empty(2, 2, **meta), 10)
    w = [torch.empty(s, **meta) for s in
         [(2, 32), (32,), (32, 32), (32,), (32, 1), (1,)]]
    with pytest.raises(ValueError, match="CUDA"):
        cpb.cpb_bias_transposed(torch.empty(4, 2, **meta),
                                torch.empty(1, 3, 2, **meta), *w)


def test_kernel_build_key_follows_the_sources(tmp_path, monkeypatch):
    """The library directory is keyed by the kernel sources: unchanged
    sources reuse it, an edited source or shared header gets a new one."""
    for src in build.sources() + build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_dir()
    assert first == build.library_dir()
    assert first.parent == build.BUILD_ROOT
    assert {p.name for p in build.sources()} == {
        "cpb_exact.cu", "cpb_exact_bwd.cu", "cpb_table.cu", "cpb_table_1d.cu",
        "cpb_table_1d_bwd.cu", "cpb_table_bwd.cu", "cpb_table_strided.cu",
        "cpb_table_strided_bwd.cu", "dpc_knn.cu", "fused_exact.cu",
        "fused_exact_bwd.cu", "fused_table.cu", "fused_table_bwd.cu"}
    assert [p.name for p in build.headers()] == [
        "cpb_exact.cuh", "fixed_order_sum.cuh", "fused_attention_bwd.cuh",
        "fused_table.cuh", "table_bwd_tiles.cuh", "tf32_mma.cuh"]
    (tmp_path / "fixed_order_sum.cuh").write_text("// edited\n")
    second = build.library_dir()
    assert second != first
    (tmp_path / "cpb_table.cu").write_text("// edited\n")
    assert build.library_dir() not in (first, second)


def test_every_bound_entry_point_is_defined_in_the_sources():
    """Each C entry point that ``ops/build.py`` binds with ``ctypes`` is
    defined with C linkage in ``csrc/*.cu`` (a missing one would fail only
    when the library loads on the card)."""
    text = "".join(src.read_text() for src in build.sources())
    for name in build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name


@pytest.mark.parametrize("rows", [1, 21, 395, 396, 397, 4608, 10000])
def test_exact_backward_partition_follows_the_row_count(rows):
    """K2-bwd's blocks: at most ``EXACT_BWD_BLOCKS``, each taking
    ``ceil(rows / parts)`` whole kv rows as the kernel does, none left
    empty; a function of the row count alone, so the partial results and
    the order of their sum are fixed (4608 and 10000 are the teacher's and
    the 1-D attention's rows)."""
    parts = cpb.exact_bwd_parts(rows)
    per_block = -(-rows // parts)
    assert 1 <= parts <= cpb.EXACT_BWD_BLOCKS
    assert per_block * (parts - 1) < rows <= per_block * parts

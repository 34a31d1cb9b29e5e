"""The port's 1-D table CPB (``ops/cpb1d.py``, kernel K4's plain versions)
against the JAX package on the CPU: the bias of ``cpb_bias_table_1d`` (its
jnp reference and its interpret-mode Pallas kernel, in the plain and the
``TBL1_W128`` layouts), the lattice geometry and taps, the plain backward
against the ``_tbl1_bwd_kernel`` custom VJP, the gradients of the whole
path, and the wrapper routing rules.  The CUDA kernels are held against
these plain versions on the card by ``tests/test_torch_cuda.py``.

Tolerances: 1e-6 abs on the bias (the port and JAX build the same f32 table
in other matmul orders; the blend itself is the same two-term lerp); 1e-5
rel-L2 on the plain backward's table and shift cotangents on a random
table (sums of up to 2 n_q terms in another order); for the whole path's
gradients 3e-5 of each gradient's largest entry for w1 and w2 (observed
below 1e-6), 1e-4 rel-L2 for the other weights, and for grid_kv 3e-5 of
its largest entry at n_q 64, scaled by (n_q - 1) / 63 at longer sequences:
its shift cotangent sums d * (T[i+1] - T[i]), differences of neighbouring
table entries, so each framework's f32 table rounding (~1e-7 of |T|) is
divided by a table step that shrinks as 2 / (n_q - 1).  Observed: 8e-6 at
n_q 64, up to 4.2e-5 at n_q 257 (bound 1.2e-4); at n_q 2501 the port and
JAX are each 1e-4 to 4e-4 off a float64 evaluation of the same function,
the f32 table's own limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu_torch.ops import cpb, cpb1d

BIAS_TOL, BWD_TOL, SCALED_TOL, PATH_TOL = 1e-6, 1e-5, 3e-5, 1e-4
# (n_q, K, BH, O, kv_bound): the golden case of
# tests/test_pallas_deform.py::test_cpb_table_1d_kernel_and_accuracy, and a
# longer odd sequence
CASES = [(64, 10, 4, 2, 1.2), (257, 7, 3, 2, 1.05)]


def _mlp(rng, o=2):
    h = cpb.HID
    w = [rng.normal(size=(1, h)), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, o)) / np.sqrt(h), rng.normal(size=(o,)) * 0.1]
    return [a.astype(np.float32) for a in w]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("w128", [False, True])
@pytest.mark.parametrize("n_q,K,BH,O,kv_bound", CASES)
def test_table_cpb_1d_matches_jax(monkeypatch, rng, n_q, K, BH, O, kv_bound,
                                  w128):
    """``[BH, O, K, n_q]`` against ``cpb_bias_table_1d`` through its jnp
    reference and its interpret-mode kernel (the ``[1, cn]`` layout, or the
    ``[rows, 128]`` one with ``TBL1_W128``, a module global set here and
    restored)."""
    monkeypatch.setattr(jda, "TBL1_W128", w128)
    gkv = rng.uniform(-kv_bound, kv_bound, size=(BH, K)).astype(np.float32)
    w = _mlp(rng, O)
    args = (jnp.asarray(gkv), *map(jnp.asarray, w))
    ref = jda.cpb_bias_table_1d(*args, n_q=n_q, kv_bound=kv_bound,
                                use_kernel=False)
    kern = jda.cpb_bias_table_1d(*args, n_q=n_q, kv_bound=kv_bound,
                                 use_kernel=True, interpret=True)
    got = cpb1d.cpb_bias_table_1d(*_t([gkv] + w), n_q=n_q, kv_bound=kv_bound)
    assert got.shape == ref.shape == kern.shape == (BH, O, K, n_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BIAS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=BIAS_TOL,
                               rtol=0)


@pytest.mark.parametrize("n_q,kv_bound", [(64, 1.2), (2501, 1.0 + 4.0 / 624)])
def test_table1d_geometry_and_taps_match_jax(rng, n_q, kv_bound):
    """The lattice size (``tn``; 5,023 at the preset's n_q 2501, K 625) and
    the taps and fractions of ``_tbl1_idx``, clipped rows included."""
    s = 2.0 / (n_q - 1)
    n_lo = int(-(-(1.0 + kv_bound) // s)) + 2
    _, t0, tn = cpb.table_consts(n_q, kv_bound)
    assert tn == 2 * n_lo + 1 and t0 == -n_lo * s
    if n_q == 2501:
        assert tn == 5023
    gkv = rng.uniform(-1.3 * kv_bound, 1.3 * kv_bound,
                      size=(3, 50)).astype(np.float32)
    shifts = cpb1d.table1d_shifts(torch.from_numpy(gkv), n_q=n_q,
                                  kv_bound=kv_bound)
    np.testing.assert_allclose(
        shifts.numpy(), ((-1.0 - gkv - np.float32(t0)) / np.float32(s))
        .reshape(-1), rtol=1e-6)
    taps, fracs = cpb1d.table1d_taps(shifts, n_q=n_q, tn=tn)
    want_i, want_f = jda._tbl1_idx(jnp.asarray(shifts.numpy()), n_q, tn)
    np.testing.assert_array_equal(taps.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(fracs.numpy(), np.asarray(want_f))
    assert taps.dtype == torch.int32 and ((fracs < 0) | (fracs > 1)).any()


def test_table1d_interp_reference_blend_order():
    """``T[c, ox+n] * (1 - f) + T[c, ox+n+1] * f`` per channel, rows
    ``bg * kv + k`` landing at ``[bg, c, k, n]``; a fraction outside [0, 1]
    extrapolates linearly."""
    table = (torch.arange(40, dtype=torch.float32).reshape(2, 20) ** 2)
    taps = torch.tensor([1, 5, 0, 9], dtype=torch.int32)
    fracs = torch.tensor([0.25, -0.5, 1.5, 0.0])
    out = cpb1d.table1d_interp_reference(table, taps, fracs, 6, 2)
    assert out.shape == (2, 2, 2, 6)
    t = table.numpy()
    for r in range(4):
        bg, k = divmod(r, 2)
        f = fracs[r].item()
        for c in range(2):
            for n in range(6):
                want = (t[c, taps[r] + n] * (1 - f)
                        + t[c, taps[r] + n + 1] * f)
                assert out[bg, c, k, n].item() == pytest.approx(want)


def _interp_case(rng, n_q, bg=3, kv=5, o=2):
    """A random table [O, tn], shifts with rows clipped past both ends (up
    to 4 cells), and a cotangent in the attention layout."""
    tn = n_q + 30
    table = rng.normal(size=(o, tn)).astype(np.float32)
    shifts = rng.uniform(-4, tn - n_q - 2 + 4,
                         size=(bg * kv,)).astype(np.float32)
    dout = rng.normal(size=(bg, o, kv, n_q)).astype(np.float32)
    return table, shifts, dout, tn, kv


@pytest.mark.parametrize("n_q", [64, 257])
def test_table1d_interp_backward_matches_jax_custom_vjp(rng, n_q):
    """dtable and dshifts of K4's plain backward == the cotangents of JAX's
    ``_table1_interp`` (interpret-mode ``_tbl1_bwd_kernel``) on the same
    table, padded to whole 128-lane tiles as JAX pads it; the port's
    autograd (``table1d_interp`` -> ``_Table1dInterp``) gives the same."""
    table, shifts, dout, tn, kv = _interp_case(rng, n_q)
    o = table.shape[0]
    cn = -(-tn // 128) * 128
    tablep = np.pad(table, ((0, 0), (0, cn - tn)))
    # JAX's layout: rows [R, O, n_q]
    drows = dout.transpose(0, 2, 1, 3).reshape(-1, o, n_q)
    _, vjp = jax.vjp(lambda t, s: jda._table1_interp(t, s, n_q, tn, True),
                     jnp.asarray(tablep), jnp.asarray(shifts[:, None]))
    dtab, dsh = (np.asarray(a) for a in vjp(jnp.asarray(drows)))
    assert not dtab[:, tn:].any()

    taps, fracs = cpb1d.table1d_taps(torch.from_numpy(shifts), n_q=n_q, tn=tn)
    assert ((fracs < 0) | (fracs > 1)).sum() >= 2
    dtable, dshifts = cpb1d.table1d_interp_backward_reference(
        torch.from_numpy(table), taps, fracs, torch.from_numpy(dout), n_q, kv)
    assert _rel(dtable, dtab[:, :tn]) <= BWD_TOL
    assert _rel(dshifts, dsh[:, 0]) <= BWD_TOL

    t = torch.from_numpy(table).requires_grad_()
    f = fracs.clone().requires_grad_()
    cpb1d.table1d_interp(t, taps, f, n_q, kv).backward(torch.from_numpy(dout))
    assert torch.equal(t.grad, dtable) and torch.equal(f.grad, dshifts)


def test_clipped_rows_keep_their_shift_cotangent_1d(rng):
    """A clipped row extrapolates, and its shift cotangent is the
    derivative of that extrapolation (not zero): the forward is linear in
    the fraction, so a float64 central difference gives it exactly; JAX's
    custom VJP agrees."""
    n_q = 64
    table, shifts, dout, tn, kv = _interp_case(rng, n_q)
    taps, fracs = cpb1d.table1d_taps(torch.from_numpy(shifts), n_q=n_q, tn=tn)
    clipped = (fracs < 0) | (fracs > 1)
    _, dshifts = cpb1d.table1d_interp_backward_reference(
        torch.from_numpy(table), taps, fracs, torch.from_numpy(dout), n_q, kv)
    assert (dshifts[clipped].abs() > 1e-3).all()
    t64, d64 = torch.from_numpy(table).double(), torch.from_numpy(dout).double()

    def loss_per_row(f):
        out = cpb1d.table1d_interp_reference(t64, taps, f, n_q, kv)
        return (out * d64).sum(dim=(1, 3)).reshape(-1)  # rows bg * kv + k

    numeric = loss_per_row(fracs.double() + 0.5) - loss_per_row(
        fracs.double() - 0.5)
    np.testing.assert_allclose(dshifts[clipped].numpy(),
                               numeric[clipped].numpy(), rtol=1e-4, atol=1e-4)
    cn = -(-tn // 128) * 128
    tablep = np.pad(table, ((0, 0), (0, cn - tn)))
    drows = dout.transpose(0, 2, 1, 3).reshape(-1, table.shape[0], n_q)
    _, vjp = jax.vjp(lambda s: jda._table1_interp(jnp.asarray(tablep), s, n_q,
                                                  tn, True),
                     jnp.asarray(shifts[:, None]))
    dsh = np.asarray(vjp(jnp.asarray(drows))[0])[:, 0]
    np.testing.assert_allclose(dshifts[clipped].numpy(), dsh[clipped.numpy()],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_q,K,BH,O,kv_bound", CASES)
def test_table_cpb_1d_gradients_match_jax(rng, n_q, K, BH, O, kv_bound):
    """The whole 1-D table CPB (table build, shifts, taps, K4)
    differentiated with respect to grid_kv and the MLP weights ==
    ``jax.vjp`` of ``cpb_bias_table_1d(use_kernel=True, interpret=True)``
    (the ``_tbl1_bwd_kernel`` custom VJP), with one kv point two cells past
    the bound, so that its row clips and extrapolates."""
    s, t0, tn = cpb.table_consts(n_q, kv_bound)
    gkv = rng.uniform(-kv_bound, kv_bound, size=(BH, K)).astype(np.float32)
    gkv[0, 0] = kv_bound + 4 * s  # the lattice keeps 2 cells of margin
    w = _mlp(rng, O)
    dout = rng.normal(size=(BH, O, K, n_q)).astype(np.float32)

    def jfn(gkv_, *w_):
        return jda.cpb_bias_table_1d(gkv_, *w_, n_q=n_q, kv_bound=kv_bound,
                                     use_kernel=True, interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(gkv), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).requires_grad_() for a in [gkv] + w]
    cpb1d.cpb_bias_table_1d(*leaves, n_q=n_q, kv_bound=kv_bound).backward(
        torch.from_numpy(dout))
    _, fracs = cpb1d.table1d_taps(
        cpb1d.table1d_shifts(leaves[0].detach(), n_q=n_q, kv_bound=kv_bound),
        n_q=n_q, tn=tn)
    assert fracs[0] < 0 and leaves[0].grad[0, 0] != 0
    for name, leaf, ww in zip(("grid_kv", "w1", "b1", "w2", "b2", "w3", "b3"),
                              leaves, want):
        assert leaf.grad.shape == ww.shape, name
        if name == "grid_kv":
            tol = SCALED_TOL * max(1.0, (n_q - 1) / 63)
            assert _scaled(leaf.grad, ww) <= tol, name
        elif name in ("w1", "w2"):
            assert _scaled(leaf.grad, ww) <= SCALED_TOL, name
        else:
            assert _rel(leaf.grad, ww) <= PATH_TOL, name


def test_wrappers_1d_take_the_plain_version_on_cpu_without_counting(rng):
    table = torch.from_numpy(rng.normal(size=(2, 20)).astype(np.float32))
    taps = torch.tensor([0, 3, 9, 1], dtype=torch.int32)
    fracs = torch.tensor([0.25, -0.5, 1.0, 0.75])
    dout = torch.from_numpy(rng.normal(size=(2, 2, 2, 8)).astype(np.float32))
    before = (cpb1d.table1d_interp.launches,
              cpb1d.table1d_interp_backward.launches)
    assert torch.equal(cpb1d.table1d_interp(table, taps, fracs, 8, 2),
                       cpb1d.table1d_interp_reference(table, taps, fracs, 8, 2))
    got = cpb1d.table1d_interp_backward(table, taps, fracs, dout, 8, 2)
    want = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                   8, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cpb1d.table1d_interp.launches,
            cpb1d.table1d_interp_backward.launches) == before


def test_wrappers_1d_raise_off_cpu_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    forward and backward: no fallback to the plain version."""
    meta = dict(device="meta")
    table = torch.empty(2, 20, **meta)
    taps = torch.empty(4, dtype=torch.int32, **meta)
    fracs = torch.empty(4, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        cpb1d.table1d_interp(table, taps, fracs, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cpb1d.table1d_interp_backward(table, taps, fracs,
                                      torch.empty(2, 2, 2, 8, **meta), 8, 2)

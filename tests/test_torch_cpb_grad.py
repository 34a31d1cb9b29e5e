"""Gradients of the port's CPB ops against the JAX package's custom VJPs on
the CPU: the plain backward of K1 (``table_interp_backward_reference``)
against ``_table_interp`` (the ``_tbl_d1_bwd_kernel`` custom VJP, run with
``interpret=True``) and the whole divisor-1 ``cpb_bias_table``; the plain
backward of K2 (``cpb_bias_transposed_backward_reference``) against
``cpb_bias_transposed`` (``_cpbt_bwd_kernel``, ``interpret=True``).  The
port's ops go through their ``torch.autograd.Function``s, which on the CPU
call these plain backwards.  The CUDA backward kernels are held against
the same plain versions on the card by ``tests/test_torch_cuda.py``.

Tolerances, as rel-L2 per gradient in f32: 1e-5 for the table and
fraction cotangents of K1 on a random table (sums of up to a few hundred
terms, summed in another order); 1e-4 for the whole table path's grid_kv
and MLP-weight gradients, whose shift sums cancel heavily on the smooth MLP
table (terms O(1), sums O(1e-2), the ``_tbl_sum2d`` note; 2.6e-5 observed
at side 50); 2e-5 for K2 (sums over every point).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu_torch.ops import cpb

K1_TOL, PATH_TOL, K2_TOL = 1e-5, 1e-4, 2e-5


def _mlp(rng, o=1):
    h = cpb.HID
    w = [rng.normal(size=(2, h)) / np.sqrt(2), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, o)) / np.sqrt(h), rng.normal(size=(o,)) * 0.1]
    return [a.astype(np.float32) for a in w]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _table_case(rng, side):
    """A table, shifts with rows clipped past both ends, and a cotangent."""
    kv_bound = 1.0 + 8.0 / ((side + 2 - 6) // 4)
    tn = cpb.table_consts(side, kv_bound)[2]
    table = rng.normal(size=(tn, tn)).astype(np.float32)
    hi = tn - side - 1
    shifts = rng.uniform(-3, hi + 4, size=(40, 2)).astype(np.float32)
    dout = rng.normal(size=(40, side, side)).astype(np.float32)
    return table, shifts, dout


@pytest.mark.parametrize("side", [12, 50])
def test_table_interp_backward_matches_jax_custom_vjp(rng, side):
    """dtable and dfracs of K1's plain backward == the cotangents of JAX's
    ``_table_interp`` (interpret-mode ``_tbl_d1_bwd_kernel``) on the same
    table, in the unsplit layout (the table padded to whole 128-lane
    tiles).  The port's autograd (``table_interp`` -> ``_TableInterp``)
    gives the same."""
    table, shifts, dout = _table_case(rng, side)
    tn = table.shape[0]
    cn = -(-tn // 128) * 128
    tablep = np.pad(table, ((0, jda._tbl_win_rows(side)), (0, cn - tn)))
    _, vjp = jax.vjp(lambda t, s: jda._table_interp(t, s, side, 1, tn, 0, True),
                     jnp.asarray(tablep), jnp.asarray(shifts))
    dtab, dsh = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    assert not dtab[tn:].any() and not dtab[:, tn:].any()

    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=side, tn=tn)
    assert ((fracs < 0) | (fracs > 1)).any(dim=1).sum() >= 4
    dtable, dfracs = cpb.table_interp_backward_reference(
        torch.from_numpy(table), taps, fracs, torch.from_numpy(dout), side)
    assert _rel(dtable, dtab[:tn, :tn]) <= K1_TOL
    assert _rel(dfracs, dsh) <= K1_TOL

    # (the CPU's accumulating index_put sums in a thread-dependent order)
    t = torch.from_numpy(table).requires_grad_()
    f = fracs.clone().requires_grad_()
    cpb.table_interp(t, taps, f, side).backward(torch.from_numpy(dout))
    assert _rel(t.grad, dtable) <= 1e-6 and torch.equal(f.grad, dfracs)


def test_clipped_rows_keep_their_shift_cotangent(rng):
    """A row whose tap is clipped extrapolates in the forward, and its
    shift cotangent is the derivative of that extrapolation, not zero: in
    JAX's custom VJP (whose comment at ``deform_attn.py:2307-2309`` says
    otherwise) and in the port.  The forward is linear in each fraction, so
    a central difference in float64 gives that derivative exactly."""
    side = 12
    table, shifts, dout = _table_case(rng, side)
    tn = table.shape[0]
    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=side, tn=tn)
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    _, dfracs = cpb.table_interp_backward_reference(
        torch.from_numpy(table), taps, fracs, torch.from_numpy(dout), side)
    assert (dfracs[clipped].abs() > 1e-3).all()

    t64, d64 = torch.from_numpy(table).double(), torch.from_numpy(dout).double()
    for axis in (0, 1):
        step = torch.zeros_like(fracs, dtype=torch.float64)
        step[:, axis] = 0.5

        def loss_per_row(f):
            return (cpb.table_interp_reference(t64, taps, f, side)
                    * d64).sum(dim=(1, 2))

        numeric = (loss_per_row(fracs.double() + step)
                   - loss_per_row(fracs.double() - step)) / 1.0
        np.testing.assert_allclose(dfracs[clipped, axis].numpy(),
                                   numeric[clipped].numpy(), rtol=1e-4,
                                   atol=1e-4)

    cn = -(-tn // 128) * 128
    tablep = np.pad(table, ((0, jda._tbl_win_rows(side)), (0, cn - tn)))
    _, vjp = jax.vjp(lambda s: jda._table_interp(jnp.asarray(tablep), s, side,
                                                 1, tn, 0, True),
                     jnp.asarray(shifts))
    dsh = np.asarray(vjp(jnp.asarray(dout))[0])
    assert (np.abs(dsh[clipped.numpy()]) > 1e-3).all()
    np.testing.assert_allclose(dfracs[clipped].numpy(), dsh[clipped.numpy()],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("side", [12, 50])
def test_table_cpb_gradients_match_jax(rng, side):
    """The whole divisor-1 CPB (table build, taps, K1) differentiated with
    respect to the MLP weights and grid_kv == JAX ``cpb_bias_table(...,
    use_kernel=True, interpret=True)`` (its lane-split layout at side 50),
    with kv points past the bound so that some rows clip."""
    g = (side + 2 - 6) // 4 + 1
    kv_bound = cpb.kv_bound_2d(4.0, g, g)
    gkv = rng.uniform(-1.2 * kv_bound, 1.2 * kv_bound,
                      size=(4, g * g, 2)).astype(np.float32)
    w = _mlp(rng)
    dout = rng.normal(size=(4, g * g, side * side)).astype(np.float32)

    def jfn(gkv_, *w_):
        return jda.cpb_bias_table(gkv_, *w_, side=side, divisor=1,
                                  kv_bound=kv_bound, interpret=True,
                                  use_kernel=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(gkv), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).requires_grad_() for a in [gkv] + w]
    out = cpb.cpb_bias_table(*leaves, side=side, kv_bound=kv_bound)
    out.backward(torch.from_numpy(dout))
    taps_fracs = cpb.table_taps(cpb.table_shifts(leaves[0].detach(), side=side,
                                                 kv_bound=kv_bound),
                                side=side, tn=cpb.table_consts(side, kv_bound)[2])
    assert ((taps_fracs[1] < 0) | (taps_fracs[1] > 1)).any()
    for name, leaf, ww in zip(("grid_kv", "w1", "b1", "w2", "b2", "w3", "b3"),
                              leaves, want):
        assert leaf.grad.shape == ww.shape, name
        assert _rel(leaf.grad, ww) <= PATH_TOL, name


@pytest.mark.parametrize("o", [1, 2])
def test_exact_cpb_gradients_match_jax_custom_vjp(rng, o):
    """K2's plain backward (through ``cpb_bias_transposed``'s autograd) ==
    the cotangents of JAX ``cpb_bias_transposed(..., interpret=True)``
    (``_cpbt_bwd_kernel``): grid_kv and the six MLP weights, one and two
    output channels; grid_q gets no gradient (JAX returns zeros)."""
    BH, K, N = 3, 5, 24
    gq = rng.uniform(-1, 1, size=(N, 2)).astype(np.float32)
    gkv = rng.uniform(-1.5, 1.5, size=(BH, K, 2)).astype(np.float32)
    w = _mlp(rng, o)
    shape = (BH, K, N) if o == 1 else (BH, o, K, N)
    dbias = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jda.cpb_bias_transposed(*a, interpret=True),
                     jnp.asarray(gq), jnp.asarray(gkv), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dbias))
    assert not np.asarray(want[0]).any()

    gq_t = torch.from_numpy(gq).requires_grad_()
    leaves = [torch.from_numpy(a).requires_grad_() for a in [gkv] + w]
    cpb.cpb_bias_transposed(gq_t, *leaves).backward(torch.from_numpy(dbias))
    assert gq_t.grad is None
    for name, leaf, ww in zip(("grid_kv", "w1", "b1", "w2", "b2", "w3", "b3"),
                              leaves, want[1:]):
        assert leaf.grad.shape == ww.shape, name
        assert _rel(leaf.grad, ww) <= K2_TOL, name


@pytest.mark.parametrize("o", [1, 3])
def test_exact_cpb_plain_backward_is_the_autograd_of_its_forward(rng, o):
    """Written out, K2's plain backward equals autograd through its plain
    forward in float64 (away from p = 0, where the two conventions for the
    derivative of sign(p) log1p|p| differ)."""
    gq = torch.from_numpy(rng.uniform(-1, 1, size=(16, 2)))
    gkv = torch.from_numpy(rng.uniform(-1.5, 1.5, size=(2, 3, 2)))
    w = [torch.from_numpy(a).double() for a in _mlp(rng, o)]
    leaves = [gkv.clone().requires_grad_()] + [t.clone().requires_grad_()
                                              for t in w]
    out = cpb.cpb_bias_transposed_reference(gq, *leaves)
    dbias = torch.from_numpy(rng.normal(size=out.shape))
    want = torch.autograd.grad(out, leaves, dbias)
    got = cpb.cpb_bias_transposed_backward_reference(gq, gkv, *w, dbias)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_backward_wrappers_count_nothing_on_the_cpu(rng):
    table, shifts, dout = _table_case(rng, 12)
    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=12,
                                 tn=table.shape[0])
    before = (cpb.table_interp_backward.launches,
              cpb.cpb_bias_transposed_backward.launches)
    t = torch.from_numpy(table).requires_grad_()
    cpb.table_interp(t, taps, fracs, 12).sum().backward()
    w = [torch.from_numpy(a).requires_grad_() for a in _mlp(rng)]
    cpb.cpb_bias_transposed(torch.zeros(4, 2), torch.zeros(1, 3, 2),
                            *w).sum().backward()
    assert t.grad is not None and all(x.grad is not None for x in w)
    assert (cpb.table_interp_backward.launches,
            cpb.cpb_bias_transposed_backward.launches) == before

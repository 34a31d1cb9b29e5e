"""The port's table CPB at lattice divisors >= 2 (the plain version of
kernel K5) and the bf16 window store (``cpb_table_bf16``, JAX's
``TBL_BF16_OUT``) against the JAX package on the CPU: the lattice geometry
and taps (``_tbl_consts``, ``_tbl_idx``), the bias and its gradients
against ``cpb_bias_table`` (its jnp interpolation and its interpret-mode
Pallas kernel on the phase-decomposed table), the plain backward against
``_table_interp``'s custom VJP, ``DeformCrossAttention2D`` and the whole
``TeachersNet`` at divisor 4, and a 10-step teacher trajectory at divisor
2.  The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.

JAX's ``define_net`` sets module globals; these tests set them only through
``monkeypatch`` or restore them in ``finally``.

Tolerances: the bias within 2e-6 abs / 1e-5 rel (f32, the MLP summed in
another order); gradients of the whole table CPB within 3e-5 of the largest
(the scaling of ``test_cpb_table_kernel_grads_match_jnp_interp``); the
bf16 store within one bf16 ulp (1e-4 abs on biases below 1); the plain
backward within 1e-5 norm-relative of float64, while JAX's
``_tbl_bwd_kernel`` shift cotangent subtracts two O(1) blends whose
difference is O(lattice spacing) and sits up to 2e-4 off float64 at
divisor 4; module outputs and maps 1e-5, parameter gradients 5e-4 abs /
2e-3 rel; logits 1e-4; trajectory losses 2e-4 relative per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.models import deform_attention as jdam
from disentangled_multimodal_learning_tpu.models.teacher_student import (
    TeachersNet as JTeachersNet)
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu.train import optim as joptim
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_train_step as jmake_train_step)
from disentangled_multimodal_learning_tpu.utils import torch_export as te
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention2D)
from disentangled_multimodal_learning_tpu_torch.models.factory import define_net
from disentangled_multimodal_learning_tpu_torch.ops import cpb
from disentangled_multimodal_learning_tpu_torch.train import optim as toptim
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_train_step)
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

FWD_ATOL, FWD_RTOL, GRAD_TOL, BF16_TOL = 2e-6, 1e-5, 3e-5, 1e-4
NAMES = ("grid_kv", "w1", "b1", "w2", "b2", "w3", "b3")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(rng):
    h = cpb.HID
    w = [rng.normal(size=(2, h)) / np.sqrt(2), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, 1)) / np.sqrt(h), rng.normal(size=(1,)) * 0.1]
    return [a.astype(np.float32) for a in w]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _grid_kv(rng, side, divisor, kv_bound, bh=2, k=8):
    """kv points within the bound, and two four lattice cells past it (so
    that their rows clip and extrapolate)."""
    gkv = rng.uniform(-kv_bound, kv_bound, size=(bh, k, 2)).astype(np.float32)
    far = kv_bound + 4.0 * (2.0 / (side - 1)) / divisor
    gkv[0, :2] = [[far, -far], [-far, far]]
    return gkv


def _fracs(gkv, side, divisor, kv_bound):
    return cpb.table_taps(
        cpb.table_shifts(torch.from_numpy(gkv), side=side, kv_bound=kv_bound,
                         divisor=divisor),
        side=side, tn=cpb.table_consts(side, kv_bound, divisor)[2],
        divisor=divisor)


@pytest.mark.parametrize("divisor", [2, 3, 4])
def test_table_consts_match_jax_at_divisor(divisor):
    for side, kv_bound in [(12, 1.4), (50, 1.0 + 8.0 / 11), (10, 1.3),
                           (8, 9.0)]:
        h, t0, rn, tn = jda._tbl_consts(side, divisor, kv_bound)
        assert cpb.table_consts(side, kv_bound, divisor) == (h, t0, tn)
        assert tn == rn * divisor


@pytest.mark.parametrize("divisor", [2, 4])
def test_table_taps_match_jax_tbl_idx_at_divisor(rng, divisor):
    """The port's full-lattice taps are JAX's phase-decomposed ones
    recomposed (``iy = py + d * oy``), clipped rows included."""
    side, kv_bound = 12, 1.4
    _, _, rn, tn = jda._tbl_consts(side, divisor, kv_bound)
    shifts = rng.uniform(-5, tn + 5, size=(64, 2)).astype(np.float32)
    idx, frac = (np.asarray(a) for a in
                 jda._tbl_idx(jnp.asarray(shifts), side, divisor, rn))
    phase, oy = idx[:, 0] // rn, idx[:, 0] % rn
    iy = phase // divisor + divisor * oy
    ix = phase % divisor + divisor * idx[:, 4]
    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=side, tn=tn,
                                 divisor=divisor)
    np.testing.assert_array_equal(taps.numpy(), np.stack([iy, ix], axis=1))
    np.testing.assert_array_equal(fracs.numpy(), frac)
    assert (frac < 0).any() and (frac > 1).any()


@pytest.mark.parametrize("side,divisor", [(12, 2), (12, 4), (50, 2), (50, 4)])
def test_strided_table_cpb_matches_jax(rng, side, divisor):
    """Plain K5 + the divisor-d table build + taps == JAX ``cpb_bias_table``
    at that divisor, through its jnp interpolation and its interpret-mode
    Pallas kernel (``_tbl_fwd_kernel`` on the phase-decomposed table)."""
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12) if side == 50 else 1.4
    gkv = _grid_kv(rng, side, divisor, kv_bound)
    w = _mlp(rng)
    got = cpb.cpb_bias_table(torch.from_numpy(gkv), *_t(w), side=side,
                             kv_bound=kv_bound, divisor=divisor).numpy()
    _, fracs = _fracs(gkv, side, divisor, kv_bound)
    assert ((fracs < 0) | (fracs > 1)).any()
    for use_kernel in (True, False):
        want = jda.cpb_bias_table(jnp.asarray(gkv), *map(jnp.asarray, w),
                                  side=side, divisor=divisor,
                                  kv_bound=kv_bound, use_kernel=use_kernel,
                                  interpret=True)
        assert got.shape == want.shape == (2, 8, side * side)
        np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL,
                                   rtol=FWD_RTOL)


@pytest.mark.parametrize("side,divisor", [(10, 2), (10, 4), (50, 4)])
def test_strided_table_cpb_gradients_match_jax(rng, side, divisor):
    """Gradients of ``sum(sin(3 * bias))`` with respect to grid_kv and the
    MLP weights: the port's autograd (plain K5-bwd) == JAX's custom VJP
    (interpret-mode ``_tbl_bwd_kernel``) and JAX's autodiff of its jnp
    interpolation, clipped rows included.  At side 50 and divisor 4 the
    grid_kv gradient is held to 1e-4: JAX's shift cotangent subtracts two
    O(1) blends 1/196 of a query cell apart (3.5e-5 of the largest seen),
    where the port takes exact table differences (1e-5 of float64 in
    ``test_strided_plain_backward_matches_jax_custom_vjp``)."""
    kv_bound = 1.3 if side == 10 else cpb.kv_bound_2d(4.0, 12, 12)
    gkv = _grid_kv(rng, side, divisor, kv_bound, bh=2, k=6)
    w = _mlp(rng)

    def loss(use_kernel):
        def f(gkv_, *w_):
            b = jda.cpb_bias_table(gkv_, *w_, side=side, divisor=divisor,
                                   kv_bound=kv_bound, use_kernel=use_kernel,
                                   interpret=use_kernel)
            return jnp.sum(jnp.sin(3.0 * b))
        return f

    leaves = [torch.from_numpy(a).requires_grad_() for a in [gkv] + w]
    torch.sin(3.0 * cpb.cpb_bias_table(*leaves, side=side, kv_bound=kv_bound,
                                       divisor=divisor)).sum().backward()
    for use_kernel in (True, False):
        want = jax.jit(jax.grad(loss(use_kernel), argnums=tuple(range(7))))(
            jnp.asarray(gkv), *map(jnp.asarray, w))
        for name, leaf, ww in zip(NAMES, leaves, want):
            ww = np.asarray(ww)
            scale = max(float(np.abs(ww).max()), 1.0)
            tol = 1e-4 if name == "grid_kv" and side == 50 else GRAD_TOL
            np.testing.assert_allclose(leaf.grad.numpy() / scale, ww / scale,
                                       atol=tol, rtol=0, err_msg=name)


def _phase_table(table, divisor, side):
    """The port's full ``[tn, tn]`` table in JAX's phase-decomposed,
    padded layout (``cpb_bias_table``'s divisor-d build)."""
    rn = table.shape[0] // divisor
    tablep = table.reshape(rn, divisor, rn, divisor).transpose(1, 3, 0, 2)
    tablep = tablep.reshape(divisor * divisor * rn, rn)
    cn = -(-rn // 128) * 128
    return np.pad(tablep, ((0, jda._tbl_win_rows(side)), (0, cn - rn))), rn


@pytest.mark.parametrize("divisor", [2, 4])
def test_strided_plain_backward_matches_jax_custom_vjp(rng, divisor):
    """dtable and dfracs of K5's plain backward against float64 (1e-5) and
    against the cotangents of JAX's ``_table_interp`` (interpret-mode
    ``_tbl_bwd_kernel``) on the same table in its phase layout: dtable
    within 1e-5, the shift cotangent within JAX's own error; the port's
    autograd (``table_interp_strided``) gives the same as the plain
    backward."""
    side, kv_bound = 12, 1.4
    tn = cpb.table_consts(side, kv_bound, divisor)[2]
    table = rng.normal(size=(tn, tn)).astype(np.float32)
    hi = tn - divisor * (side - 1) - 2
    shifts = rng.uniform(-3, hi + 4, size=(40, 2)).astype(np.float32)
    dout = rng.normal(size=(40, side, side)).astype(np.float32)
    tablep, rn = _phase_table(table, divisor, side)
    _, vjp = jax.vjp(
        lambda t, s: jda._table_interp(t, s, side, divisor, rn, 0, True),
        jnp.asarray(tablep), jnp.asarray(shifts))
    dtab_p, dsh = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    dtab = dtab_p[:divisor * divisor * rn, :rn].reshape(
        divisor, divisor, rn, rn).transpose(2, 0, 3, 1).reshape(tn, tn)

    taps, fracs = cpb.table_taps(torch.from_numpy(shifts), side=side, tn=tn,
                                 divisor=divisor)
    assert ((fracs < 0) | (fracs > 1)).any(dim=1).sum() >= 4
    dtable, dfracs = cpb.table_interp_backward_reference(
        torch.from_numpy(table), taps, fracs, torch.from_numpy(dout), side,
        divisor)
    f64 = cpb.table_interp_backward_reference(
        torch.from_numpy(table).double(), taps, fracs.double(),
        torch.from_numpy(dout).double(), side, divisor)
    assert _rel(dtable, f64[0]) <= 1e-5 and _rel(dfracs, f64[1]) <= 1e-5
    assert _rel(dtab, f64[0]) <= 1e-5 and _rel(dtable, dtab) <= 1e-5
    assert _rel(dsh, f64[1]) <= 2e-4 and _rel(dfracs, dsh) <= 2e-4

    t = torch.from_numpy(table).requires_grad_()
    f = fracs.clone().requires_grad_()
    cpb.table_interp_strided(t, taps, f, side, divisor).backward(
        torch.from_numpy(dout))
    assert _rel(t.grad, dtable) <= 1e-6 and torch.equal(f.grad, dfracs)


@pytest.mark.parametrize("divisor", [2, 4])
def test_strided_clipped_rows_keep_their_shift_cotangent(rng, divisor):
    """A clipped row extrapolates at any divisor, and its shift cotangent is
    the derivative of that extrapolation (a central difference in float64,
    exact for the forward, which is linear in each fraction)."""
    side, kv_bound = 12, 1.4
    tn = cpb.table_consts(side, kv_bound, divisor)[2]
    table = torch.from_numpy(rng.normal(size=(tn, tn)))
    hi = tn - divisor * (side - 1) - 2
    shifts = torch.from_numpy(rng.uniform(-3, hi + 4, size=(40, 2)))
    dout = torch.from_numpy(rng.normal(size=(40, side, side)))
    taps, fracs = cpb.table_taps(shifts, side=side, tn=tn, divisor=divisor)
    fracs = fracs.double()
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    assert clipped.sum() >= 4
    _, dfracs = cpb.table_interp_backward_reference(table, taps, fracs, dout,
                                                    side, divisor)
    assert (dfracs[clipped].abs() > 1e-3).all()
    for axis in (0, 1):
        step = torch.zeros_like(fracs)
        step[:, axis] = 0.5

        def loss_per_row(f):
            return (cpb.table_interp_reference(table, taps, f, side, divisor,
                                               torch.float64)
                    * dout).sum(dim=(1, 2))

        numeric = loss_per_row(fracs + step) - loss_per_row(fracs - step)
        np.testing.assert_allclose(dfracs[:, axis].numpy(), numeric.numpy(),
                                   rtol=1e-9, atol=1e-9)


def _bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at ``|x|``."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_bf16_store_matches_jax_tbl_bf16_out(rng, divisor):
    """``out_dtype=torch.bfloat16`` is JAX's ``TBL_BF16_OUT``: the blend in
    f32, the store rounded to bf16 (the port's f32 bias rounded to nearest
    even, bitwise, as JAX's bf16 bias is its own f32 bias rounded), within
    one bf16 ulp of JAX's jnp interpolation and interpret-mode kernel: the
    two f32 biases differ by ~1e-7 (the MLP summed in another order), so
    where one lies by a rounding boundary the two stores are one ulp apart
    (2.4e-4 at |bias| 0.035), and 1e-4 abs holds everywhere else."""
    side, kv_bound = 10, 1.3
    gkv = _grid_kv(rng, side, divisor, kv_bound)
    w = _mlp(rng)
    args = (torch.from_numpy(gkv), *_t(w))
    kw = dict(side=side, kv_bound=kv_bound, divisor=divisor)
    got = cpb.cpb_bias_table(*args, **kw, out_dtype=torch.bfloat16)
    f32 = cpb.cpb_bias_table(*args, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    jkw = dict(side=side, divisor=divisor, kv_bound=kv_bound, interpret=True)
    jargs = (jnp.asarray(gkv), *map(jnp.asarray, w))
    want32 = jda.cpb_bias_table(*jargs, **jkw, use_kernel=False)
    assert jda.TBL_BF16_OUT is False
    try:
        jda.TBL_BF16_OUT = True
        for use_kernel in (True, False):
            want = jda.cpb_bias_table(*jargs, **jkw, use_kernel=use_kernel)
            assert want.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(want, np.float32),
                np.asarray(want32.astype(jnp.bfloat16), np.float32))
            want = np.asarray(want, np.float32)
            diff = np.abs(got.float().numpy() - want)
            assert (diff <= _bf16_ulp(want)).all()
            assert (diff[diff > BF16_TOL] == _bf16_ulp(want)[
                diff > BF16_TOL]).all()
    finally:
        jda.TBL_BF16_OUT = False


@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_bf16_cotangent_is_upcast_and_summed_in_f32(rng, divisor):
    """The backward of the bf16 store reads a bf16 window cotangent: it is
    the f32 backward of that cotangent upcast, and autograd through the
    bf16 store gives it."""
    side, kv_bound = 10, 1.3
    tn = cpb.table_consts(side, kv_bound, divisor)[2]
    table = torch.from_numpy(rng.normal(size=(tn, tn)).astype(np.float32))
    gkv = _grid_kv(rng, side, divisor, kv_bound)
    taps, fracs = _fracs(gkv, side, divisor, kv_bound)
    dout = torch.from_numpy(rng.normal(size=(16, side, side))
                            .astype(np.float32)).to(torch.bfloat16)
    got = cpb.table_interp_backward_reference(table, taps, fracs, dout, side,
                                              divisor)
    want = cpb.table_interp_backward_reference(table, taps, fracs,
                                               dout.float(), side, divisor)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    t = table.clone().requires_grad_()
    f = fracs.clone().requires_grad_()
    fn = (cpb.table_interp if divisor == 1 else
          lambda *a: cpb.table_interp_strided(*a[:4], divisor, a[4]))
    out = fn(t, taps, f, side, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.backward(dout)
    assert torch.allclose(t.grad, want[0], rtol=1e-6, atol=1e-6)
    assert torch.allclose(f.grad, want[1], rtol=1e-6, atol=1e-6)


def test_strided_wrappers_take_the_plain_version_on_cpu_without_counting(rng):
    side, divisor = 6, 2
    table = torch.from_numpy(rng.normal(size=(20, 20)).astype(np.float32))
    taps = torch.tensor([[0, 3], [7, 0]], dtype=torch.int32)
    fracs = torch.tensor([[0.25, -0.5], [1.0, 0.75]])
    before = (cpb.table_interp_strided.launches,
              cpb.table_interp_strided_backward.launches)
    t = table.clone().requires_grad_()
    out = cpb.table_interp_strided(t, taps, fracs, side, divisor)
    assert torch.equal(out, cpb.table_interp_reference(table, taps, fracs,
                                                       side, divisor))
    out.sum().backward()
    assert t.grad is not None
    assert (cpb.table_interp_strided.launches,
            cpb.table_interp_strided_backward.launches) == before
    with pytest.raises(ValueError, match="divisor-1"):
        cpb.table_interp_strided(table, taps, fracs, side, 1)


def test_strided_wrappers_raise_off_cpu_instead_of_falling_back():
    meta = dict(device="meta")
    args = (torch.empty(30, 30, **meta),
            torch.empty(2, 2, dtype=torch.int32, **meta),
            torch.empty(2, 2, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        cpb.table_interp_strided(*args, 10, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cpb.table_interp_strided_backward(*args, torch.empty(2, 10, 10, **meta),
                                          10, 2)


def _load(module, export, params):
    out = {}
    export(params, "m", out)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                            for k, v in out.items()}, strict=True)
    return module


@pytest.mark.parametrize("divisor", [2, 4])
def test_deform_attention_gradients_match_jax_at_divisor(rng, divisor):
    """``DeformCrossAttention2D`` at divisor 2 and 4 (kn layout, fixdim 144,
    a 3x3 deformed grid): outputs and maps within 1e-5 (the forward is also
    in ``test_torch_layers.py``), and every parameter's gradient of
    ``sum(out^2) + sum(sin(attn))`` within 5e-4 abs / 2e-3 rel."""
    B, N, C = 2, 144, 128
    x1 = rng.normal(size=(B, N, C)).astype(np.float32)
    x2 = rng.normal(size=(B, N, C)).astype(np.float32)
    jm = jdam.DeformCrossAttention2D(
        dim=C, dim_head=64, heads=8, dropout=0.0, downsample_factor=4,
        offset_scale=4, offset_groups=8, offset_kernel_size=6,
        attn_layout="kn", cpb_table_divisor=divisor)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x1),
                     jnp.asarray(x2))["params"]

    def jloss(p):
        o, a = jm.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2))
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(a)), (o, a)

    (_, (want_out, want_attn)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tm = _load(DeformCrossAttention2D(C, cpb_table_divisor=divisor),
               te._attn2d, params)
    out, attn = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               atol=1e-5, rtol=0)
    ((out ** 2).sum() + torch.sin(attn).sum()).backward()
    want = {}
    te._attn2d(jgrads, "m", want)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(want[f"m.{name}"]),
                                   atol=5e-4, rtol=2e-3, err_msg=name)


FIXDIM, B = 64, 2


def _teacher_inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x_path10=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_path20=r.normal(size=(B, FIXDIM, 1024)).astype(np.float32),
        x_omic_tumor=r.normal(size=(B, 59)).astype(np.float32),
        x_omic_immune=r.normal(size=(B, 361)).astype(np.float32))


def test_teachers_net_matches_jax_at_divisor_4(monkeypatch):
    """The whole two-scale teacher at ``cpb_table_divisor 4`` (setting (b)
    of the card's main path), fixdim 64, real widths: logits within 1e-4
    of JAX's, the kn layout forced in JAX (its CPU "auto" is nk, which
    never takes the table)."""
    monkeypatch.setattr(jdam, "CPB_TABLE_DIVISOR", 4)
    monkeypatch.setattr(jdam, "resolve_attn_layout", lambda layout: "kn")
    x = _teacher_inputs()
    jm = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                      input_size_omic_immune=361)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), **jx)["params"]
    want = jax.jit(jm.apply)({"params": params}, **jx)[2]
    cfg = Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=4).validate()
    model = load_jax_params(define_net(cfg, "cpu"), params, "teacher")
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in x.items()})[2]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_teacher_trajectory_matches_jax_at_divisor_2(monkeypatch):
    """10 AdamW steps (cosine schedule, gradient modulation, the attention
    consistency loss) under ``deterministic_training`` at divisor 2, from
    the same weights (biases nudged off 0, see ``test_torch_train.py``) on
    alternating batches: every step's loss within 2e-4 relative of JAX's."""
    steps = 10
    monkeypatch.setattr(jdam, "CPB_TABLE_DIVISOR", 2)
    monkeypatch.setattr(jdam, "resolve_attn_layout", lambda layout: "kn")
    ds = JSynthetic(size=2 * B, fixdim=FIXDIM, label_dim=4, seed=0)
    batches = [ds.batch(list(range(B))), ds.batch(list(range(B, 2 * B)))]
    jm = JTeachersNet(label_dim=4, input_size_omic_tumor=59,
                      input_size_omic_immune=361)
    x = {k: jnp.asarray(getattr(batches[0], k)) for k in
         ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")}
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), **x)["params"]
    r = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + r.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, params)
    jcfg = jconfig.Config(
        mode="teacher", task_type="diag2021", label_dim=4, fixdim=FIXDIM,
        batch_size=B, epochs=steps, lr=2e-4, lr_policy="cosine",
        optimizer="adamw", weight_decay=0.01, gradient_modulate=True,
        multiscale_attention=True, deterministic_training=True,
        checkpoints="#", cpb_table_divisor=2).validate()
    tx = joptim.make_optimizer(jcfg, 1)
    state = TrainState.create({"params": params}, tx)
    jstep = jax.jit(jmake_train_step(jm, jcfg, tx))
    jax_losses = []
    for k in range(steps):
        state, m = jstep(state, batch_to_arrays(batches[k % 2]),
                         jax.random.PRNGKey(k))
        jax_losses.append(float(m["loss"]))

    cfg = Config(mode="teacher", fixdim=FIXDIM, batch_size=B,
                 cpb_table_divisor=2, epochs=steps,
                 deterministic_training=True).validate()
    model = load_jax_params(define_net(cfg, "cpu"), params, "teacher")
    opt = toptim.make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, toptim.make_scheduler(cfg, opt, 1))
    for k in range(steps):
        loss = float(step(batch_to_tensors(batches[k % 2], "cpu"))["loss"])
        assert abs(loss - jax_losses[k]) <= 2e-4 * max(1.0,
                                                       abs(jax_losses[k])), k

"""The port's fused exact-CPB attention (``ops/fused_exact.py``, the plain
version of kernel K7, the op behind JAX's ``fused_deform_attention`` and
``fused_deform_attention_kn``) against the JAX package on the CPU: forward
and the ten gradients (q, k, v, grid_kv and the six CPB weights) through
``out`` and ``attn``, in the "nk" and the "kn" layout, against JAX's Pallas
kernels in interpret mode and ``deform_attention_reference``; its dropout.
The kernels themselves are held against this plain version on the card by
``tests/test_torch_cuda.py``.

Tolerances are those of JAX's golden tests (``tests/test_pallas_deform.py``
:31, :41, :51, :73, :409, :448): forward 1e-5 abs / 1e-4 rel, gradients
2e-4 abs / 1e-3 rel, b3 left out where JAX leaves it out (the softmax
ignores a constant shift, so its true gradient is 0).  Dropout: the port's
mask is K6's counter hash, which JAX's TPU PRNG cannot match, so the JAX
comparisons run at rate 0 and the dropout is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jda
from disentangled_multimodal_learning_tpu_torch.ops import (cpb, fused_exact,
                                                            fused_table)

FWD_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
NAMES = ("q", "k", "v", "grid_kv", "w1", "b1", "w2", "b2", "w3", "b3")


def _inputs(rng, BH=4, N=40, K=12, D=16):
    """JAX's ``make_inputs``: q (pre-scaled), k, v, grid_q, grid_kv and the
    CPB weights, f32 numpy."""
    HID = cpb.HID
    a = [rng.normal(size=(BH, N, D)) * D ** -0.5, rng.normal(size=(BH, K, D)),
         rng.normal(size=(BH, K, D)), rng.uniform(-1, 1, size=(N, 2)),
         rng.uniform(-1.2, 1.2, size=(BH, K, 2)),
         rng.normal(size=(2, HID)) * 0.5, rng.normal(size=(HID,)) * 0.1,
         rng.normal(size=(HID, HID)) * 0.2, rng.normal(size=(HID,)) * 0.1,
         rng.normal(size=(HID, 1)) * 0.3, rng.normal(size=(1,)) * 0.1]
    return [x.astype(np.float32) for x in a]


def _jax_fused(layout, tile):
    if layout == "nk":
        return lambda *a: jda.fused_deform_attention(*a, 0.0, 0.0, tile, True)
    return lambda *a: jda.fused_deform_attention_kn(*a, 0, 0.0, True)


# (layout, BH, N, K, D, JAX's nk tile, the map's loss term, grads, b3 too)
CASES = {
    "nk_forward": ("nk", 4, 40, 12, 16, 16, None, False, False),       # :31
    "nk_padded_tile": ("nk", 3, 44, 10, 12, 16, None, False, False),   # :41
    "nk_grads": ("nk", 2, 24, 8, 8, 8, "sin", True, True),             # :51
    "nk_grads_padded": ("nk", 2, 20, 8, 8, 8, "square", True, True),   # :73
    "kn_forward_and_grads": ("kn", 3, 40, 16, 8, None, "sin", True,
                             False),                                   # :409
    "kn_k5": ("kn", 2, 24, 5, 8, None, None, False, False),            # :448
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_exact_matches_jax(rng, case):
    """The plain K7 against JAX's fused attention of the same layout
    (interpret mode) and ``deform_attention_reference``: out and attn, and,
    where the JAX test takes them, the gradients of ``sum(out^2) +
    sum(sin(attn))`` (or ``+ sum(attn^2)``) with respect to all ten
    inputs.  JAX's nk kernel pads N to its query tile (40 and 44 to 48 at
    tile 16, 20 to 24 at tile 8); the kn kernel takes any K that is a
    multiple of 8 or at most 8 (16, 5); the port takes them all unpadded."""
    layout, BH, N, K, D, tile, attn_term, grads, with_b3 = CASES[case]
    args = _inputs(rng, BH, N, K, D)
    gq = args[3]
    fn = _jax_fused(layout, tile)

    def term(a, lib):
        if attn_term == "sin":
            return lib.sum(lib.sin(a))
        return lib.sum(a ** 2) if attn_term == "square" else 0.0

    def jloss(fused):
        def f(q, k, v, gkv, *w):
            if fused:
                out, attn = fn(q, k, v, jnp.asarray(gq), gkv, *w)
            else:
                out, attn = jda.deform_attention_reference(
                    q, k, v, jnp.asarray(gq), gkv, *w)
                if layout == "kn":
                    attn = jnp.swapaxes(attn, 1, 2)
            return jnp.sum(out ** 2) + term(attn, jnp), (out, attn)
        return f

    leaves = [torch.from_numpy(a).requires_grad_()
              for a in args[:3] + args[4:]]
    out, attn = fused_exact.fused_exact_attention(
        *leaves[:3], torch.from_numpy(gq), *leaves[3:], layout=layout)
    assert out.shape == (BH, N, D)
    assert attn.shape == ((BH, N, K) if layout == "nk" else (BH, K, N))
    kv_axis = -1 if layout == "nk" else -2
    torch.testing.assert_close(attn.sum(kv_axis), torch.ones(BH, N),
                               rtol=0, atol=1e-5)
    if grads:
        ((out ** 2).sum() + term(attn, torch)).backward()
    for fused in (True, False):
        diff = tuple(range(10)) if grads else ()
        jargs = [jnp.asarray(a) for a in args[:3] + args[4:]]
        if grads:
            (_, (jout, jattn)), jgrads = jax.value_and_grad(
                jloss(fused), argnums=diff, has_aux=True)(*jargs)
        else:
            _, (jout, jattn) = jloss(fused)(*jargs)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **FWD_TOL)
        np.testing.assert_allclose(attn.detach().numpy(), np.asarray(jattn),
                                   **FWD_TOL)
        if not grads:
            continue
        for name, leaf, g in zip(NAMES, leaves, jgrads):
            if name == "b3" and not with_b3:
                continue
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                       err_msg=f"{case} {fused} {name}",
                                       **GRAD_TOL)


def _torch_args(rng, BH=2, N=30, K=9, D=9):
    return [torch.from_numpy(a) for a in _inputs(rng, BH, N, K, D)]


def test_layouts_and_passes_share_one_dropout_mask(rng):
    """At rate 0.1 the same seed gives bit-identical outputs; "nk" and "kn"
    drop the same entries (the same out, the maps transposed exactly); the
    map is the one before dropout; about 0.9 of it is kept, the kept entries
    scaled by 1 / 0.9 (read off an identity v, D == K); another seed drops
    others; and the backward regenerates the forward's mask in both
    layouts: ``dv == drop(attn)^T g_out``."""
    rate, seed = 0.1, 7
    q, k, v, gq, gkv, *w = _torch_args(rng)
    run = fused_exact.fused_exact_attention
    out_nk, attn_nk = run(q, k, v, gq, gkv, *w, seed, rate, "nk")
    out_kn, attn_kn = run(q, k, v, gq, gkv, *w, seed, rate, "kn")
    assert torch.equal(out_nk, out_kn)
    assert torch.equal(attn_nk, attn_kn.transpose(1, 2))
    assert torch.equal(run(q, k, v, gq, gkv, *w, seed, rate, "nk")[0], out_nk)
    assert torch.equal(run(q, k, v, gq, gkv, *w, seed, 0.0, "nk")[1], attn_nk)
    assert not torch.equal(run(q, k, v, gq, gkv, *w, seed + 1, rate)[0],
                           out_nk)
    eye = torch.eye(9).expand(2, 9, 9).contiguous()
    p_drop = run(q, k, eye, gq, gkv, *w, seed, rate, "nk")[0]  # [BH, N, K]
    kept = p_drop != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.05
    torch.testing.assert_close(p_drop[kept], attn_nk[kept] / (1 - rate),
                               rtol=1e-6, atol=1e-7)
    keep = fused_table.dropout_keep_mask(seed, (2, 9, 30), rate)
    assert torch.equal(kept, keep.transpose(1, 2))
    # a slice of the batch-heads from bh0 on keeps the whole call's mask
    assert torch.equal(fused_table.dropout_keep_mask(seed, (1, 9, 30), rate,
                                                     first=9 * 30), keep[1:])
    tail = fused_exact.fused_exact_attention_reference(
        q[1:], k[1:], v[1:], gq, gkv[1:], *w, seed, rate, "kn", bh0=1)
    assert torch.equal(tail[0], out_kn[1:]) and torch.equal(tail[1],
                                                            attn_kn[1:])
    g_out = torch.from_numpy(rng.normal(size=out_nk.shape).astype(np.float32))
    for layout in ("nk", "kn"):
        vv = v.clone().requires_grad_()
        run(q, k, vv, gq, gkv, *w, seed, rate, layout)[0].backward(g_out)
        torch.testing.assert_close(vv.grad, p_drop.transpose(1, 2) @ g_out,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["nk", "kn"])
def test_backward_wrapper_on_the_cpu_is_the_plain_autograd(rng, layout):
    """``fused_exact_attention_backward`` on the CPU (its plain version,
    what K7-bwd is checked against on the card) == autograd through
    ``fused_exact_attention``, with a cotangent on the map; neither wrapper
    counts on the CPU."""
    args = _torch_args(rng)
    before = (fused_exact.fused_exact_attention.launches,
              fused_exact.fused_exact_attention_backward.launches)
    leaves = [a.clone().requires_grad_() for a in args[:3] + args[4:]]
    out, attn = fused_exact.fused_exact_attention(
        *leaves[:3], args[3], *leaves[3:], 3, 0.1, layout)
    g_out = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    g_attn = torch.from_numpy(rng.normal(size=attn.shape).astype(np.float32))
    want = torch.autograd.grad((out, attn), leaves, (g_out, g_attn))
    got = fused_exact.fused_exact_attention_backward(
        *args, attn.detach(), g_out, g_attn, 3, 0.1, layout)
    assert len(got) == 10
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert (fused_exact.fused_exact_attention.launches,
            fused_exact.fused_exact_attention_backward.launches) == before


def test_fused_exact_wrappers_raise_off_cpu_instead_of_falling_back():
    meta = dict(device="meta")
    q, k = torch.empty(2, 64, 8, **meta), torch.empty(2, 4, 8, **meta)
    w = [torch.empty(s, **meta) for s in ((2, 32), (32,), (32, 32), (32,),
                                          (32, 1), (1,))]
    with pytest.raises(ValueError, match="CUDA"):
        fused_exact.fused_exact_attention(
            q, k, k, torch.empty(64, 2, **meta), torch.empty(2, 4, 2, **meta),
            *w)
    with pytest.raises(ValueError, match="layout"):
        fused_exact.fused_exact_attention(q, k, k, q, q, *w, layout="kv")

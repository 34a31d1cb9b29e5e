"""The port's CUDA kernels and its serving and training paths on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips, inside its fixture, where ``torch.cuda.is_available()`` is false.
The file imports neither JAX nor the JAX package and uses no fixture of
``tests/conftest.py`` (which imports JAX), so on a GPU machine without JAX
it runs as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K1 1e-5 abs and K2 1e-4 abs against their plain versions on
biases of O(1) (K1 rounds every op as its plain version does; K2 contracts
to FMAs and sums in another order); 1e-4 abs between f32 forwards on the
card and on the CPU with the same weights (cuBLAS, cuDNN and the CPU sum in
other orders).  Backward kernels, norm-relative against their plain
versions in float64: K1 1e-5; K2 1e-3 (with random cotangents the sums
over every point cancel, and a relu input within f32 rounding of 0 takes
the other branch than in float64: the f32 plain version itself is 1e-4 to
5e-4 off).  One f32 train step on the card against the CPU: the task loss
within 1e-5 relative; the total loss within 5e-4, because the attention
consistency loss (1e4 x the variance of near-equal Gram diagonals)
amplifies f32 differences (measured at full size: 7.6e-5); every gradient
within 5e-3 rel-L2, because the CPB hidden biases sum nearly cancelling
cotangents (measured at full size: 1.3e-3); the CPB output biases, whose
gradient is 0 in exact arithmetic, only checked to be that small.  K3
(the streamed DPC-KNN passes) against their plain versions: the kernel
sums each C-term dot in another order than cuBLAS; each f32 sum is within
C 2^-24 max|x|^2 of the exact dot (to first order), so the two squared
distances (-2 dot) differ by at most 4 C 2^-24 max|x|^2; the cluster
indices exactly.  K4 (the 1-D table CPB) against its plain version: 1e-6
abs (the same two-term lerp, rounded op by op as the plain version rounds
it); K4-bwd against its plain version in float64: 1e-5 norm-relative.  K5
(the table CPB at divisor >= 2) and K1 with the bf16 store: bitwise equal
to their plain version; K5-bwd 1e-5 norm-relative of float64.  K6 (the
fused table attention) against its plain version: attn 1e-6, out 1e-5 abs
(the products and the softmax summed in another order); K6-bwd against
float64: dq, dk, dv 2e-5 norm-relative, dtable and dfracs 1e-4 or twice
the f32 plain version's own error.  K2-nk (the exact CPB in the "nk"
layout) bitwise equal to K2 transposed and within K2's 1e-4 of its plain
version; K2-nk-bwd as K2-bwd (1e-3 of float64) and bitwise equal to K2-bwd
on the transposed cotangent.  K7 (the fused exact-CPB attention) within
1e-4 of its plain version in both layouts, the layouts bitwise equal;
K7-bwd against float64: dq, dk, dv 2e-5, grid_kv and the weights 1e-3
(past one chunk of 160 kv points, 1e-3 or twice the f32 plain version's
own error).
deformpathomic on the card against the CPU: as the teacher (logits 1e-4,
task loss 1e-5, loss 5e-4 with the vgrid loss, gradients 5e-3).  The
baselines (plain torch, no kernel launched) on the card against the CPU:
every output within 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data.contract import Batch
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
    DeformCrossAttention2D, normalized_grid)
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net, init_weights)
from disentangled_multimodal_learning_tpu_torch.ops import (
    cluster, cpb, cpb1d, dpc_knn, fused_exact, fused_table)
from disentangled_multimodal_learning_tpu_torch.train.optim import (
    make_optimizer, make_scheduler)
from disentangled_multimodal_learning_tpu_torch.train.distill_cache import (
    TeacherBoundaryCache)
from disentangled_multimodal_learning_tpu_torch.train.steps import (
    batch_to_tensors, make_distill_cached_step, make_teacher_boundary_fn,
    make_train_step)

K1_TOL, K2_TOL, FORWARD_TOL = 1e-5, 1e-4, 1e-4
K1_BWD_TOL, K2_BWD_TOL, GRAD_TOL = 1e-5, 1e-3, 5e-3
K3_TOL_ULPS = 4
K4_TOL, K4_BWD_TOL = 1e-6, 1e-5
K5_BWD_TOL = 1e-5
K6_ATTN_TOL, K6_OUT_TOL, K6_BWD_TOL, K6_TABLE_BWD_TOL = 1e-6, 1e-5, 2e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _mlp(rng, o, device):
    h = cpb.HID
    w = [rng.normal(size=(2, h)) / np.sqrt(2), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, h)) / np.sqrt(h), rng.normal(size=(h,)) * 0.1,
         rng.normal(size=(h, o)) / np.sqrt(h), rng.normal(size=(o,)) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in w]


def _uniform(rng, bound, shape, device):
    return torch.from_numpy(
        rng.uniform(-bound, bound, size=shape).astype(np.float32)).to(device)


def _launches():
    return cpb.table_interp.launches, cpb.cpb_bias_transposed.launches


def _bwd_launches():
    return (cpb.table_interp_backward.launches,
            cpb.cpb_bias_transposed_backward.launches)


def _rel(got, want):
    """Norm-relative error; a zero ``want`` (a parameter the loss does not
    reach) asks for a zero ``got``."""
    return ((got.double() - want).norm() / max(want.norm().item(), 1e-30)
            ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("side", [12, 50])
def test_table_kernel_matches_plain_version(dev, side):
    """K1 at the deformed grid of fixdim 144 and 2500, with kv points up to
    25% past the bound, so that clipped rows extrapolate."""
    rng = np.random.default_rng(side)
    g = (side + 2 - 6) // 4 + 1  # the offset conv's output side
    kv_bound = cpb.kv_bound_2d(4.0, g, g)
    w = _mlp(rng, 1, dev)
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound)
    gkv = _uniform(rng, 1.25 * kv_bound, (16, g * g, 2), dev)
    taps, fracs = cpb.table_taps(
        cpb.table_shifts(gkv, side=side, kv_bound=kv_bound),
        side=side, tn=table.shape[0])
    assert ((fracs < 0) | (fracs > 1)).any()
    before = _launches()
    with torch.inference_mode():
        got = cpb.table_interp(table, taps, fracs, side)
    assert _launches() == (before[0] + 1, before[1])
    want = cpb.table_interp_reference(table, taps, fracs, side)
    assert got.shape == want.shape == (16 * g * g, side, side)
    assert (got - want).abs().max().item() <= K1_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("side,o", [(12, 1), (12, 3), (50, 1), (50, 2)])
def test_exact_kernel_matches_plain_version(dev, side, o):
    """K2 over every query of the grid (N = 144 and 2500, neither a
    multiple of the 256 threads of a block), one and several channels."""
    rng = np.random.default_rng(100 * side + o)
    grid_q = normalized_grid(side, side, dev).reshape(side * side, 2)
    gkv = _uniform(rng, 1.5, (6, 9, 2), dev)
    w = _mlp(rng, o, dev)
    before = _launches()
    with torch.inference_mode():
        got = cpb.cpb_bias_transposed(grid_q, gkv, *w)
    assert _launches() == (before[0], before[1] + 1)
    want = cpb.cpb_bias_transposed_reference(grid_q, gkv, *w)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= K2_TOL


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Device, dtype, contiguity and shape are checked before a launch, and
    a refused call launches nothing."""
    rng = np.random.default_rng(1)
    table = torch.zeros(20, 20, device=dev)
    taps = torch.zeros(4, 2, dtype=torch.int32, device=dev)
    fracs = torch.zeros(4, 2, device=dev)
    before = _launches()
    with pytest.raises(ValueError, match="int32"):
        cpb.table_interp(table, taps.float(), fracs, 10)
    with pytest.raises(ValueError, match="contiguous"):
        cpb.table_interp(table, taps, torch.zeros(2, 4, device=dev).t(), 10)
    with pytest.raises(ValueError, match="bad shapes"):
        cpb.table_interp(table, taps[:, :1].contiguous(), fracs, 10)
    with pytest.raises(ValueError, match="bad shapes"):
        cpb.table_interp(table, taps, fracs, 20)
    with pytest.raises(ValueError, match="out_dtype"):
        cpb.table_interp(table, taps, fracs, 10, torch.float16)

    grid_q = torch.zeros(16, 2, device=dev)
    gkv = torch.zeros(2, 3, 2, device=dev)
    w = _mlp(rng, 1, dev)
    with pytest.raises(ValueError, match="CUDA"):
        cpb.cpb_bias_transposed(grid_q, gkv, w[0].cpu(), *w[1:])
    with pytest.raises(ValueError, match="shapes"):
        cpb.cpb_bias_transposed(grid_q, gkv, *w[:4], w[4][:16], w[5])
    with pytest.raises(ValueError, match="shapes"):
        cpb.cpb_bias_transposed(grid_q, gkv, *_mlp(rng, 65, dev))
    # empty inputs give empty outputs and launch (and count) nothing
    assert cpb.table_interp(table, taps[:0], fracs[:0], 10).shape == (0, 10, 10)
    assert cpb.cpb_bias_transposed(grid_q, gkv[:0], *w).shape == (0, 3, 16)
    assert _launches() == before


def _table_case(rng, side, dev):
    g = (side + 2 - 6) // 4 + 1
    kv_bound = cpb.kv_bound_2d(4.0, g, g)
    table = cpb.cpb_table(*_mlp(rng, 1, dev), side=side, kv_bound=kv_bound)
    gkv = _uniform(rng, 1.25 * kv_bound, (16, g * g, 2), dev)
    taps, fracs = cpb.table_taps(
        cpb.table_shifts(gkv, side=side, kv_bound=kv_bound),
        side=side, tn=table.shape[0])
    return table, taps, fracs


@pytest.mark.cuda
@pytest.mark.parametrize("side,dtype", [(12, torch.float32),
                                        (50, torch.float32),
                                        (50, torch.bfloat16)])
def test_table_backward_kernel_matches_plain_version(dev, side, dtype):
    """K1-bwd with an f32 or bf16 (``cpb_table_bf16``) window cotangent
    against its plain version in float64, bitwise equal over two calls (no
    atomics), every clipped row's shift cotangent kept."""
    rng = np.random.default_rng(10 + side)
    table, taps, fracs = _table_case(rng, side, dev)
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    assert clipped.any()
    dout = torch.from_numpy(rng.normal(size=(taps.shape[0], side, side))
                            .astype(np.float32)).to(dev).to(dtype)
    before = _bwd_launches()
    got = [cpb.table_interp_backward(table, taps, fracs, dout, side)
           for _ in range(2)]
    assert _bwd_launches() == (before[0] + 2, before[1])
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), side)
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32
        assert a.shape == w.shape and _rel(a, w) <= K1_BWD_TOL
    assert (got[0][1][clipped].abs().amax(dim=1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("side,o", [(12, 1), (12, 3), (50, 1), (50, 2)])
def test_exact_backward_kernel_matches_plain_version(dev, side, o):
    """K2-bwd against its plain version in float64 (N = 144 and 2500,
    neither a multiple of the 128 queries of a tile; more rows than
    blocks), and bitwise equal over two calls (no atomics)."""
    rng = np.random.default_rng(200 * side + o)
    grid_q = normalized_grid(side, side, dev).reshape(side * side, 2)
    gkv = _uniform(rng, 1.5, (8, 40, 2), dev)
    w = _mlp(rng, o, dev)
    shape = (8, 40, side * side) if o == 1 else (8, o, 40, side * side)
    dbias = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    before = _bwd_launches()
    got = [cpb.cpb_bias_transposed_backward(grid_q, gkv, *w, dbias)
           for _ in range(2)]
    assert _bwd_launches() == (before[0], before[1] + 2)
    want = cpb.cpb_bias_transposed_backward_reference(
        grid_q.double(), gkv.double(), *(t.double() for t in w),
        dbias.double())
    for a, b, ww in zip(*got, want):
        assert torch.equal(a, b)
        assert a.shape == ww.shape and _rel(a, ww) <= K2_BWD_TOL


@pytest.mark.cuda
def test_autograd_goes_through_the_backward_kernels(dev):
    """With grad mode on, the CPB ops launch their forward kernel, and
    ``backward()`` their backward kernel; the gradients agree with the
    same ops on the CPU (plain versions)."""
    rng = np.random.default_rng(5)
    side, g = 12, 3
    kv_bound = cpb.kv_bound_2d(4.0, g, g)
    gkv = _uniform(rng, kv_bound, (4, g * g, 2), "cpu")
    w = _mlp(rng, 1, "cpu")
    grid_q = normalized_grid(side, side).reshape(side * side, 2)
    dout = torch.from_numpy(rng.normal(size=(4, g * g, side * side))
                            .astype(np.float32))
    for divisor in (1, 0):
        grads = {}
        for device in ("cpu", dev):
            leaves = [t.detach().clone().to(device).requires_grad_()
                      for t in [gkv] + w]
            before = _launches() + _bwd_launches()
            if divisor == 1:
                out = cpb.cpb_bias_table(*leaves, side=side, kv_bound=kv_bound)
            else:
                out = cpb.cpb_bias_transposed(grid_q.to(device), *leaves)
            out.backward(dout.to(device))
            delta = tuple(a - b for a, b in zip(_launches() + _bwd_launches(),
                                                before))
            if device == "cpu":
                assert delta == (0, 0, 0, 0)
            else:
                assert delta == ((1, 0, 1, 0) if divisor == 1
                                 else (0, 1, 0, 1))
            grads[device] = [t.grad.cpu() for t in leaves]
        for a, b in zip(grads[dev], grads["cpu"]):
            assert _rel(a, b.double()) <= 1e-4


@pytest.mark.cuda
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.zeros(20, 20, device=dev)
    taps = torch.zeros(4, 2, dtype=torch.int32, device=dev)
    fracs = torch.zeros(4, 2, device=dev)
    before = _bwd_launches()
    with pytest.raises(ValueError, match="dout"):
        cpb.table_interp_backward(table, taps, fracs,
                                  torch.zeros(4, 9, 9, device=dev), 10)
    with pytest.raises(ValueError, match="float32"):
        cpb.table_interp_backward(table, taps, fracs,
                                  torch.zeros(4, 10, 10, device=dev,
                                              dtype=torch.float64), 10)
    with pytest.raises(ValueError, match="on cpu"):
        cpb.table_interp_backward(table, taps, fracs, torch.zeros(4, 10, 10),
                                  10)
    rng = np.random.default_rng(3)
    w = _mlp(rng, 2, dev)
    grid_q, gkv = torch.zeros(16, 2, device=dev), torch.zeros(2, 3, 2,
                                                             device=dev)
    with pytest.raises(ValueError, match="dbias"):
        cpb.cpb_bias_transposed_backward(grid_q, gkv, *w,
                                         torch.zeros(2, 3, 16, device=dev))
    assert _bwd_launches() == before


def _teacher_inputs(device, seed=0):
    r = np.random.default_rng(seed)
    x = dict(x_path10=r.normal(size=(2, 144, 1024)),
             x_path20=r.normal(size=(2, 144, 1024)),
             x_omic_tumor=r.normal(size=(2, 59)),
             x_omic_immune=r.normal(size=(2, 361)))
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in x.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 0])
def test_teacher_forward_on_card_matches_cpu(dev, divisor):
    """The whole f32 TeachersNet (fixdim 144, B=2, real widths) on the card
    through one kernel, against the same seeded weights on the CPU through
    the plain versions: features, attention maps, logits and the survival
    chain."""
    cfg = Config(fixdim=144, batch_size=2,
                 cpb_table_divisor=divisor).validate()
    before = _launches()
    with torch.inference_mode():
        card = define_net(cfg, dev)(**_teacher_inputs(dev))
        host = define_net(cfg, "cpu")(**_teacher_inputs("cpu"))
    k1, k2 = (a - b for a, b in zip(_launches(), before))
    assert (k1, k2) == ((4, 0) if divisor == 1 else (0, 4))
    for got, want in zip(card, host):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            err = (got[k].cpu() - want[k]).abs().max().item()
            assert err <= FORWARD_TOL, (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 0])
def test_train_step_on_card_matches_cpu(dev, divisor):
    """One ``deterministic_training`` step in f32 (fixdim 144, B=2, real
    widths) from the same seeded weights on the same batch, on the card
    through the kernels and on the CPU through the plain versions: the loss,
    and every parameter's gradient after modulation."""
    cfg = Config(fixdim=144, batch_size=2, cpb_table_divisor=divisor,
                 deterministic_training=True).validate()
    batch = SyntheticBagDataset(size=2, fixdim=144, seed=0).batch([0, 1])
    out = {}
    before = _launches() + _bwd_launches()
    for device in ("cpu", dev):
        model = define_net(cfg, device)
        opt = make_optimizer(cfg, model.parameters())
        m = make_train_step(model, cfg, opt)(batch_to_tensors(batch, device))
        out[device] = ((m["loss"].item(), m["taskloss"].item()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    delta = tuple(a - b for a, b in zip(_launches() + _bwd_launches(),
                                        before))
    assert delta == ((4, 0, 4, 0) if divisor == 1 else (0, 4, 0, 4))
    ((loss_card, task_card), g_card), ((loss_cpu, task_cpu), g_cpu) = (
        out[dev], out["cpu"])
    assert abs(task_card - task_cpu) <= 1e-5 * abs(task_cpu)
    assert abs(loss_card - loss_cpu) <= 5e-4 * abs(loss_cpu)
    for name, want in g_cpu.items():
        got = g_card[name]
        if name.endswith("rel_pos_bias.mlp.2.bias"):
            floor = 1e-5 * g_cpu[name[:-4] + "weight"].abs().max().item()
            assert got.abs().max().item() <= floor, name
            continue
        assert _rel(got, want.double()) <= GRAD_TOL, name


@pytest.mark.cuda
def test_inference_entry_on_card_with_bf16_streams(dev):
    """The serving entry at the preset's settings (divisor 1, bf16 streams)
    on a tiny synthetic cohort: 3 bags in batches of 2, so the last batch
    is padded; K1 launches 4 times per batch, K2 never; the attention
    streams are bf16 on the card."""
    cfg = Config.diag2021().replace(fixdim=144, batch_size=2,
                                    synthetic_data=True,
                                    synthetic_test_size=3,
                                    debug=True).validate()
    before = _launches()
    metrics, logits = inference.main(cfg, device=dev)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (8, 0)
    assert set(logits) == {"logits_tea10", "logits_tea20", "logits_teas"}
    for v in logits.values():
        assert v.shape == (3, 4) and np.isfinite(v).all()
    assert len(metrics) == 21
    assert all(math.isfinite(v) for v in metrics.values())
    with torch.inference_mode():
        atts = define_net(cfg, dev)(**_teacher_inputs(dev))[1]
    assert all(a.dtype == torch.bfloat16 for a in atts.values())


def _dpc_launches():
    return dpc_knn.knn_stream.launches, dpc_knn.parent_stream.launches


def _ln_tokens(rng, shape, device):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return torch.nn.functional.layer_norm(x, shape[-1:]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,k", [(2, 300, 32, 5), (1, 513, 16, 8),
                                     (4, 2500, 128, 5)])
def test_dpc_kernels_match_plain_versions(dev, B, N, C, k):
    """K3-knn and K3-parent against their plain versions on the card: N not
    a multiple of the 64-token block nor of the 32-row tile, k up to 8,
    and the production shape."""
    rng = np.random.default_rng(N + k)
    x = _ln_tokens(rng, (B, N, C), dev)
    x2 = (x * x).sum(-1)
    density = torch.from_numpy(rng.uniform(size=(B, N)).astype(np.float32)
                               ).to(dev)
    before = _dpc_launches()
    knn2, rmax2 = dpc_knn.knn_stream(x, x2, k)
    parent2 = dpc_knn.parent_stream(x, x2, density)
    torch.cuda.synchronize()
    assert _dpc_launches() == (before[0] + 1, before[1] + 1)
    want = dpc_knn.knn_stream_reference(x, x2, k) + (
        dpc_knn.parent_stream_reference(x, x2, density),)
    tol = K3_TOL_ULPS * C * 2.0 ** -24 * x2.max().item()
    for got, w in zip((knn2, rmax2, parent2), want):
        assert got.shape == w.shape
        assert (got - w).abs().max().item() <= tol
    top = density.argmax(dim=1)
    assert (parent2[torch.arange(B), top] == dpc_knn.BIG).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_dpc_cluster_on_card_matches_the_cpu(dev, case):
    """The whole assignment on the card (kernels) and on the CPU (plain
    versions) gives the same centres and clusters.  The duplicate case
    repeats one vector of +-1 entries over half of each bag: its distances
    are exactly 0 in any summation order, so ties are exact on both sides
    and must be broken the same way (JAX's top-k order)."""
    rng = np.random.default_rng(3)
    x = _ln_tokens(rng, (2, 600, 128), "cpu")
    if case == "duplicates":
        x[:, 300:] = torch.from_numpy(rng.choice([-1.0, 1.0], size=128)
                                      .astype(np.float32))
    noise = torch.from_numpy(rng.uniform(size=(2, 600)).astype(np.float32))
    host = cluster.dpc_knn_cluster(x, 4, 5, density_noise=noise)
    before = _dpc_launches()
    card = cluster.dpc_knn_cluster(x.to(dev), 4, 5,
                                   density_noise=noise.to(dev))
    assert _dpc_launches() == (before[0] + 1, before[1] + 1)
    for got, want in zip(card, host):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_dpc_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 8, 16, device=dev)
    x2 = torch.zeros(1, 8, device=dev)
    before = _dpc_launches()
    with pytest.raises(ValueError, match="multiple of 4"):
        dpc_knn.knn_stream(torch.zeros(1, 8, 6, device=dev), x2, 3)
    aligned = torch.zeros(8 * 16 + 1, device=dev)[1:].view(1, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        dpc_knn.knn_stream(aligned, x2, 3)
    with pytest.raises(ValueError, match="float32"):
        dpc_knn.parent_stream(x.double(), x2, x2)
    with pytest.raises(ValueError, match="contiguous"):
        dpc_knn.parent_stream(x, x2, torch.zeros(1, 16, device=dev)[:, ::2])
    with pytest.raises(ValueError, match="CUDA"):
        dpc_knn.parent_stream(x, x2, x2.cpu())
    with pytest.raises(ValueError, match="k=9"):
        dpc_knn.knn_stream(x, x2, 9)
    with pytest.raises(ValueError, match="shared memory"):
        dpc_knn.knn_stream(torch.zeros(1, 8, 1024, device=dev), x2, 3)
    # empty bags give empty outputs and launch (and count) nothing
    assert dpc_knn.parent_stream(x[:0], x2[:0], x2[:0]).shape == (0, 8)
    assert _dpc_launches() == before


def _dpc_case(B, N, C, device, seed):
    """LayerNormed tokens whose last quarter repeats the first token (exact
    ties), their |x|^2 and a random density."""
    rng = np.random.default_rng(seed)
    x = _ln_tokens(rng, (B, N, C), device)
    x[:, N - N // 4:] = x[:, :1]
    density = torch.from_numpy(rng.uniform(size=(B, N)).astype(np.float32)
                               ).to(device)
    return x, (x * x).sum(-1), density


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,k", [(1, 1, 4, 1), (2, 50, 12, 8),
                                     (1, 130, 4, 8), (3, 2501, 12, 8),
                                     (1, 64, 128, 5)])
def test_dpc_kernels_at_the_split_and_tile_edges(dev, B, N, C, k):
    """K3 at the edges of its plan: N = 1; N below one 128-neighbour tile
    and below one 64-token tile; C = 4 and 12 (one zero-padded 32-channel
    slice); N past a tile, with blocks of two runs; against the plain
    versions, bitwise over two calls, one launch counted per wrapper
    call."""
    x, x2, density = _dpc_case(B, N, C, dev, seed=N + C)
    before = _dpc_launches()
    first = dpc_knn.knn_stream(x, x2, k) + (
        dpc_knn.parent_stream(x, x2, density),)
    again = dpc_knn.knn_stream(x, x2, k) + (
        dpc_knn.parent_stream(x, x2, density),)
    torch.cuda.synchronize()
    assert _dpc_launches() == (before[0] + 2, before[1] + 2)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    want = dpc_knn.knn_stream_reference(x, x2, k) + (
        dpc_knn.parent_stream_reference(x, x2, density),)
    tol = K3_TOL_ULPS * C * 2.0 ** -24 * x2.max().item()
    for got, w in zip(first, want):
        assert got.shape == w.shape
        assert (got - w).abs().max().item() <= tol
    assert torch.equal(first[2] >= 1e37, want[2] >= 1e37)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [44, 45, 97, 264, 484])
def test_dpc_kernels_do_not_depend_on_the_block_count(dev, blocks):
    """The finishing kernel's merge is exact: K3 at any block count gives
    the wrapper's result bitwise (B=2, N = 1345: 44 token tiles, 11
    neighbour tiles, the last 65 wide; from one token tile a block to one
    pair a block)."""
    from disentangled_multimodal_learning_tpu_torch.ops.build import kernels

    B, N, C, k = 2, 1345, 32, 8
    x, x2, density = _dpc_case(B, N, C, dev, seed=blocks)
    want = dpc_knn.knn_stream(x, x2, k) + (
        dpc_knn.parent_stream(x, x2, density),)
    plan = dpc_knn.dpc_plan(B, N)._replace(blocks=blocks)
    knn2, rmax2, parent2 = (torch.empty_like(w) for w in want)
    stream = torch.cuda.current_stream().cuda_stream
    part = dpc_knn.dpc_scratch(plan, x, k)
    assert kernels().dmlt_dpc_knn(
        x.data_ptr(), x2.data_ptr(), B, N, C, k, plan.blocks,
        part.data_ptr(), knn2.data_ptr(), rmax2.data_ptr(), stream) == 0
    part = dpc_knn.dpc_scratch(plan, x, None)
    assert kernels().dmlt_dpc_parent(
        x.data_ptr(), x2.data_ptr(), density.data_ptr(), B, N, C,
        plan.blocks, part.data_ptr(), parent2.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    for got, w in zip((knn2, rmax2, parent2), want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 0])
def test_student_forward_on_card_matches_cpu(dev, divisor):
    """The whole f32 StudentsNet (fixdim 144, B=2, real widths, 2
    clusters) on the card through the kernels, against the same seeded
    weights on the CPU through the plain versions: per forward K3-knn and
    K3-parent twice (one per scale), the CPB kernel of the divisor twice."""
    cfg = Config(mode="student", fixdim=144, batch_size=2,
                 cpb_table_divisor=divisor).validate()
    x = {k: v for k, v in _teacher_inputs("cpu").items()
         if k in ("x_path10", "x_path20")}
    before = _launches() + _dpc_launches()
    with torch.inference_mode():
        card = define_net(cfg, dev)(**{k: v.to(dev) for k, v in x.items()})
        host = define_net(cfg, "cpu")(**x)
    delta = tuple(a - b for a, b in zip(_launches() + _dpc_launches(),
                                        before))
    assert delta == ((2, 0, 2, 2) if divisor == 1 else (0, 2, 2, 2))
    for got, want in zip(card, host):
        assert set(got) == set(want)
        for k in want:
            err = (got[k].cpu() - want[k]).abs().max().item()
            assert err <= FORWARD_TOL, (k, err)


@pytest.mark.cuda
def test_distillation_steps_on_card_at_the_exact_cpb(dev):
    """The distillation steps at divisor 0 (fixdim 144, B=2, real widths;
    the preset's divisor 1 is ``chip_smoke.py``'s phase 3g): the uncached
    step runs the teacher (K2-fwd 4) and the student (K2-fwd 2, K2-bwd 2,
    K3-knn 2, K3-parent 2); the cached step runs the teacher on a batch's
    first sight only, and a replay launches the student's kernels alone."""
    cfg = Config(mode="distillation", fixdim=144, batch_size=2,
                 cpb_table_divisor=0).validate()
    batch = SyntheticBagDataset(size=2, fixdim=144, seed=0).batch([0, 1])
    batch.indices = np.array([0, 1])
    x = batch_to_tensors(batch, dev)
    student_kernels = (2, 0, 2, 2, 2)

    def counts():
        return (cpb.cpb_bias_transposed.launches, cpb.table_interp.launches,
                cpb.cpb_bias_transposed_backward.launches,
                *_dpc_launches())

    def delta(step, tensors):
        before = counts()
        loss = step(tensors)["loss"].item()
        assert math.isfinite(loss)
        return tuple(a - b for a, b in zip(counts(), before))

    student, teacher = define_net(cfg, dev)
    opt = make_optimizer(cfg, student.parameters())
    sched = make_scheduler(cfg, opt, 1)  # the lr (the optimizer's base is 1)
    step = make_train_step(student, cfg, opt, sched, teacher=teacher)
    assert delta(step, x) == (4 + 2, 0, 2, 2, 2)
    cache = TeacherBoundaryCache(make_teacher_boundary_fn(teacher), 2, dev)
    cached = make_distill_cached_step(student, cfg, opt, sched)
    for visit in range(2):
        before = counts()
        tensors = dict(x, **cache.boundary(x, batch.indices))
        teacher_kernels = tuple(a - b for a, b in zip(counts(), before))
        assert teacher_kernels == ((4, 0, 0, 0, 0) if visit == 0
                                   else (0,) * 5)
        assert delta(cached, tensors) == student_kernels
    assert (cache.hits, cache.misses) == (1, 1)
    assert cache.store["tea_ft10"].device.type == "cuda"


def _k4_launches():
    return (cpb1d.table1d_interp.launches,
            cpb1d.table1d_interp_backward.launches)


def _table1d_case(rng, n_q, bg, kv, dev, kv_bound=None):
    """The 1-D table of a random MLP (O = 2) and taps of kv points up to
    25% past the bound, so that clipped rows extrapolate (the bound is
    the 1-D attention's unless given: a larger one makes a wider table)."""
    kv_bound = kv_bound or 1.0 + 4.0 / (kv - 1)
    w = _mlp(rng, 2, dev)
    w[0] = w[0][:1].contiguous()  # the 1-coordinate first layer
    table = cpb1d.cpb_table_1d(*w, n_q=n_q, kv_bound=kv_bound)
    gkv = _uniform(rng, 1.25 * kv_bound, (bg, kv), dev)
    taps, fracs = cpb1d.table1d_taps(
        cpb1d.table1d_shifts(gkv, n_q=n_q, kv_bound=kv_bound),
        n_q=n_q, tn=table.shape[1])
    return table, taps, fracs


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,bg,kv", [(65, 8, 16), (2501, 16, 625)])
def test_table1d_kernel_matches_plain_version(dev, n_q, bg, kv):
    """K4 at the 1-D attention of fixdim 64 and of the preset (n_q 2501,
    K 625; 16 of the preset's 16 (batch, group) rows), written straight
    into the [B*G, O, K, N] layout, clipped rows included."""
    rng = np.random.default_rng(n_q)
    table, taps, fracs = _table1d_case(rng, n_q, bg, kv, dev)
    assert ((fracs < 0) | (fracs > 1)).any()
    before = _k4_launches()
    with torch.inference_mode():
        got = cpb1d.table1d_interp(table, taps, fracs, n_q, kv)
    assert _k4_launches() == (before[0] + 1, before[1])
    want = cpb1d.table1d_interp_reference(table, taps, fracs, n_q, kv)
    assert got.shape == want.shape == (bg, 2, kv, n_q)
    assert (got - want).abs().max().item() <= K4_TOL


# K4-bwd's cases: (n_q, bg, kv, TABLE1D_BWD_BLOCKS or None for the
# default, kv_bound or None for the 1-D attention's): the wrapper's plan at
# fixdim 64 and at the preset, the preset in 10 row groups (the fewest its
# 1,024-row groups allow), an odd shape in groups of 6 that do not divide
# its 21 rows, one row, and a 2 x 14,917 table, past the 227 KB of shared
# memory that the earlier design's table and partial copies needed
TABLE1D_BWD_CASES = [
    pytest.param(65, 8, 16, None, None, id="65-8-16"),
    pytest.param(2501, 16, 625, None, None, id="2501-16-625"),
    pytest.param(2501, 16, 625, 1, None, id="2501-16-625-in-10-groups"),
    pytest.param(37, 7, 3, 8, None, id="37-7-3-in-groups-of-6"),
    pytest.param(37, 1, 1, None, 2.0, id="37-1-1"),
    pytest.param(65, 4, 9, None, 232.0, id="65-4-9-tn-14917"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,bg,kv,blocks,kv_bound", TABLE1D_BWD_CASES)
def test_table1d_backward_kernel_matches_float64(dev, monkeypatch, n_q, bg,
                                                 kv, blocks, kv_bound):
    """K4-bwd against its plain version in float64, clipped rows included
    (their shift cotangent kept), and bitwise equal over two calls, at the
    wrapper's plan and at other row-group counts, odd shapes and a table
    wider than the earlier design's shared memory held."""
    rng = np.random.default_rng(10 + n_q + bg + kv)
    table, taps, fracs = _table1d_case(rng, n_q, bg, kv, dev, kv_bound)
    if blocks:
        monkeypatch.setattr(cpb1d, "TABLE1D_BWD_BLOCKS", blocks)
    dout = torch.from_numpy(rng.normal(size=(bg, 2, kv, n_q))
                            .astype(np.float32)).to(dev)
    before = _k4_launches()
    got = [cpb1d.table1d_interp_backward(table, taps, fracs, dout, n_q, kv)
           for _ in range(2)]
    assert _k4_launches() == (before[0], before[1] + 2)
    want = cpb1d.table1d_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), n_q, kv)
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        assert a.shape == w.shape and _rel(a, w) <= K4_BWD_TOL
    clipped = (fracs < 0) | (fracs > 1)
    assert bg * kv == 1 or clipped.any()
    assert (got[0][1][clipped] != 0).all()


@pytest.mark.cuda
def test_table1d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.zeros(2, 40, device=dev)
    taps = torch.zeros(6, dtype=torch.int32, device=dev)
    fracs = torch.zeros(6, device=dev)
    before = _k4_launches()
    with pytest.raises(ValueError, match="int32"):
        cpb1d.table1d_interp(table, taps.float(), fracs, 10, 3)
    with pytest.raises(ValueError, match="bad shapes"):
        cpb1d.table1d_interp(table, taps, fracs, 10, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        cpb1d.table1d_interp(table, taps, fracs, 39, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cpb1d.table1d_interp(table, taps, fracs.cpu(), 10, 3)
    with pytest.raises(ValueError, match="dout"):
        cpb1d.table1d_interp_backward(table, taps, fracs,
                                      torch.zeros(2, 2, 3, 9, device=dev),
                                      10, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cpb1d.table1d_interp_backward(table, taps, fracs,
                                      torch.zeros(2, 2, 3, 10), 10, 3)
    # more rows than GRID_Y_MAX groups of TABLE1D_BWD_ROWS_MAX rows hold
    rows = cpb1d.GRID_Y_MAX * cpb1d.TABLE1D_BWD_ROWS_MAX + 1
    with pytest.raises(ValueError, match="TABLE1D_BWD_ROWS_MAX"):
        cpb1d.table1d_interp_backward(
            torch.zeros(1, 8, device=dev),
            torch.zeros(rows, dtype=torch.int32, device=dev),
            torch.zeros(rows, device=dev),
            torch.empty(rows, 1, 1, 1, device=dev), 1, 1)
    # empty inputs give empty outputs and launch (and count) nothing
    assert cpb1d.table1d_interp(table, taps[:0], fracs[:0], 10, 3).shape == (
        0, 2, 3, 10)
    assert _k4_launches() == before


def _deformpathomic_inputs(device, seed=0):
    r = np.random.default_rng(seed)
    x = dict(x_path=r.normal(size=(2, 144, 1024)),
             x_omic=r.normal(size=(2, 431)),
             x_omic_tumor=r.normal(size=(2, 59)),
             x_omic_immune=r.normal(size=(2, 361)))
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in x.items()}


# (attn_dim, return_vgrid, divisor) -> launches per forward of K1, K2, K4
DEFORMPATHOMIC = {(1, False, 1): (0, 0, 2), (1, False, 0): (0, 2, 0),
                  (2, True, 1): (2, 0, 0)}


def _fwd_launches():
    return (cpb.table_interp.launches, cpb.cpb_bias_transposed.launches,
            cpb1d.table1d_interp.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_dim,return_vgrid,divisor", list(DEFORMPATHOMIC))
def test_deformpathomic_forward_on_card_matches_cpu(dev, attn_dim,
                                                    return_vgrid, divisor):
    """The whole f32 DeformPathomicNet (fixdim 144, B=2, real widths) on
    the card through the kernels, against the same seeded weights on the
    CPU through the plain versions: features, branch vectors and every
    logits entry."""
    cfg = Config(mode="deformpathomic", fixdim=144, batch_size=2,
                 attn_dim=attn_dim, return_vgrid=return_vgrid,
                 cpb_table_divisor=divisor).validate()
    before = _fwd_launches()
    with torch.inference_mode():
        card = define_net(cfg, dev)(**_deformpathomic_inputs(dev))
        host = define_net(cfg, "cpu")(**_deformpathomic_inputs("cpu"))
    delta = tuple(a - b for a, b in zip(_fwd_launches(), before))
    assert delta == DEFORMPATHOMIC[(attn_dim, return_vgrid, divisor)]
    flat = lambda out: list(out[:3]) + list(out[3])  # noqa: E731
    for got, want in zip(flat(card), flat(host)):
        assert got.dtype == torch.float32
        assert (got.cpu() - want).abs().max().item() <= FORWARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("attn_dim,return_vgrid,divisor", list(DEFORMPATHOMIC))
def test_deformpathomic_train_step_on_card_matches_cpu(dev, attn_dim,
                                                       return_vgrid, divisor):
    """One ``deterministic_training`` step in f32 (fixdim 144, B=2, real
    widths) from the same seeded weights on the same batch, on the card
    through the forward and backward kernels and on the CPU through the
    plain versions: ``loss3``, the loss, and every gradient after the
    modulation of the top classifier."""
    cfg = Config(mode="deformpathomic", fixdim=144, batch_size=2,
                 attn_dim=attn_dim, return_vgrid=return_vgrid,
                 cpb_table_divisor=divisor,
                 deterministic_training=True).validate()
    batch = SyntheticBagDataset(size=2, fixdim=144, seed=0).batch([0, 1])
    out = {}
    before = _fwd_launches() + _k4_launches()[1:] + _bwd_launches()
    for device in ("cpu", dev):
        model = define_net(cfg, device)
        opt = make_optimizer(cfg, model.parameters())
        m = make_train_step(model, cfg, opt)(batch_to_tensors(batch, device))
        out[device] = ((m["loss"].item(), m["loss3"].item()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    delta = tuple(a - b for a, b in zip(
        _fwd_launches() + _k4_launches()[1:] + _bwd_launches(), before))
    k1, k2, k4 = DEFORMPATHOMIC[(attn_dim, return_vgrid, divisor)]
    assert delta == (k1, k2, k4, k4, k1, k2)
    ((loss_card, task_card), g_card), ((loss_cpu, task_cpu), g_cpu) = (
        out[dev], out["cpu"])
    assert abs(task_card - task_cpu) <= 1e-5 * abs(task_cpu)
    assert abs(loss_card - loss_cpu) <= 5e-4 * abs(loss_cpu)
    for name, want in g_cpu.items():
        got = g_card[name]
        if name.endswith("rel_pos_bias.mlp.2.bias"):
            floor = 1e-5 * g_cpu[name[:-4] + "weight"].abs().max().item()
            assert got.abs().max().item() <= floor, name
            continue
        assert _rel(got, want.double()) <= GRAD_TOL, name


# ---------------------------------------------------------------- K5 and K6

def _strided_case(rng, divisor, dev, side=50, rows=(16, 144)):
    """A table at ``divisor``, and taps and fractions of kv points up to
    25% past the bound of a 12 x 12 deformed grid (clipped rows)."""
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    table = cpb.cpb_table(*_mlp(rng, 1, dev), side=side, kv_bound=kv_bound,
                          divisor=divisor)
    gkv = _uniform(rng, 1.25 * kv_bound, rows + (2,), dev)
    taps, fracs = cpb.table_taps(
        cpb.table_shifts(gkv, side=side, kv_bound=kv_bound, divisor=divisor),
        side=side, tn=table.shape[0], divisor=divisor)
    return table, taps, fracs


def _k56_launches():
    return (cpb.table_interp.launches, cpb.table_interp_backward.launches,
            cpb.table_interp_strided.launches,
            cpb.table_interp_strided_backward.launches,
            fused_table.fused_table_attention.launches,
            fused_table.fused_table_attention_backward.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_kernels_match_plain_version_bitwise(dev, divisor, dtype):
    """K5-fwd at divisor 2 and 4 (tn 274 and 544 at side 50) and K1-fwd, in
    f32 and with the bf16 store, bitwise equal to their plain version (the
    same ops rounded the same way, the store rounded to nearest even),
    clipped rows included; one launch of the right kernel each."""
    rng = np.random.default_rng(20 + divisor)
    table, taps, fracs = _strided_case(rng, divisor, dev)
    assert ((fracs < 0) | (fracs > 1)).any()
    before = _k56_launches()
    with torch.inference_mode():
        got = (cpb.table_interp(table, taps, fracs, 50, dtype) if divisor == 1
               else cpb.table_interp_strided(table, taps, fracs, 50, divisor,
                                             dtype))
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == ((1, 0, 0, 0, 0, 0) if divisor == 1
                     else (0, 0, 1, 0, 0, 0))
    want = cpb.table_interp_reference(table, taps, fracs, 50, divisor, dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("side,rows", [(1, 1), (2, 5), (3, 7), (7, 1),
                                       (7, 5), (33, 1), (33, 5), (50, 1),
                                       (7, 3000), (33, 2500), (120, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_kernel_at_odd_sides_bitwise(dev, side, rows, dtype):
    """K1-fwd at sides whose rows start off the vector alignment (a scalar
    head and tail; side 1 to 3 below one vector a window row), R = 1, more
    rows than one wave's blocks take once, and side 120 (a window past the
    48 KB the earlier design staged per row), in f32 and with the bf16
    store: bitwise equal to its plain version, clipped rows within four
    cells included, one launch each."""
    rng = np.random.default_rng(1000 * side + rows)
    table, taps, fracs, _ = _tile_edge_case(rng, side, 1, rows, dev)
    before = _k56_launches()
    with torch.inference_mode():
        got = cpb.table_interp(table, taps, fracs, side, dtype)
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == (1, 0, 0, 0, 0, 0)
    want = cpb.table_interp_reference(table, taps, fracs, side, 1, dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_kernel_reads_a_large_table_through_l1(dev, dtype):
    """K1-fwd with a 311 x 311 table (378 KB, more than a block's shared
    memory, so read from global memory through L1 instead of copied):
    bitwise equal to its plain version at side 50, clipped rows included,
    one launch."""
    rng = np.random.default_rng(77)
    table, taps, fracs, _ = _tile_edge_case(rng, 50, 1, 300, dev, extra=260)
    assert table.numel() * 4 > 227 * 1024
    before = _k56_launches()
    with torch.inference_mode():
        got = cpb.table_interp(table, taps, fracs, 50, dtype)
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == (1, 0, 0, 0, 0, 0)
    want = cpb.table_interp_reference(table, taps, fracs, 50, 1, dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [2, 3, 4])
@pytest.mark.parametrize("side,rows", [(1, 1), (2, 5), (3, 7), (7, 1),
                                       (7, 1003), (33, 529), (50, 4609)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_kernel_at_the_edges_bitwise(dev, divisor, side, rows, dtype):
    """K5-fwd (the x-phase pair planes at d >= 3, the table at d = 2, a
    block a row) at sides 1 to 3, 7, 33 and 50, R from 1 to 4609, tables
    37 lines past a window's reach (the last pair of phase d - 1 past the
    table's last column), clipped rows within four cells, f32 and bf16
    stores: bitwise equal to its plain version, one launch each."""
    rng = np.random.default_rng(2000 * divisor + 10 * side + rows)
    table, taps, fracs, _ = _tile_edge_case(rng, side, divisor, rows, dev)
    assert ((fracs < 0) | (fracs > 1)).any()
    before = _k56_launches()
    with torch.inference_mode():
        got = cpb.table_interp_strided(table, taps, fracs, side, divisor,
                                       dtype)
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == (0, 0, 1, 0, 0, 0)
    want = cpb.table_interp_reference(table, taps, fracs, side, divisor,
                                      dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [2, 3, 4])
@pytest.mark.parametrize("side", [7, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_kernel_at_a_misaligned_output(dev, divisor, side, dtype):
    """K5-fwd's C entry writing from one element past an aligned start
    (every row off the bf16 pair alignment at side 50): bitwise equal to
    the plain version, nothing written before the output; its scratch is
    the restated pair planes (``[d, tn_rows, ceil(tn_cols / d)]`` float2)
    at d >= 3 and none at d = 2."""
    from disentangled_multimodal_learning_tpu_torch.ops.build import kernels

    rng = np.random.default_rng(3000 + 10 * divisor + side)
    table, taps, fracs, _ = _tile_edge_case(rng, side, divisor, 777, dev)
    R, n = taps.shape[0], side * side
    buf = torch.zeros(R * n + 1, dtype=dtype, device=dev)
    nbytes = kernels().dmlt_cpb_table_strided_fwd_scratch(*table.shape,
                                                          divisor)
    assert nbytes == (0 if divisor == 2 else 8 * divisor * table.shape[0]
                      * -(-table.shape[1] // divisor))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = kernels().dmlt_cpb_table_strided_fwd(
        table.data_ptr(), *table.shape, taps.data_ptr(), fracs.data_ptr(),
        buf[1:].data_ptr(), int(dtype == torch.bfloat16), R, side, divisor,
        scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    want = cpb.table_interp_reference(table, taps, fracs, side, divisor,
                                      dtype)
    assert buf[0].item() == 0 and torch.equal(buf[1:].view(R, side, side),
                                              want)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_backward_kernel_matches_float64(dev, divisor, dtype):
    """K5-bwd with an f32 or bf16 window cotangent against its plain version
    in float64 (1e-5 norm-relative), bitwise equal over two calls, and
    every clipped row's shift cotangent kept."""
    rng = np.random.default_rng(30 + divisor)
    table, taps, fracs = _strided_case(rng, divisor, dev)
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    dout = torch.from_numpy(rng.normal(size=(taps.shape[0], 50, 50))
                            .astype(np.float32)).to(dev).to(dtype)
    before = _k56_launches()
    got = [cpb.table_interp_strided_backward(table, taps, fracs, dout, 50,
                                             divisor) for _ in range(2)]
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == (0, 0, 0, 2, 0, 0)
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), 50, divisor)
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32 and _rel(a, w) <= K5_BWD_TOL
    assert clipped.any()
    assert (got[0][1][clipped].abs().amax(dim=1) > 0).all()


def _tile_edge_case(rng, side, divisor, rows, dev, extra=37,
                    overshoot=3.5):
    """A random f32 table ``extra`` lines (rounded up to the divisor) past
    a window's reach, so its sides are no multiple of the backward's tiles;
    the taps and fractions of ``rows`` shifts up to ``overshoot`` cells past
    either end (the first row clipped at both: clipped rows within four
    cells); a window cotangent."""
    reach = side + 1 if divisor == 1 else divisor * (side - 1) + 2
    tn = -(-(reach + extra) // divisor) * divisor
    table = torch.from_numpy(rng.normal(size=(tn, tn)).astype(np.float32))
    hi = tn - reach
    shifts = rng.uniform(-overshoot, hi + overshoot, size=(rows, 2))
    shifts[0] = (-0.9 * overshoot, hi + 0.9 * overshoot)
    taps, fracs = cpb.table_taps(torch.from_numpy(shifts.astype(np.float32)),
                                 side=side, tn=tn, divisor=divisor)
    dout = torch.from_numpy(rng.normal(size=(rows, side, side))
                            .astype(np.float32))
    return table.to(dev), taps.to(dev), fracs.to(dev), dout.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [1, 2, 3, 4])
@pytest.mark.parametrize("side,rows", [(1, 1), (2, 3), (7, 1), (13, 200),
                                       (50, 7), (50, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_backward_tiles_at_the_edges(dev, divisor, side, rows, dtype):
    """K1-bwd (divisor 1) and K5-bwd at the edges of their tile design:
    table sides no multiple of a tile, fewer rows than row groups (R = 1
    included), side 1 and 2, divisors 1 to 4, clipped rows within four
    cells, f32 and bf16 cotangents: against the plain backward in float64
    (``K1_BWD_TOL`` / ``K5_BWD_TOL`` norm-relative), bitwise over two
    calls, every clipped row's shift cotangent kept, one launch each."""
    rng = np.random.default_rng(1000 * divisor + 10 * side + rows)
    table, taps, fracs, dout = _tile_edge_case(rng, side, divisor, rows, dev)
    dout = dout.to(dtype)
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    assert clipped[0] and (fracs.abs() < 4.5).all()
    bwd = (cpb.table_interp_backward if divisor == 1 else
           lambda *a: cpb.table_interp_strided_backward(*a, divisor))
    before = _k56_launches()
    got = [bwd(table, taps, fracs, dout, side) for _ in range(2)]
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == ((0, 2, 0, 0, 0, 0) if divisor == 1
                     else (0, 0, 0, 2, 0, 0))
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), side, divisor)
    tol = K1_BWD_TOL if divisor == 1 else K5_BWD_TOL
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32 and _rel(a, w) <= tol
    assert (got[0][1][clipped].abs().amax(dim=1) > 0).all()


@pytest.mark.cuda
def test_fused_backward_scatters_through_the_table_backward(dev):
    """K6-bwd hands its ds to K1-bwd's kernels: the scatter on a given ds
    is K1-bwd's result on it bitwise, and it counts nothing."""
    rng = np.random.default_rng(44)
    table, taps, fracs, ds = _tile_edge_case(rng, 11, 1, 300, dev)
    dtable, dfracs = torch.empty_like(table), torch.empty_like(fracs)
    before = _k56_launches()
    cpb.table_scatter_launch(table, taps, fracs, ds, 11, dtable, dfracs)
    assert _k56_launches() == before
    want = cpb.table_interp_backward(table, taps, fracs, ds, 11)
    assert torch.equal(dtable, want[0]) and torch.equal(dfracs, want[1])


def _fused_case(rng, dev, bh=8, k=144, side=50, d=64):
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    table = cpb.cpb_table(*_mlp(rng, 1, dev), side=side, kv_bound=kv_bound)
    gkv = _uniform(rng, 1.25 * kv_bound, (bh, k, 2), dev)
    shifts = cpb.table_shifts(gkv, side=side, kv_bound=kv_bound)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dev)

    n = side * side
    return dict(q=rnd(bh, n, d, scale=d ** -0.5), k=rnd(bh, k, d),
                v=rnd(bh, k, d), table=table, shifts=shifts,
                g_out=rnd(bh, n, d), g_attn=rnd(bh, k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_kernel_matches_plain_version(dev, rate):
    """K6-fwd at the teacher's per-head shapes (K = 144, N = 2500, D = 64;
    8 of the 32 batch-heads) against its plain version, with the same
    dropout mask: attn within 1e-6 abs, out within 1e-5; one launch, no
    K1."""
    c = _fused_case(np.random.default_rng(40), dev)
    before = _k56_launches()
    with torch.inference_mode():
        out, attn = fused_table.fused_table_attention(
            c["q"], c["k"], c["v"], c["table"], c["shifts"], 50, 77, rate)
    assert tuple(a - b for a, b in zip(_k56_launches(), before)) == (
        0, 0, 0, 0, 1, 0)
    want_out, want_attn = fused_table.fused_table_attention_reference(
        c["q"], c["k"], c["v"], c["table"], c["shifts"], 50, 77, rate)
    assert (attn - want_attn).abs().max().item() <= K6_ATTN_TOL
    assert (out - want_out).abs().max().item() <= K6_OUT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_backward_kernel_matches_float64(dev, rate):
    """K6-bwd (with the map's own cotangent) against the plain version's
    autograd in float64: dq, dk, dv within 2e-5 norm-relative, dtable and
    dfracs within 1e-4 or twice the f32 plain version's own error; bitwise
    equal over two calls; one K6-bwd launch each and no K1-bwd count (its
    kernels run inside K6-bwd)."""
    c = _fused_case(np.random.default_rng(41), dev)
    taps, fracs = cpb.table_taps(c["shifts"], side=50,
                                 tn=c["table"].shape[0])
    with torch.inference_mode():
        _, attn = fused_table.fused_table_attention(
            c["q"], c["k"], c["v"], c["table"], c["shifts"], 50, 5, rate)
    before = _k56_launches()
    got = [fused_table.fused_table_attention_backward(
        c["q"], c["k"], c["v"], c["table"], taps, fracs, attn, c["g_out"],
        c["g_attn"], 50, 5, rate) for _ in range(2)]
    assert tuple(a - b for a, b in zip(_k56_launches(), before)) == (
        0, 0, 0, 0, 0, 2)
    ref = {dt: fused_table.fused_table_attention_backward_reference(
        *(c[n].to(dt) for n in ("q", "k", "v", "table")), taps, fracs.to(dt),
        c["g_out"].to(dt), c["g_attn"].to(dt), 50, 5, rate)
        for dt in (torch.float64, torch.float32)}
    for i, (g1, g2, w64, w32) in enumerate(zip(*got, ref[torch.float64],
                                               ref[torch.float32])):
        assert torch.equal(g1, g2)
        tol = (K6_BWD_TOL if i < 3
               else max(K6_TABLE_BWD_TOL, 2 * _rel(w32, w64)))
        assert _rel(g1, w64) <= tol, i


@pytest.mark.cuda
@pytest.mark.parametrize("side", [3, 11])
@pytest.mark.parametrize("d", [4, 12, 64])
@pytest.mark.parametrize("k", [1, 7, 17, 160])
def test_fused_kernels_at_the_tile_edges(dev, k, side, d):
    """K6-fwd and K6-bwd at shapes off every tile edge of their tensor-core
    design (K padded to 16 rows, D to 8 columns, the query tail of 32-query
    tiles; BH 3), at rate 0 and 0.1: the forward against its plain version
    within ``K6_ATTN_TOL`` and ``K6_OUT_TOL``, the backward against the
    plain version's autograd in float64 (dq, dk, dv within ``K6_BWD_TOL``,
    dtable and dfracs within ``K6_TABLE_BWD_TOL`` or twice the f32 plain
    version's own error); both bitwise equal over two calls."""
    c = _fused_case(np.random.default_rng(60 + k + side + d), dev, bh=3, k=k,
                    side=side, d=d)
    taps, fracs = cpb.table_taps(c["shifts"], side=side,
                                 tn=c["table"].shape[0])
    args = (c["q"], c["k"], c["v"], c["table"])
    for rate in (0.0, 0.1):
        with torch.inference_mode():
            got, again = (fused_table.fused_table_attention(
                *args, c["shifts"], side, 3, rate) for _ in range(2))
        want = fused_table.fused_table_attention_reference(
            *args, c["shifts"], side, 3, rate)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert (got[1] - want[1]).abs().max().item() <= K6_ATTN_TOL
        assert (got[0] - want[0]).abs().max().item() <= K6_OUT_TOL
        bwd = [fused_table.fused_table_attention_backward(
            *args, taps, fracs, got[1], c["g_out"], c["g_attn"], side, 3,
            rate) for _ in range(2)]
        ref = {dt: fused_table.fused_table_attention_backward_reference(
            *(a.to(dt) for a in args), taps, fracs.to(dt),
            c["g_out"].to(dt), c["g_attn"].to(dt), side, 3, rate)
            for dt in (torch.float64, torch.float32)}
        for i, (g1, g2, w64, w32) in enumerate(zip(*bwd, ref[torch.float64],
                                                   ref[torch.float32])):
            assert torch.equal(g1, g2), (rate, i)
            tol = (K6_BWD_TOL if i < 3
                   else max(K6_TABLE_BWD_TOL, 2 * _rel(w32, w64)))
            assert _rel(g1, w64) <= tol, (rate, i)


# opt-in setting -> its config overrides
OPT_IN = {"fused": dict(fused_table_attention=True),
          "divisor4": dict(cpb_table_divisor=4)}


@pytest.mark.cuda
@pytest.mark.parametrize("setting", list(OPT_IN))
def test_opt_in_train_step_on_card_matches_cpu(dev, setting):
    """One ``deterministic_training`` f32 teacher step (fixdim 144, B=2,
    real widths) with the fused table attention (K6) or at divisor 4 (K5),
    on the card against the same seeded weights on the CPU: the task loss,
    the loss and every gradient, as the preset's step is held; 4 launches
    of the setting's forward and backward kernels, K1 never."""
    cfg = Config(fixdim=144, batch_size=2, deterministic_training=True,
                 **{"cpb_table_divisor": 1, **OPT_IN[setting]}).validate()
    batch = SyntheticBagDataset(size=2, fixdim=144, seed=0).batch([0, 1])
    out = {}
    before = _k56_launches()
    for device in ("cpu", dev):
        model = define_net(cfg, device)
        opt = make_optimizer(cfg, model.parameters())
        m = make_train_step(model, cfg, opt)(batch_to_tensors(batch, device))
        out[device] = ((m["loss"].item(), m["taskloss"].item()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    delta = tuple(a - b for a, b in zip(_k56_launches(), before))
    assert delta == ((0, 0, 0, 0, 4, 4) if setting == "fused"
                     else (0, 0, 4, 4, 0, 0))
    ((loss_card, task_card), g_card), ((loss_cpu, task_cpu), g_cpu) = (
        out[dev], out["cpu"])
    assert abs(task_card - task_cpu) <= 1e-5 * abs(task_cpu)
    assert abs(loss_card - loss_cpu) <= 5e-4 * abs(loss_cpu)
    for name, want in g_cpu.items():
        got = g_card[name]
        if name.endswith("rel_pos_bias.mlp.2.bias"):
            floor = 1e-5 * g_cpu[name[:-4] + "weight"].abs().max().item()
            assert got.abs().max().item() <= floor, name
            continue
        assert _rel(got, want.double()) <= GRAD_TOL, name


@pytest.mark.cuda
def test_bf16_table_store_on_the_card_only(dev):
    """``cpb_table_bf16``: the 2-D attention's CPB bias comes out of K1 in
    bf16 on the card and in f32 on the CPU; the K6 and K5 wrappers refuse
    what their kernels do not take, launching nothing."""
    m = DeformCrossAttention2D(128, cpb_table_divisor=1, cpb_table_bf16=True)
    init_weights(m, 2)
    seen = []
    m.rel_pos_bias.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    x = torch.randn(2, 144, 128)
    with torch.inference_mode():
        m.eval()(x, x)
        m.to(dev)(x.to(dev), x.to(dev))
    assert seen == [torch.float32, torch.bfloat16]
    c = _fused_case(np.random.default_rng(42), dev, bh=1, k=4, side=8, d=8)
    before = _k56_launches()
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_table.fused_table_attention(
            c["q"][..., :6].contiguous(), c["k"][..., :6].contiguous(),
            c["v"][..., :6].contiguous(), c["table"], c["shifts"], 8)
    with pytest.raises(ValueError, match="bad shapes"):
        fused_table.fused_table_attention(c["q"], c["k"], c["v"], c["table"],
                                          c["shifts"], 9)
    table, taps, fracs = _strided_case(np.random.default_rng(3), 2, dev,
                                       side=12, rows=(1, 4))
    with pytest.raises(ValueError, match="bad shapes"):
        cpb.table_interp_strided(table[:40, :40].contiguous(), taps, fracs,
                                 12, 4)
    with pytest.raises(ValueError, match="dout"):
        cpb.table_interp_strided_backward(table, taps, fracs,
                                          torch.zeros(4, 11, 11, device=dev),
                                          12, 2)
    assert _k56_launches() == before


def _exact_launches():
    """K2 (kn) and K2-nk forward and backward, K7 forward and backward."""
    return (cpb.cpb_bias_transposed.launches, cpb.cpb_bias_nk.launches,
            cpb.cpb_bias_transposed_backward.launches,
            cpb.cpb_bias_nk_backward.launches,
            fused_exact.fused_exact_attention.launches,
            fused_exact.fused_exact_attention_backward.launches)


def _delta(before):
    return tuple(a - b for a, b in zip(_exact_launches(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("side,o", [(12, 1), (50, 1), (50, 2)])
def test_exact_nk_kernel_is_the_kn_kernel_transposed(dev, side, o):
    """K2-nk (the exact CPB written query-major) is K2 transposed, bitwise
    (both evaluate a point with the same code), and within 1e-4 of its
    plain version; one launch each."""
    rng = np.random.default_rng(300 * side + o)
    grid_q = normalized_grid(side, side, dev).reshape(side * side, 2)
    gkv = _uniform(rng, 1.5, (6, 9, 2), dev)
    w = _mlp(rng, o, dev)
    before = _exact_launches()
    with torch.inference_mode():
        nk = cpb.cpb_bias_nk(grid_q, gkv, *w)
        kn = cpb.cpb_bias_transposed(grid_q, gkv, *w)
    assert _delta(before) == (1, 1, 0, 0, 0, 0)
    assert torch.equal(nk, kn.transpose(-1, -2))
    want = cpb.cpb_bias_nk_reference(grid_q, gkv, *w)
    assert nk.shape == want.shape
    assert (nk - want).abs().max().item() <= K2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("side,o", [(12, 1), (50, 2)])
def test_exact_nk_backward_kernel_matches_float64(dev, side, o):
    """K2-nk-bwd (the cotangent read query-major) against its plain version
    in float64 within 1e-3 norm-relative, bitwise equal over two calls and
    to K2-bwd on the transposed cotangent."""
    rng = np.random.default_rng(400 * side + o)
    grid_q = normalized_grid(side, side, dev).reshape(side * side, 2)
    gkv = _uniform(rng, 1.5, (8, 40, 2), dev)
    w = _mlp(rng, o, dev)
    shape = (8, side * side, 40) if o == 1 else (8, o, side * side, 40)
    dbias = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    before = _exact_launches()
    got = [cpb.cpb_bias_nk_backward(grid_q, gkv, *w, dbias) for _ in range(2)]
    kn = cpb.cpb_bias_transposed_backward(
        grid_q, gkv, *w, dbias.transpose(-1, -2).contiguous())
    assert _delta(before) == (0, 0, 1, 2, 0, 0)
    want = cpb.cpb_bias_nk_backward_reference(
        grid_q.double(), gkv.double(), *(t.double() for t in w),
        dbias.double())
    for a, b, c, ww in zip(*got, kn, want):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert a.shape == ww.shape and _rel(a, ww) <= K2_BWD_TOL


# (BH, K, N, O) at the edges of the K2 kernels' tiling: N against the
# backward's 128-point tile and the forward's 4 points a thread (N 1, 130,
# 2501), one kv point (K 1), kv rows (1 x 397) that do not split evenly
# over the backward's blocks, and O on every instance (1, 2, and the
# general path at 3 and MAX_OUT_CHANNELS 64)
_EXACT_EDGES = [(2, 3, 1, 1), (3, 7, 130, 3), (2, 5, 2501, 2),
                (4, 1, 130, 1), (1, 397, 130, 2), (2, 3, 129, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,k,n,o", _EXACT_EDGES)
def test_exact_kernels_at_the_tiling_edges(dev, bh, k, n, o):
    """K2 and K2-nk at shapes that leave partial tiles: the forwards within
    1e-4 of their plain versions, "nk" the "kn" bias transposed bitwise;
    K2-bwd against float64 within 1e-3, K2-nk-bwd bitwise equal to it on
    the transposed cotangent; one launch each."""
    rng = np.random.default_rng(500 + 7 * bh + 11 * k + n + o)
    grid_q = _uniform(rng, 1.0, (n, 2), dev)
    gkv = _uniform(rng, 1.5, (bh, k, 2), dev)
    w = _mlp(rng, o, dev)
    before = _exact_launches()
    with torch.inference_mode():
        kn = cpb.cpb_bias_transposed(grid_q, gkv, *w)
        nk = cpb.cpb_bias_nk(grid_q, gkv, *w)
    want = cpb.cpb_bias_transposed_reference(grid_q, gkv, *w)
    assert kn.shape == want.shape
    assert (kn - want).abs().max().item() <= K2_TOL
    assert torch.equal(nk, kn.transpose(-1, -2))
    dbias = torch.from_numpy(
        rng.normal(size=tuple(kn.shape)).astype(np.float32)).to(dev)
    got = cpb.cpb_bias_transposed_backward(grid_q, gkv, *w, dbias)
    got_nk = cpb.cpb_bias_nk_backward(grid_q, gkv, *w,
                                      dbias.transpose(-1, -2).contiguous())
    assert _delta(before) == (1, 1, 1, 1, 0, 0)
    want = cpb.cpb_bias_transposed_backward_reference(
        grid_q.double(), gkv.double(), *(t.double() for t in w),
        dbias.double())
    for a, b, ww in zip(got, got_nk, want):
        assert torch.equal(a, b)
        assert a.shape == ww.shape and _rel(a, ww) <= K2_BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [False, True])
def test_exact_backward_is_deterministic_at_an_odd_shape(dev, nk):
    """K2-bwd and K2-nk-bwd at BH 3 x K 7 x N 130, O = 3: two calls on the
    same inputs give bitwise-equal gradients (fixed-order sums, no
    atomics)."""
    rng = np.random.default_rng(600 + nk)
    grid_q = _uniform(rng, 1.0, (130, 2), dev)
    gkv = _uniform(rng, 1.5, (3, 7, 2), dev)
    w = _mlp(rng, 3, dev)
    shape = (3, 3, 130, 7) if nk else (3, 3, 7, 130)
    dbias = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    bwd = (cpb.cpb_bias_nk_backward if nk
           else cpb.cpb_bias_transposed_backward)
    first, second = (bwd(grid_q, gkv, *w, dbias) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _exact_attention_case(rng, dev, bh=4, k=144, side=50, d=64):
    """The teacher's per-head shapes (K = 144, N = 2500, D = 64), ``bh`` of
    its 32 batch-heads, kv points anywhere within the tanh bound."""
    n = side * side

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dev)

    return dict(q=rnd(bh, n, d, scale=d ** -0.5), k=rnd(bh, k, d),
                v=rnd(bh, k, d),
                grid_q=normalized_grid(side, side, dev).reshape(n, 2),
                gkv=_uniform(rng, cpb.kv_bound_2d(4.0, 12, 12), (bh, k, 2),
                             dev),
                w=_mlp(rng, 1, dev), g_out=rnd(bh, n, d), g_attn=rnd(bh, n, k))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_exact_kernel_matches_plain_version(dev, rate):
    """K7-fwd in both layouts against its plain version with the same
    dropout mask: out and attn within 1e-4 (K2's bias tolerance); "nk" and
    "kn" give the same out and the transposed map, bitwise; one launch
    each, no K2."""
    c = _exact_attention_case(np.random.default_rng(50), dev)
    args = (c["q"], c["k"], c["v"], c["grid_q"], c["gkv"], *c["w"])
    before = _exact_launches()
    with torch.inference_mode():
        got = {lay: fused_exact.fused_exact_attention(*args, 11, rate, lay)
               for lay in ("nk", "kn")}
    assert _delta(before) == (0, 0, 0, 0, 2, 0)
    assert torch.equal(got["nk"][0], got["kn"][0])
    assert torch.equal(got["nk"][1], got["kn"][1].transpose(1, 2))
    for lay, (out, attn) in got.items():
        want_out, want_attn = fused_exact.fused_exact_attention_reference(
            *args, 11, rate, lay)
        assert (attn - want_attn).abs().max().item() <= K2_TOL, lay
        assert (out - want_out).abs().max().item() <= K2_TOL, lay


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_exact_backward_kernel_matches_float64(dev, layout, rate):
    """K7-bwd (with the map's own cotangent) against the plain version's
    autograd in float64, norm-relative: dq, dk, dv within 2e-5, grid_kv and
    the CPB weights within 1e-3 (K2-bwd's tolerance), the CPB output bias,
    whose gradient is 0 in exact arithmetic (the softmax ignores a shift),
    below 1e-5 of its weight's; bitwise equal over two calls; one K7-bwd
    launch each, no K2-bwd count (its kernels run inside K7-bwd)."""
    c = _exact_attention_case(np.random.default_rng(51), dev)
    args = (c["q"], c["k"], c["v"], c["grid_q"], c["gkv"], *c["w"])
    g_attn = c["g_attn"] if layout == "nk" else c["g_attn"].transpose(
        1, 2).contiguous()
    with torch.inference_mode():
        _, attn = fused_exact.fused_exact_attention(*args, 5, rate, layout)
    before = _exact_launches()
    got = [fused_exact.fused_exact_attention_backward(
        *args, attn, c["g_out"], g_attn, 5, rate, layout) for _ in range(2)]
    assert _delta(before) == (0, 0, 0, 0, 0, 2)
    want = fused_exact.fused_exact_attention_backward_reference(
        *(a.double() for a in args), c["g_out"].double(), g_attn.double(), 5,
        rate, layout)
    errs = [_rel(g1, w64) for g1, w64 in zip(got[0], want)]
    assert all(torch.equal(g1, g2) for g1, g2 in zip(*got))
    assert all(e <= (K6_BWD_TOL if i < 3 else K2_BWD_TOL)
               for i, e in enumerate(errs[:9])), errs
    assert got[0][9].abs().max() <= 1e-5 * got[0][8].abs().max(), errs


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(161, 64), (300, 32), (625, 16)])
def test_fused_exact_kernels_take_any_k(dev, k, d):
    """K7 past one chunk of 160 kv points (a chunk of one row; 300; the 1-D
    attention's 625 at its head width 16), dropout 0.1, 16 batch-heads so
    that a backward block walks more than one query tile: forward as
    ``test_fused_exact_kernel_matches_plain_version``; backward against
    float64: dq, dk, dv within 2e-5, grid_kv and the weights within 1e-3
    or twice the f32 plain version's own error (the softmax's ds sums to 0
    per query, so the weight sums cancel), the CPB output bias below 1e-4
    of its weight's; bitwise equal over two calls."""
    c = _exact_attention_case(np.random.default_rng(53 + k), dev, bh=16,
                              k=k, side=24, d=d)
    args = (c["q"], c["k"], c["v"], c["grid_q"], c["gkv"], *c["w"])
    with torch.inference_mode():
        got = {lay: fused_exact.fused_exact_attention(*args, 9, 0.1, lay)
               for lay in ("nk", "kn")}
    assert torch.equal(got["nk"][0], got["kn"][0])
    assert torch.equal(got["nk"][1], got["kn"][1].transpose(1, 2))
    want_out, want_attn = fused_exact.fused_exact_attention_reference(
        *args, 9, 0.1)
    assert (got["nk"][1] - want_attn).abs().max().item() <= K2_TOL
    assert (got["nk"][0] - want_out).abs().max().item() <= K2_TOL
    for lay in ("nk", "kn"):
        g_attn = c["g_attn"] if lay == "nk" else c["g_attn"].transpose(
            1, 2).contiguous()
        bwd = [fused_exact.fused_exact_attention_backward(
            *args, got[lay][1], c["g_out"], g_attn, 9, 0.1, lay)
            for _ in range(2)]
        want = fused_exact.fused_exact_attention_backward_reference(
            *(a.double() for a in args), c["g_out"].double(),
            g_attn.double(), 9, 0.1, lay)
        plain = fused_exact.fused_exact_attention_backward_reference(
            *args, c["g_out"], g_attn, 9, 0.1, lay)
        assert all(torch.equal(g1, g2) for g1, g2 in zip(*bwd))
        for i in range(9):
            tol = K6_BWD_TOL if i < 3 else max(K2_BWD_TOL,
                                               2 * _rel(plain[i], want[i]))
            assert _rel(bwd[0][i], want[i]) <= tol, (lay, i)
        assert bwd[0][9].abs().max() <= 1e-4 * bwd[0][8].abs().max(), lay


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 9, 144, 160, 161, 625])
@pytest.mark.parametrize("d", [4, 12, 16, 64])
def test_fused_exact_forward_at_any_k_and_head_width(dev, k, d):
    """K7-fwd (3xTF32 products, the four-point bias) at one kv row, a
    partial m16 tile, the teacher's 144, one full chunk (160), a chunk and
    one row (161) and the 1-D attention's 625 (four chunks), at head widths
    that pad (4 and 12 to 8 and 16 for sim, 16 for PV) and do not, N = 169
    (odd: the "kn" map row by row; no multiple of the 8-query groups),
    dropout 0.1: out and attn within ``K2_TOL`` of the plain version, "nk"
    equal to "kn" transposed and two calls equal, bitwise; one launch each;
    K7-bwd on the "nk" map against float64 (dq, dk, dv within 2e-5, grid_kv
    and the weights within 1e-3 or twice the f32 plain version's own
    error)."""
    c = _exact_attention_case(np.random.default_rng(700 + k + d), dev, bh=6,
                              k=k, side=13, d=d)
    args = (c["q"], c["k"], c["v"], c["grid_q"], c["gkv"], *c["w"])
    before = _exact_launches()
    with torch.inference_mode():
        got = {lay: [fused_exact.fused_exact_attention(*args, 9, 0.1, lay)
                     for _ in range(2)] for lay in ("nk", "kn")}
    assert _delta(before) == (0, 0, 0, 0, 4, 0)
    for lay in ("nk", "kn"):
        assert all(torch.equal(a, b) for a, b in zip(*got[lay]))
    (out, attn), (out_kn, attn_kn) = got["nk"][0], got["kn"][0]
    assert torch.equal(out, out_kn) and torch.equal(attn,
                                                    attn_kn.transpose(1, 2))
    want_out, want_attn = fused_exact.fused_exact_attention_reference(
        *args, 9, 0.1)
    assert (attn - want_attn).abs().max().item() <= K2_TOL
    assert (out - want_out).abs().max().item() <= K2_TOL
    bwd = fused_exact.fused_exact_attention_backward(
        *args, attn, c["g_out"], c["g_attn"], 9, 0.1, "nk")
    want = fused_exact.fused_exact_attention_backward_reference(
        *(a.double() for a in args), c["g_out"].double(),
        c["g_attn"].double(), 9, 0.1, "nk")
    plain = fused_exact.fused_exact_attention_backward_reference(
        *args, c["g_out"], c["g_attn"], 9, 0.1, "nk")
    for i in range(9):
        tol = K6_BWD_TOL if i < 3 else max(K2_BWD_TOL,
                                           2 * _rel(plain[i], want[i]))
        assert _rel(bwd[i], want[i]) <= tol, i


@pytest.mark.cuda
def test_cuda_tensors_raise_where_the_kernels_cannot_build(dev, monkeypatch,
                                                          tmp_path):
    """With no kernel library and no ``nvcc`` to build one, K2-nk and K7 on
    CUDA tensors raise instead of running their plain versions."""
    from disentangled_multimodal_learning_tpu_torch.ops import build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    c = _exact_attention_case(np.random.default_rng(52), dev, bh=1, k=4,
                              side=8, d=8)
    before = _exact_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        cpb.cpb_bias_nk(c["grid_q"], c["gkv"], *c["w"])
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_exact.fused_exact_attention(c["q"], c["k"], c["v"], c["grid_q"],
                                          c["gkv"], *c["w"])
    assert _exact_launches() == before


@pytest.mark.cuda
def test_baselines_on_card_launch_no_kernel(dev):
    """Every baseline mode (``pathomic`` also with BilinearFusion) built on
    the card (fixdim 144, B=2, real widths) runs an f32 eval forward
    through plain torch: no wrapper of the port's kernels launches, and
    every output is finite and within 1e-4 of the CPU's with the same
    weights (TransMIL and CMTA included: their pinv stays within it at
    this size)."""
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        BASELINES)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    wrappers = [getattr(m, name) for m in (cpb, cpb1d, dpc_knn, fused_exact,
                                           fused_table)
                for name in dir(m) if hasattr(getattr(m, name), "launches")]
    assert len(wrappers) >= 16
    batch = SyntheticBagDataset(size=2, fixdim=144, seed=0).batch([0, 1])
    before = [w.launches for w in wrappers]
    for mode, kw in [(m, {}) for m in BASELINES] + [
            ("pathomic", {"fusion_type": "pofusion"})]:
        cfg = Config(mode=mode, fixdim=144, batch_size=2, **kw).validate()
        with torch.inference_mode():
            card = define_net(cfg, dev)(**model_inputs(batch, dev, mode))
            host = define_net(cfg, "cpu")(**model_inputs(batch, "cpu", mode))
        flat = [(a, b) for a, b in zip(_flat(card), _flat(host))]
        assert flat, mode
        for a, b in flat:
            assert torch.isfinite(a).all(), mode
            assert (a.cpu() - b).abs().max().item() <= FORWARD_TOL, mode
    assert [w.launches for w in wrappers] == before


def _flat(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return []


# ---- scan_steps: a chunk of train steps as one CUDA graph ----------------

# the graph's chunk against the eager chunk: bitwise, or within this factor
# of the eager chunks' largest spread of each other (grid_sample's backward
# adds with atomics, so the eager step does not repeat bitwise on the card;
# chip_smoke.py's REPEAT_FACTOR)
REPEAT_FACTOR = 4
# the graph against the default path (scan_steps 1): torch's capturable
# Adam and AdamW (the graph's) compute the bias corrections 1 - beta^t on
# the card in f32, the default ones in float64 on the host; beta2 = 0.999 is
# 0.99900001 in f32, so 1 - beta2^t is 1.3e-5 relative off and each update
# 6.4e-6, which the second step's gradient carries on (up to 2.0e-4 of a
# tensor's change over a chunk, measured on the H100).  An entry is held
# within REPEAT_FACTOR x the default runs' spread, plus OPT_RTOL of its
# tensor's largest change over the chunk, plus 2 roundings a step of its
# largest value (chip_smoke.py phase 5o's rule).  The schedule runs
# GRAPH_CHECK_STEPS_PER_EPOCH steps an epoch (a cosine over the 10 epochs'
# 10 steps), so that the lr moves 12% a step in the chunk: an lr or a bias
# correction a step off moves an update by 10% or more
OPT_RTOL = 1e-3
GRAPH_CHECK_STEPS_PER_EPOCH = 1


@pytest.mark.cuda
def test_fused_kernel_reads_its_seed_from_the_card(dev):
    """K6 with its dropout seed drawn on the card: at K 64 = D 64 with v
    the identity, ``out`` is the dropped map, so its nonzero entries are
    the kernel's mask, bitwise ``dropout_keep_mask`` of the same seed
    tensor; out and attn within K6's tolerances.  Captured with the seed's
    draw in a CUDA graph, two replays draw two seeds and drop by each."""
    c = _fused_case(np.random.default_rng(42), dev, bh=4, k=64, d=64)
    v = torch.eye(64, device=dev).expand(4, 64, 64).contiguous()
    shape = (4, 64, 2500)

    def call(seed):
        return fused_table.fused_table_attention(
            c["q"], c["k"], v, c["table"], c["shifts"], 50, seed, 0.1)

    seed = torch.randint(0, 2 ** 31 - 1, (), device=dev)
    with torch.inference_mode():
        out, attn = call(seed)
    want_out, want_attn = fused_table.fused_table_attention_reference(
        c["q"], c["k"], v, c["table"], c["shifts"], 50, seed, 0.1)
    assert torch.equal(out.transpose(1, 2) != 0,
                       fused_table.dropout_keep_mask(seed, shape, 0.1, dev))
    assert (attn - want_attn).abs().max().item() <= K6_ATTN_TOL
    assert (out - want_out).abs().max().item() <= K6_OUT_TOL
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_seed = torch.randint(0, 2 ** 31 - 1, (), device=dev)
        g_out, _ = call(g_seed)
    seeds, masks = [], []
    for _ in range(2):
        graph.replay()
        seeds.append(int(g_seed))
        masks.append(g_out.transpose(1, 2) != 0)
        assert torch.equal(masks[-1], fused_table.dropout_keep_mask(
            g_seed, shape, 0.1, dev))
    assert seeds[0] != seeds[1] and not torch.equal(*masks)


def _graph_chunk_case(dev, mode="teacher", **kw):
    """A small teacher (fixdim 64, B 2, divisor 1; or another ``mode``) on
    the card with the capturable optimizer, as ``run_training`` trains at
    ``scan_steps`` 2: the warm-up chunk run as single steps, then a runner
    of chunks of 2 steps as graphs: ``(runner, step, model, optimizer,
    scheduler, key, chunk, cfg)``, ``step`` the single step (the schedule
    stepped after it)."""
    from disentangled_multimodal_learning_tpu_torch.train.graph_chunk import (
        ChunkRunner)
    from disentangled_multimodal_learning_tpu_torch.train.trainers import (
        make_step)

    cfg = Config(mode=mode, fixdim=64, batch_size=2, cpb_table_divisor=1,
                 **kw).validate()
    ds = SyntheticBagDataset(size=4, fixdim=64, label_dim=4, seed=0)
    chunk = [batch_to_tensors(ds.batch([2 * i, 2 * i + 1]), dev)
             for i in range(2)]
    model = define_net(cfg, dev)
    opt = make_optimizer(cfg, model.parameters(), capturable=True)
    sched = make_scheduler(cfg, opt, GRAPH_CHECK_STEPS_PER_EPOCH)
    step_fn = make_step(cfg, model, opt, None)[0]

    def step(tensors):
        metrics = step_fn(tensors)
        sched.step()
        return metrics

    for tensors in chunk:
        step(tensors)
    runner = ChunkRunner(step_fn, opt, sched, 2)
    key = tuple(chunk[0]["x_path10"].shape)
    return runner, step, model, opt, sched, key, chunk, cfg


def _chunk_state(model, opt):
    out = dict(model.state_dict())
    for name, p in model.named_parameters():
        out.update((f"opt.{name}.{k}", v) for k, v in opt.state[p].items()
                   if isinstance(v, torch.Tensor))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd", "adagrad"])
def test_graph_chunk_matches_the_eager_chunk(dev, optimizer):
    """One chunk of 2 ``deterministic_training`` steps from one snapshot as
    the graph (its capture and replay; the snapshot restored in place: the
    graph holds the addresses), and as 2 single steps of the same
    capturable optimizer (the trainer's first chunk of a shape, and its
    leftovers), each against three runs of 2 steps of the default path
    (``scan_steps`` 1: ``make_optimizer`` without ``capturable``, its
    ``LambdaLR`` stepped after each step): every entry within
    ``OPT_RTOL``'s rule of the closest run.  Compared: the parameters, the
    optimizer's moments and step counts, the schedule's count and the
    losses; a parameter and its state where its gradient is not 0 in
    exact arithmetic and, under Adam and AdamW, its rms is above 1e-6 (100
    x AdamW's eps: below it an AdamW step is the gradient's rounding
    residue, a full-size step of either sign, as
    ``tests/torch_parallel_cases.py`` holds it), SGD's momentum where it is
    above 1e-6.  The graph replays each
    optimizer's capturable form: AdamW and Adam torch's, SGD and Adagrad
    the port's rules with a tensor lr."""
    import copy

    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        keep_capturable, set_schedule_count)
    from disentangled_multimodal_learning_tpu_torch.train.trainers import (
        make_step)

    runner, step, model, opt, sched, key, chunk, cfg = _graph_chunk_case(
        dev, deterministic_training=True, optimizer=optimizer)
    snap = {k: v.detach().clone() for k, v in _chunk_state(model, opt).items()}
    saved, count = copy.deepcopy(opt.state_dict()), sched.last_epoch
    plain = make_optimizer(cfg, model.parameters())
    plain_sched = make_scheduler(cfg, plain, GRAPH_CHECK_STEPS_PER_EPOCH)
    plain_step = make_step(cfg, model, plain, plain_sched)[0]

    def result(optimizer, scheduler, ms):
        out = {k: v.detach().to(dev, copy=True)
               for k, v in _chunk_state(model, optimizer).items()}
        out.update((f"loss{i}", m["loss"]) for i, m in enumerate(ms))
        out["count"] = torch.tensor(float(scheduler.last_epoch), device=dev)
        return out

    def from_snapshot(run):
        with torch.no_grad():
            for k, v in _chunk_state(model, opt).items():
                v.copy_(snap[k])
        set_schedule_count(sched, opt, count)
        return result(opt, sched, run())

    def default_chunk():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(snap[k])
        # a copy: the loader keeps the tensors it is given
        plain.load_state_dict(copy.deepcopy(saved))
        keep_capturable(plain, [False] * len(plain.param_groups))
        set_schedule_count(plain_sched, plain, count)
        return result(plain, plain_sched, [plain_step(t) for t in chunk])

    def diff(x, y):
        d = [(x[k].float() - y[k].float())[masks.get(k, ...)] for k in x]
        return max(t.abs().max().item() for t in d if t.numel())

    def share(x, ref):
        """The largest share of an entry's tolerance (OPT_RTOL's rule) and
        its tensor."""
        worst = (0.0, None)
        for k, want in ref.items():
            m = masks.get(k, ...)
            if not want[m].numel():
                continue
            if k.startswith("loss"):
                change = (ref["loss1"] - ref["loss0"]).abs()
            elif k in snap:
                change = (want.float() - snap[k].float())[m].abs().max()
            else:
                change = torch.zeros(())
            tol = (REPEAT_FACTOR * spread + OPT_RTOL * float(change)
                   + 4 * 2.0 ** -23 * want.float()[m].abs().max().item())
            err = (x[k].float() - want.float())[m].abs().max().item()
            share = err / tol if tol else (0.0 if err == 0 else math.inf)
            worst = max(worst, (share, k), key=lambda sk: sk[0])
        return worst

    default = [default_chunk() for _ in range(3)]
    masks = {}
    for name, p in model.named_parameters():
        # not where the gradient is 0 in exact arithmetic: the CPB output
        # bias (a softmax ignores a shift), the TransFusion MHA's q and k
        # rows (it attends to one kv token, a softmax of one score is 1)
        m = torch.ones_like(p, dtype=torch.bool)
        if name.endswith("rel_pos_bias.mlp.2.bias"):
            m[...] = False
        elif ".transfusion_layer" in name and ".in_proj_" in name:
            m[:2 * p.shape[0] // 3] = False
        v = default[0].get(f"opt.{name}.exp_avg_sq")
        if v is not None:
            m &= (v / (1 - 0.999 ** 2)).sqrt() > 1e-6
        v = default[0].get(f"opt.{name}.momentum_buffer")
        if v is not None:  # SGD's running sum of gradients
            masks[f"opt.{name}.momentum_buffer"] = m & (v.abs() > 1e-6)
        masks.update((k, m) for k in default[0] if k not in masks
                     and (k == name or k.startswith(f"opt.{name}."))
                     and default[0][k].shape == m.shape)
    single = from_snapshot(lambda: [step(t) for t in chunk])
    graph = from_snapshot(lambda: runner.run(key, chunk))
    assert runner.captures == runner.replays == 1
    spread = max(diff(x, y) for i, x in enumerate(default)
                 for y in default[i + 1:])
    worst = {name: min((share(run, e) for e in default),
                       key=lambda sk: sk[0])
             for name, run in (("graph", graph), ("single steps", single))}
    print(f"{optimizer}: the default runs' spread {spread:.3e}; to the "
          f"default path {min(diff(graph, e) for e in default):.3e}, the "
          f"largest share of an entry's tolerance {worst}")
    assert max(share for share, _ in worst.values()) <= 1, worst


@pytest.mark.cuda
def test_graph_replays_count_their_launches(dev):
    """A wrapper counts where its Python runs, and a capture runs no
    kernel: the capture's counts are taken out and added again at each
    replay, so that a capture with its replay, and each replay after it,
    count 2 steps' launches (K1-fwd 4 and K1-bwd 4 a step), as 2 single
    steps do; the losses are finite."""
    from disentangled_multimodal_learning_tpu_torch.ops import launches

    runner, step, _, _, _, key, chunk, _ = _graph_chunk_case(dev)
    def single_steps():
        return [step(t) for t in chunk]

    def replay():
        return runner.run(key, chunk)

    got, losses = [], []
    for run in (single_steps, replay, replay):
        launches.reset()
        ms = run()
        torch.cuda.synchronize()
        got.append(launches.counts())
        losses.append([m["loss"].item() for m in ms])
    want = dict.fromkeys(launches.WRAPPERS, 0)
    want.update(k1_fwd=8, k1_bwd=8)
    assert got == [want] * 3
    assert runner.captures == 1 and runner.replays == 2
    graph = runner.graphs[key]
    assert graph.captured == {"k1_fwd": 8, "k1_bwd": 8}
    assert all(map(math.isfinite, sum(losses, [])))


# a step's marks, in order (utils/profiling.py), and how far the marks'
# sums may sit from the times they add up to
STEP_MARKS = ("step.start", "step.loss", "step.optimizer", "step.end")
MARKS_RTOL = 0.05


@pytest.mark.cuda
def test_graph_replay_marks_time_each_step(dev):
    """The step marks captured into a chunk's graph (2 steps, 8 timed
    events) are read back after each replay: a replay's ``chunk`` span
    holds, for each step, forward + backward + optimizer within 5% of the
    step's start-to-end time, each part above 0; the 2 steps' sum within
    5% of CUDA events recorded around a replay of the graph alone.  No
    replay that finished before the next began is left unresolved, and
    with tracing off a replay records no span."""
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    runner, _, _, _, _, key, chunk, _ = _graph_chunk_case(dev)
    profiling.enable(False)
    profiling.reset()
    runner.run(key, chunk)  # the capture and its replay, tracing off
    torch.cuda.synchronize()
    g = runner.graphs[key]
    assert [name for name, _ in g.marks] == list(STEP_MARKS) * 2
    assert [s.name for s in profiling.spans()] == ["setup.capture"]
    profiling.enable(True)
    try:
        for _ in range(3):
            runner.run(key, chunk)
            torch.cuda.synchronize()
        replays = [s for s in profiling.spans() if s.name == "chunk"]
        before, after = (torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
        before.record()
        g.graph.replay()
        after.record()
        torch.cuda.synchronize()
        whole = before.elapsed_time(after)
        first = g.marks[0][1]
        alone = [first.elapsed_time(ev) for _, ev in g.marks]
    finally:
        profiling.enable(False)
    assert len(replays) == 3 and runner.replays == 4
    assert profiling.unresolved() == 0 and profiling.dropped() == 0
    for s in replays:
        assert [name for name, _ in s.marks] == list(STEP_MARKS) * 2
        t = [ms for _, ms in s.marks]
        for i in range(0, len(t), 4):
            parts = [t[i + 1] - t[i], t[i + 2] - t[i + 1], t[i + 3] - t[i + 2]]
            assert all(p > 0 for p in parts), parts
            assert sum(parts) == pytest.approx(t[i + 3] - t[i],
                                               rel=MARKS_RTOL)
    steps = sum(alone[i + 3] - alone[i] for i in range(0, len(alone), 4))
    print(f"replay {whole:.4f} ms, its 2 steps {steps:.4f} ms")
    assert steps == pytest.approx(whole, rel=MARKS_RTOL)
    profiling.reset()


# the Nystrom cores' layer marks in a TransMIL step of the capture: each
# layer's forward, then each layer's backward, the last layer's first
CORE_MARKS = (["nystrom.fwd.start", "nystrom.fwd.end"] * 2
              + ["nystrom.bwd.start", "nystrom.bwd.end"] * 2)


@pytest.mark.cuda
def test_graph_replay_marks_the_nystrom_cores(dev):
    """A TransMIL chunk of 2 steps captured into a graph: the capture keeps
    each step's 4 step marks in one unbroken run and the cores' layer marks
    apart (those of the backward made on the autograd engine's thread);
    each traced replay's marks resolve, its step marks form the runs that
    ``bench_port/spans.py mark_steps`` matches, the cores' marked ms of
    each update lie within its forward plus backward, and each replay
    adds the capture's 4 core calls (2 layers a step) to the count and
    to its ``chunk`` span."""
    from bench_port import cores, spans
    from disentangled_multimodal_learning_tpu_torch.ops import launches
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    runner, _, _, _, _, key, chunk, _ = _graph_chunk_case(dev, "transmil")
    profiling.enable(False)
    profiling.reset()
    calls = launches.core_calls()["nystrom"]
    runner.run(key, chunk)  # the capture and its replay
    torch.cuda.synchronize()
    g = runner.graphs[key]
    assert g.core_calls == {"nystrom": 4} and g.captured == {}
    assert launches.core_calls()["nystrom"] == calls + 4
    assert [name for name, _ in g.marks] == list(STEP_MARKS) * 2
    assert [name for name, _ in g.marks.layer] == CORE_MARKS * 2
    profiling.enable(True)
    try:
        for _ in range(3):
            runner.run(key, chunk)
        torch.cuda.synchronize()
        replays = [s for s in profiling.spans() if s.name == "chunk"]
    finally:
        profiling.enable(False)
    assert launches.core_calls()["nystrom"] == calls + 16
    assert len(replays) == 3
    assert profiling.unresolved() == 0 and profiling.dropped() == 0
    for s in replays:
        assert s.counts["nystrom_calls"] == 4
        steps = spans.mark_steps([s], spans.STEP_MARKS)
        assert len(steps) == 2
        assert [name for name, _ in s.layer_marks] == CORE_MARKS * 2
        per_update = cores.update_ms(s)
        for (fwd, bwd, _), core in zip(steps, per_update):
            assert 0 < core <= fwd + bwd, (core, fwd, bwd)
    profiling.reset()


# the staged batches' bag (the preset's 2,500 patches, a quarter of its
# 1024 features) and what the card does before the staging: about a second
# of nothing on the current stream
STAGED_BAG, STAGED_SLEEP_CYCLES = (4, 2500, 256), 2 * 10 ** 9


def _host_batch(rng, bag=STAGED_BAG):
    def f32(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    b = bag[0]
    return Batch(x_path10=f32(*bag), x_path20=f32(*bag),
                 x_omic=f32(b, 431), x_omic_tumor=f32(b, 59),
                 x_omic_immune=f32(b, 361),
                 label=rng.integers(0, 4, (b, 12), dtype=np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["overwritten", "replays"])
def test_batches_staged_to_the_card(dev, case):
    """``batch_to_tensors`` on the card (pinned memory, its copy stream).

    ``overwritten``: two rounds of 2K (K = 2) distinct batches, each
    staged while the current stream still sleeps and each host array
    overwritten right after its call; a round's tensors are stacked on the
    current stream and dropped before the next round is staged.  Every
    stack holds the original arrays bit for bit, labels as int64: the
    second round's copies did not reuse the blocks the first round's
    stacks, still queued, read.  ``replays``: 20 chunks run back to back
    through ``ChunkRunner.run`` with tracing on, each staged just before
    it: no replay is left unresolved, and each ``chunk`` span holds its 4K
    step marks and the host's ``waited_us``.  In both, every ``h2d``
    span's ``staged`` is its ``bytes``.  (The staged chunk against the
    eager steps and the default path:
    ``test_graph_chunk_matches_the_eager_chunk``, whose chunk is
    staged.)"""
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    fields = ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune",
              "x_omic", "label")
    profiling.reset()
    profiling.enable(True)
    try:
        if case == "overwritten":
            rng = np.random.default_rng(0)
            want, stacks = [], []
            torch.cuda._sleep(STAGED_SLEEP_CYCLES)
            for _ in range(2):
                staged = []
                for _ in range(4):
                    batch = _host_batch(rng)
                    want.append({k: getattr(batch, k).copy() for k in fields})
                    staged.append(batch_to_tensors(batch, dev))
                    for k in fields:
                        getattr(batch, k)[...] = -1
                stacks.append({k: torch.stack([t[k] for t in staged])
                               for k in fields})
                del staged
            torch.cuda.synchronize()
            got = [{k: s[k][i].cpu() for k in fields}
                   for s in stacks for i in range(4)]
            for w, g in zip(want, got):
                for k in fields:
                    assert g[k].dtype == (torch.int64 if k == "label"
                                          else torch.float32), k
                    assert torch.equal(g[k], torch.from_numpy(w[k]).to(
                        g[k].dtype)), k
            n_h2d, n_chunks = 8, 0
        else:
            runner, _, _, _, _, key, chunk, _ = _graph_chunk_case(dev)
            runner.run(key, chunk)  # the capture and its replay
            torch.cuda.synchronize()
            profiling.reset()
            ds = SyntheticBagDataset(size=4, fixdim=64, label_dim=4, seed=0)
            for c in range(20):
                runner.run(key, [batch_to_tensors(
                    ds.batch([2 * ((c + i) % 2), 2 * ((c + i) % 2) + 1]), dev)
                    for i in range(2)])
            torch.cuda.synchronize()
            n_h2d, n_chunks = 40, 20
    finally:
        profiling.enable(False)
    spans = profiling.spans()
    assert profiling.unresolved() == 0 and profiling.dropped() == 0
    h2d = [s for s in spans if s.name == "h2d"]
    chunks = [s for s in spans if s.name == "chunk"]
    assert len(h2d) == n_h2d and len(chunks) == n_chunks
    assert all(s.counts["staged"] == s.counts["bytes"] > 0 for s in h2d)
    for s in chunks:
        assert [name for name, _ in s.marks] == list(STEP_MARKS) * 2
        assert s.counts["waited_us"] >= 0
    if chunks:
        print(f"host waits before the replays: "
              f"{[s.counts['waited_us'] for s in chunks]} us")
    profiling.reset()


# an eval batch of 4 of the preset's bags (2,500 patches of 1,024
# features): each bag's field is 10.2 MB, so staging copies it a bag a
# slice
EVAL_BAG = (4, 2500, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["teacher", "student", "deformpathomic",
                                  "transmil", "omic"])
def test_model_inputs_staged_to_the_card(dev, mode):
    """``model_inputs`` on the card, for each distinct field set of
    ``MODEL_INPUTS``: two rounds staged while the copy stream sleeps behind
    a kernel, each host array overwritten right after its call.  Every
    tensor holds its original array bit for bit: the fills completed
    before the call returned, and the second round's did not reuse the
    pinned blocks that the first round's copies, still queued, read.
    Each ``h2d`` span's ``staged`` is its ``bytes``.  Under the profiler
    every host-to-device copy is pinned, a field of 4 bags is copied in
    4 slices and every other field in one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disentangled_multimodal_learning_tpu_torch.train import steps
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    fields = steps.MODEL_INPUTS[mode]
    rng = np.random.default_rng(1)
    want, got = [], []
    copy = steps._copy_stream(
        torch.device("cuda", torch.cuda.current_device()))
    profiling.reset()
    profiling.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(copy):
                torch.cuda._sleep(STAGED_SLEEP_CYCLES)
            for _ in range(2):
                batch = _host_batch(rng, EVAL_BAG)
                want.append({k: getattr(batch, k).copy()
                             for k in fields.values()})
                got.append(model_inputs(batch, dev, mode))
                for k in fields.values():
                    getattr(batch, k)[...] = -1
            torch.cuda.synchronize()
    finally:
        profiling.enable(False)
    for w, g in zip(want, got):
        assert sorted(g) == sorted(fields)
        for arg, key in fields.items():
            assert g[arg].device.type == "cuda", arg
            assert torch.equal(g[arg].cpu(), torch.from_numpy(w[key])), arg
    h2d = [s for s in profiling.spans() if s.name == "h2d"]
    assert len(h2d) == 2
    assert all(s.counts["staged"] == s.counts["bytes"] == sum(
        w[k].nbytes for k in fields.values()) > 0 for s in h2d)
    copies = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and e.name().startswith("Memcpy HtoD")]
    assert all("Pinned" in name for name in copies), set(copies)
    assert len(copies) == 2 * sum(EVAL_BAG[0] if w[k].ndim == 3 else 1
                                  for k in fields.values())
    profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_evaluator_step_matches_a_plain_copy(dev, mode):
    """``Evaluator.step`` of the teacher and the student on a batch of 4
    of the preset's bags (staged a bag a slice) returns logits bitwise
    equal to the same model's forward on inputs copied by a plain
    ``.to(device)``."""
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        Evaluator)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        MODEL_INPUTS)

    cfg = Config(mode=mode, fixdim=EVAL_BAG[1], batch_size=EVAL_BAG[0],
                 cpb_table_divisor=1).validate()
    model = define_net(cfg, dev).eval()
    batch = SyntheticBagDataset(size=EVAL_BAG[0], fixdim=EVAL_BAG[1],
                                label_dim=4, seed=0).batch(
        list(range(EVAL_BAG[0])))
    got = Evaluator(model, cfg, dev, mode).step(batch)
    with torch.inference_mode():
        out = model(**{arg: torch.from_numpy(getattr(batch, key)).to(dev)
                       for arg, key in MODEL_INPUTS[mode].items()})
    want = {k: v.float().cpu().numpy() for k, v in out[2].items()}
    assert sorted(got) == sorted(want) and len(want) == 3
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.cuda
def test_eval_forward_marks_read_inside_the_batch(dev):
    """With tracing on, ``Evaluator.step`` records an ``eval_batch`` span,
    its ``h2d`` inside it, and the forward's marks, which read more than 0
    and less than the batch's wall time."""
    import time

    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        Evaluator)
    from disentangled_multimodal_learning_tpu_torch.utils import profiling

    cfg = Config(mode="teacher", fixdim=64, batch_size=2,
                 cpb_table_divisor=1).validate()
    model = define_net(cfg, dev).eval()
    evaluator = Evaluator(model, cfg, dev, "teacher")
    batch = SyntheticBagDataset(size=2, fixdim=64, label_dim=4,
                                seed=0).batch([0, 1])
    evaluator.step(batch)  # the warm-up
    profiling.reset()
    profiling.enable(True)
    try:
        t0 = time.perf_counter()
        evaluator.step(batch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        profiling.enable(False)
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("eval_batch", -1),
                                                  ("h2d", 0)]
    assert got[1].counts["staged"] == got[1].counts["bytes"] > 0
    marks = dict(got[0].marks)
    forward = marks["forward.end"] - marks["forward.start"]
    print(f"forward {forward:.4f} ms of a {wall_ms:.4f} ms batch")
    assert 0 < forward < wall_ms
    profiling.reset()


@pytest.mark.cuda
def test_restored_capturable_optimizer_keeps_its_step_on_the_card(dev):
    """The capturable AdamW of ``scan_steps`` on the card restored from a
    payload that a default AdamW wrote (its step counts on the CPU, its
    groups not capturable), and from a JAX payload's Adam moments: its
    groups stay capturable, every step count lies on the card, and a step
    with a tensor lr runs."""
    from disentangled_multimodal_learning_tpu_torch.utils.checkpoint import (
        restore_state)

    cfg = Config(mode="omic", fixdim=16, batch_size=2).validate()
    model = define_net(cfg, dev)
    plain = make_optimizer(cfg, model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    plain.step()
    names = [n for n, _ in model.named_parameters()]
    payloads = [
        {"params": model.state_dict(), "opt_state": plain.state_dict(),
         "step": 1},
        {"params": model.state_dict(), "step": 3, "jax_opt_state": {
            "kind": "adam", "count": 3, "schedule_count": 3,
            "learning_rate": None, "moments": {
                n: {"exp_avg": np.zeros(p.shape, np.float32),
                    "exp_avg_sq": np.ones(p.shape, np.float32)}
                for n, p in zip(names, model.parameters())}}}]
    for payload in payloads:
        opt = make_optimizer(cfg, model.parameters(), capturable=True)
        sched = make_scheduler(cfg, opt, 10)
        restore_state(model, opt, sched, payload)
        assert all(g["capturable"] for g in opt.param_groups)
        assert all(opt.state[p]["step"].device == p.device
                   for p in model.parameters())
        for g in opt.param_groups:
            g["lr"] = torch.tensor(1e-4, device=dev)
        opt.step()
        torch.cuda.synchronize()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``disentangled_multimodal_learning_tpu_torch`` (never JAX) through its
serving entry and its training entry, for the teacher, the student and
deformpathomic, at the full width of ``config/config_mine_diag2021.yaml``
(fixdim 2500, B=4, dims 128, 8 heads; the student with ``path_cluster_num``
0.0008, 2 clusters per bag; deformpathomic at ``attn_dim`` 1, where the cls
token makes N = 2501 and the 1-D attention K = 625, and at ``attn_dim`` 2
with ``return_vgrid``) with seeded random weights:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, run
   together) and holds each forward kernel against its plain PyTorch
   version on the card at production shapes:
   K1 (table CPB, R=4608, side=50, tn=139, clipped rows included) within
   1e-5 abs, K2 (exact CPB, BH=32, K=144, N=2500, O=1 and O=2) within 1e-4
   abs on a bias of O(1) (FMA contraction and another sum order);
2b. holds K1-bwd (same shapes) and K2-bwd (O=1 and O=2) against their plain
   versions in float64 on the card, norm-relative (``K1_BWD_TOL``,
   ``K2_BWD_TOL``, with the f32 plain version's own error printed beside
   the kernel's), and checks that two calls give bitwise-equal results;
3. runs the inference entry at the preset (divisor 1, bf16 streams) over 3
   batches: K1 launches 4x per batch, K2 never, all logits finite;
4. runs it for 1 batch at ``cpb_table_divisor=0``: K2 launches, K1 never;
3b. runs the training entry at the preset (1 fold, 12 synthetic bags = 3
   steps of B=4, dropout and gradient modulation on, then the final
   evaluation of 4 bags): K1-fwd 4x per step and per eval batch, K1-bwd 4x
   per step, K2 never, every loss finite; then 1 step at divisor 0: K2-fwd
   and K2-bwd the same way, K1 never;
5. compares one f32 batch (bf16 streams off) on the card with the same
   weights on the CPU through the plain versions, within 1e-4 abs on the
   logits (f32 end to end; cuBLAS/cuDNN and the CPU sum in other orders);
5b. compares one ``deterministic_training`` step in f32 on the card with
   the same step on the CPU: the loss within ``STEP_LOSS_TOL``, every
   parameter's gradient after modulation within ``GRAD_TOL`` rel-L2;
6. times each forward kernel against its plain version and the eval
   forward (bags/s) with CUDA events, after warm-up (K1 also with the L2
   cache flushed before each call, since its 46 MB output fits the 50 MB
   L2), and prints a torch.profiler table of the preset forward with the
   device's idle share;
6b. times each backward kernel against the plain backward (autograd
   through the plain forward, its graph kept by ``retain_graph``), the
   train step (bags/s, median and p80 of 30 steps) at divisor 1 and 0, and
   profiles one train step (device-busy share);
2c. holds K3-knn and K3-parent (the streamed DPC-KNN passes) against their
   plain versions at B=4, N=2500, C=128, k=5 on LayerNormed random tokens
   and on bags whose second half repeats one vector of +-1 entries (its
   distances are exactly 0 in any summation order, so the ties are exact),
   within ``K3_TOL_ULPS * C * 2^-24 * max|x|^2`` (the f32 plain version's
   own error against float64 printed beside), and the whole assignment
   (centres and clusters) against the plain version on the CPU, exactly;
3c. runs the student serving entry at the preset (3 batches: per batch
   K3-knn 2, K3-parent 2, K1-fwd 2, K2 0) and at divisor 0 (1 batch: K2-fwd
   2, K1 0), and the student training entry (3 steps and 1 eval batch: per
   step K3 2 + 2, K1-fwd 2, K1-bwd 2);
5c. compares one f32 student forward (logits within 1e-4) and one f32
   ``deterministic_training`` student step on the card with the CPU;
6c. times K3 against its plain versions and the student's eval forward and
   train step (bags/s, median and p80), and profiles one student train
   step (device-busy share);
2d. holds K4-fwd (the 1-D table CPB, R = 10,000 rows of B=4 x G=4 x K=625,
   O=2, n_q=2501, clipped rows included) against its plain version within
   ``K4_TOL`` abs, and K4-bwd against its plain version in float64 within
   ``K4_BWD_TOL`` norm-relative, bitwise equal over two calls; then K2 at
   the shape the 1-D attention gives it at divisor 0 (16 x 625 x 2501,
   O=2, the coordinate padded to 2) the same way, within ``K2_TOL`` and
   ``K2_BWD_TOL``;
3d. runs the deformpathomic serving entry at attn_dim 1 (divisor 1: K4-fwd
   2 per batch, 3 batches; divisor 0: K2-fwd 2, 1 batch) and at attn_dim 2
   with return_vgrid (K1-fwd 2, 1 batch), and the training entry at the
   same three settings (per step the forward kernel 2 and its backward 2;
   3 steps at attn_dim 1 divisor 1, 1 step at the others), exact counts;
5d. compares f32 deformpathomic forwards (logits within ``LOGITS_TOL``)
   and one f32 ``deterministic_training`` step on the card with the CPU,
   at attn_dim 1 (divisor 1 and 0) and at attn_dim 2 with return_vgrid;
6d. times K4 and K2 at the 1-D shape (O=2) against their plain versions,
   with their bounds, the deformpathomic eval forward and train step of
   each setting (bags/s, median and p80), and profiles one forward and one
   train step of each (device-busy share).

The main paths (the inference entry and the training entry) each run at
the preset's divisor 1 and at the ``Config`` default divisor 0, every count
set to 0 just before a run and read just after.  In the kernels line the
``launches`` are those of the training runs (K1 and K2: the teacher's at
divisor 1 and 0; K3: the student's at the preset; K4: deformpathomic's at
attn_dim 1, divisor 1), and K2's ``max_abs_err`` is the larger of its
errors at the 2-D and the 1-D shape.  Launches made for comparisons and
timings are not counted.  Each kernel's ``bound_ms`` is the larger of
its bytes (each input read once, each output written once) over 3.35 TB/s
and its flops over 67 TFLOP/s (f32 outside the tensor cores), counted from
this run's inputs (H100 SXM data sheet); ``library_ms`` is null for all
eight: no single PyTorch call computes any of their functions.
Any failure raises: there is no fallback and no phase is caught.  Exits
non-zero without a result line when there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K1_TOL = 1e-5
K2_TOL = 1e-4
LOGITS_TOL = 1e-4
# backward kernels, norm-relative against float64 plain versions on the
# card.  K1: the shift cotangents are per-row sums of 2.5 k terms that
# cancel (measured 2.9e-6 on the H100, the f32 plain version 4.1e-6);
# dtable sums ~620 terms per entry (measured 2.0e-7).  K2: with random
# cotangents the 11.5 M-point sums cancel, and a point whose relu input is
# within f32 rounding of 0 takes the other branch than in float64, so f32
# itself is 1e-4 to 5e-4 off (measured at O=2: the kernel up to 4.5e-4,
# the f32 plain version up to 4.0e-4); 1e-3 keeps a margin over both.
K1_BWD_TOL = {"dtable": 1e-5, "dfracs": 1e-5}
K2_BWD_TOL = {"dgrid_kv": 1e-3, "dw": 1e-3}
# one train step on the card against the CPU (f32 both): cuBLAS, cuDNN and
# the kernels sum in other orders than the CPU.  The task loss (CE) within
# 1e-5 relative; the total loss adds the attention consistency loss, 1e4 x
# the variance of near-equal Gram diagonals, whose cancellation amplifies
# the maps' f32 differences (measured 7.6e-5 relative on the total loss),
# hence 5e-4.  Gradients: the CPB hidden biases sum cotangents that nearly
# cancel (the softmax over kv ignores a shift; measured up to 1.3e-3
# rel-L2, all other leaves below 5e-4), hence 5e-3.  The CPB output biases,
# whose gradient is 0 in exact arithmetic, are only checked to be below
# 1e-5 of their weights' gradient.
TASK_LOSS_TOL = 1e-5
STEP_LOSS_TOL = 5e-4
GRAD_TOL = 5e-3
# K3: the kernel sums each C-term dot in another order than cuBLAS.  Each
# f32 sum is within C 2^-24 max|x|^2 of the exact dot (to first order, by
# Cauchy-Schwarz), so two of them differ by at most twice that, and d2 =
# ... - 2 dot by four times: 3.9e-3 for LayerNormed 128-d tokens, whose
# distances reach 512.  (Measured errors are far smaller; the f32 plain
# version's own error against float64 is printed beside.)
K3_TOL_ULPS = 4
# the student step on the card against the CPU (f32 both): the task loss as
# the teacher's; the total loss adds 1000 x path_batch_loss, a sum of
# squared differences of near-equal normalized Grams, whose cancellation
# amplifies the maps' f32 differences as the teacher's consistency loss
# does, hence STEP_LOSS_TOL; gradients as the teacher's, the two biases
# whose gradient is 0 in exact arithmetic checked for being small: below
# ZERO_GRAD_FLOOR of their weights' gradient.  In deformpathomic's 1-D
# attention (K = 625) the CPB output bias sums 25 M cotangents per channel
# that cancel only in exact arithmetic; their f32 residue reached 3.8e-5
# of the weight gradient on the H100 and 2.7e-5 on the CPU, through K4 and
# through K2 alike (this step at full width), hence ZERO_GRAD_FLOOR_1D
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias")
ZERO_GRAD_FLOOR, ZERO_GRAD_FLOOR_1D = 1e-5, 1e-4
# K4: the kernel rounds the two-term lerp op by op as its plain version
# does, so it should agree bitwise; 1e-6 abs is the stated bound.  K4-bwd
# against float64: the shift cotangents sum 5,002 terms d * (T[i+1] - T[i])
# and the table entries ~4,000 contributions each, in f32
K4_TOL = 1e-6
K4_BWD_TOL = {"dtable": 1e-5, "dshifts": 1e-5}
HBM_BYTES_PER_MS = 3.35e9     # 3.35 TB/s
F32_FLOPS_PER_MS = 67e9       # 67 TFLOP/s outside the tensor cores
CSRC = "disentangled_multimodal_learning_tpu_torch/csrc"
TABLE_SRC = f"{CSRC}/cpb_table.cu"
EXACT_SRC = f"{CSRC}/cpb_exact.cu"
DPC_SRC = f"{CSRC}/dpc_knn.cu"
TABLE1D_SRC = f"{CSRC}/cpb_table_1d.cu"
# phase 5d's f32 deformpathomic settings (the preset's divisor 1 unless named)
DEFORMPATHOMIC_F32 = ({"attn_dim": 1}, {"attn_dim": 1, "cpb_table_divisor": 0},
                      {"attn_dim": 2, "return_vgrid": True})
PALLAS = "disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py"
PALLAS_DPC = "disentangled_multimodal_learning_tpu/ops/pallas/dpc_knn.py"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU (the CPU side of phases 5 and 5b runs on it): its
    architecture, core count and the vector ISA torch's CPU kernels use."""
    import os
    import platform

    import torch

    return (f"{platform.machine()} {platform.processor() or ''} "
            f"{os.cpu_count()} cores, torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ms_samples(fn, n: int, warmup: int = 3, flush=None) -> list[float]:
    """Per-call device times (CUDA events around each call, one
    synchronize at the end), sorted.  With ``flush``, that buffer is
    written before each call, outside the events, to empty the L2 cache."""
    import torch

    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in ev)


def median(sorted_ms: list[float]) -> float:
    return sorted_ms[len(sorted_ms) // 2]


def interleaved_ms(plain, kernel, iters: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain; the smaller of each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return min(k1, k2), min(p1, p2)


def mlp_weights(o: int, gen, device):
    import torch

    hid = 32

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return (rnd(2, hid, scale=2 ** -0.5), rnd(hid, scale=0.1),
            rnd(hid, hid, scale=hid ** -0.5), rnd(hid, scale=0.1),
            rnd(hid, o, scale=hid ** -0.5), rnd(o, scale=0.1))


def _wrappers():
    from disentangled_multimodal_learning_tpu_torch.ops import cpb, cpb1d, dpc_knn

    return {"k1_fwd": cpb.table_interp,
            "k1_bwd": cpb.table_interp_backward,
            "k2_fwd": cpb.cpb_bias_transposed,
            "k2_bwd": cpb.cpb_bias_transposed_backward,
            "k3_knn": dpc_knn.knn_stream,
            "k3_parent": dpc_knn.parent_stream,
            "k4_fwd": cpb1d.table1d_interp,
            "k4_bwd": cpb1d.table1d_interp_backward}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def expect(**per_key) -> dict:
    """Every kernel's count: the given ones, 0 for the others."""
    return {k: per_key.get(k, 0) for k in _wrappers()}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of the card for the work: ``(ms, bound_by)``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_fwd_flops(points: int, o: int, hid: int = 32) -> int:
    """K2-fwd's multiply-adds (2 flops each) over ``points`` (kv, query)
    pairs: the MLP 2 -> hid -> hid -> o."""
    return points * 2 * (2 * hid + hid * hid + hid * o)


def k2_bwd_flops(points: int, o: int, hid: int = 32) -> int:
    """K2-bwd's: the forward recomputed, then w3 (dz2), the w2 product
    (dz1), the dW2 outer product and w1 (the kv coordinates' cotangent)."""
    return k2_fwd_flops(points, o, hid) + points * 2 * (
        hid * o + 2 * hid * hid + 2 * hid)


def rel_err(got, want) -> float:
    """Norm-relative error of ``got`` against the float64 ``want``."""
    return ((got.double() - want).norm() / want.norm()).item()


def check_backward_kernels(cpb, dev, card: str, bh: int = 32,
                           k: int = 144) -> dict:
    """Phase 2b: K1-bwd at R=4608, side 50, tn 139 with clipped rows, and
    K2-bwd at 32x144x2500 with O=1 and O=2, each against its plain version
    in float64 on the card (the f32 plain version's own error printed
    beside it), and each called twice to show that it is deterministic.
    Returns the inputs (for the timings) and the errors."""
    import torch

    gen = torch.Generator().manual_seed(1)
    side, BH, K = 50, bh, k
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    w = mlp_weights(1, gen, dev)
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound)
    gkv = ((torch.rand(BH, K, 2, generator=gen) * 2 - 1)
           * kv_bound * 1.25).to(dev)
    taps, fracs = cpb.table_taps(cpb.table_shifts(gkv, side=side,
                                                  kv_bound=kv_bound),
                                 side=side, tn=table.shape[0])
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    R = taps.shape[0]
    dout = torch.randn(R, side, side, generator=gen).to(dev)
    k1 = [cpb.table_interp_backward(table, taps, fracs, dout, side)
          for _ in range(2)]
    torch.cuda.synchronize()
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), side)
    plain = cpb.table_interp_backward_reference(table, taps, fracs, dout, side)
    k1_det = all(torch.equal(a, b) for a, b in zip(*k1))
    errs = {name: (rel_err(g, ww), rel_err(p, ww))
            for name, g, p, ww in zip(("dtable", "dfracs"), k1[0], plain,
                                      want)}
    k1_abs = max((g.double() - ww).abs().max().item()
                 for g, ww in zip(k1[0], want))
    clipped_dfracs = k1[0][1][clipped].abs().max().item()
    for name, (e, pe) in errs.items():
        print(f"[K1-bwd] R={R} side={side} tn={table.shape[0]} "
              f"{name}: rel err vs f64 kernel {e:.3e}, f32 plain {pe:.3e} "
              f"(tol {K1_BWD_TOL[name]}) | {card}")
    print(f"[K1-bwd] clipped rows={int(clipped.sum())}, their max |dfracs| "
          f"{clipped_dfracs:.3e}; deterministic (2 calls bitwise equal): "
          f"{k1_det}; max_abs_err {k1_abs:.3e}")
    if (table.shape[0] != 139 or not clipped.any() or not k1_det
            or not clipped_dfracs > 0
            or not all(e <= K1_BWD_TOL[n] for n, (e, _) in errs.items())):
        raise RuntimeError("K1-bwd disagrees with its plain version or is "
                           "not deterministic")

    grid_q = normalized_grid_flat(side, dev)
    gkv2 = ((torch.rand(BH, K, 2, generator=gen) * 2 - 1)
            * kv_bound).to(dev)
    k2_abs, k2_inputs = 0.0, {}
    names = ("dgrid_kv", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    for o in (1, 2):
        wo = w if o == 1 else mlp_weights(2, gen, dev)
        shape = (BH, K, side * side) if o == 1 else (BH, o, K, side * side)
        dbias = torch.randn(shape, generator=gen).to(dev)
        k2 = [cpb.cpb_bias_transposed_backward(grid_q, gkv2, *wo, dbias)
              for _ in range(2)]
        torch.cuda.synchronize()
        k2_det = all(torch.equal(a, b) for a, b in zip(*k2))
        want = cpb.cpb_bias_transposed_backward_reference(
            grid_q.double(), gkv2.double(), *(t.double() for t in wo),
            dbias.double())
        plain = cpb.cpb_bias_transposed_backward_reference(
            grid_q, gkv2, *wo, dbias)
        errs = {n: (rel_err(g, ww), rel_err(p, ww))
                for n, g, p, ww in zip(names, k2[0], plain, want)}
        del plain
        k2_abs = max([k2_abs] + [(g.double() - ww).abs().max().item()
                                 for g, ww in zip(k2[0], want)])
        del want
        print(f"[K2-bwd] BH={BH} K={K} N={side * side} O={o} rel err vs "
              "f64, kernel / f32 plain: " + ", ".join(
                  f"{n} {e:.2e} / {pe:.2e}" for n, (e, pe) in errs.items())
              + f"; deterministic: {k2_det} | {card}")
        tol = {n: K2_BWD_TOL["dgrid_kv" if n == "dgrid_kv" else "dw"]
               for n in names}
        if not k2_det or not all(e <= tol[n] for n, (e, _) in errs.items()):
            raise RuntimeError("K2-bwd disagrees with its plain version or "
                               "is not deterministic")
        if o == 1:
            k2_inputs = dict(grid_q=grid_q, gkv=gkv2, w=wo, dbias=dbias)
        torch.cuda.empty_cache()
    print(f"[K2-bwd] max_abs_err {k2_abs:.3e}")
    return dict(k1=dict(table=table, taps=taps, fracs=fracs, dout=dout,
                        side=side, err=k1_abs),
                k2=dict(k2_inputs, err=k2_abs))


def normalized_grid_flat(side: int, dev):
    from disentangled_multimodal_learning_tpu_torch.models.deform_attention import (
        normalized_grid)

    return normalized_grid(side, side, dev).reshape(side * side, 2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch.config import Config
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net, full_f32_matmuls)
    from disentangled_multimodal_learning_tpu_torch.ops import build, cpb
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    dev = torch.device("cuda")
    # ---- phase 1: the card ------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; host CPU {host_cpu()}")
    full_f32_matmuls()

    # ---- phase 2: build, then each kernel against its plain version ------
    t0 = time.perf_counter()
    build.kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {build.library_dir()}")
    for line in build.build_log().splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    side, B, H, K = 50, 4, 8, 144
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    w = mlp_weights(1, gen, dev)
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound)
    # 25% past the bound, so that some rows clip and extrapolate
    gkv = ((torch.rand(B * H, K, 2, generator=gen) * 2 - 1)
           * kv_bound * 1.25).to(dev)
    taps, fracs = cpb.table_taps(cpb.table_shifts(gkv, side=side,
                                                  kv_bound=kv_bound),
                                 side=side, tn=table.shape[0])
    n_clipped = int(((fracs < 0) | (fracs > 1)).any(dim=1).sum())
    with torch.inference_mode():
        k1 = cpb.table_interp(table, taps, fracs, side)
        k1_ref = cpb.table_interp_reference(table, taps, fracs, side)
    torch.cuda.synchronize()
    k1_err = (k1 - k1_ref).abs().max().item()
    print(f"[K1] R={taps.shape[0]} side={side} tn={table.shape[0]} "
          f"clipped rows={n_clipped} max_abs_err={k1_err:.3e} (tol {K1_TOL})")
    if table.shape[0] != 139 or n_clipped == 0 or not k1_err <= K1_TOL:
        raise RuntimeError("K1 disagrees with its plain version")

    grid_q = normalized_grid_flat(side, dev)
    gkv2 = ((torch.rand(B * H, K, 2, generator=gen) * 2 - 1) * kv_bound).to(dev)
    k2_err = {}
    for o in (1, 2):
        wo = w if o == 1 else mlp_weights(2, gen, dev)
        with torch.inference_mode():
            got = cpb.cpb_bias_transposed(grid_q, gkv2, *wo)
            want = cpb.cpb_bias_transposed_reference(grid_q, gkv2, *wo)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"K2 shape {tuple(got.shape)} != "
                               f"{tuple(want.shape)}")
        k2_err[o] = (got - want).abs().max().item()
        print(f"[K2] BH={B * H} K={K} N={side * side} O={o} "
              f"bias range [{want.min().item():.3f}, {want.max().item():.3f}] "
              f"max_abs_err={k2_err[o]:.3e} (tol {K2_TOL})")
        if not k2_err[o] <= K2_TOL:
            raise RuntimeError("K2 disagrees with its plain version")

    # ---- phase 2b: the backward kernels against float64 ------------------
    bwd = check_backward_kernels(cpb, dev, card)
    torch.cuda.empty_cache()

    # ---- phase 2c: K3 against its plain versions, the assignment exactly -
    dpc = check_dpc_kernels(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 3: the serving entry at the preset (divisor 1, bf16) ------
    preset = Config.diag2021().replace(synthetic_data=True,
                                       synthetic_test_size=3 * 4)
    reset_counts()
    t0 = time.perf_counter()
    metrics, logits = inference.main(preset, device=dev)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    n = counts()
    print(f"[main] serving, divisor 1, bf16 streams: 3 batches in "
          f"{t_main:.2f} s (data generation and first-call set-up included);"
          f" launches {n}")
    check_outputs(metrics, logits, 12)
    if n != expect(k1_fwd=4 * 3):
        raise RuntimeError("the preset run did not go through K1 alone, "
                           "4 launches per batch")

    # ---- phase 4: one batch at the exact CPB (divisor 0) -----------------
    exact = preset.replace(cpb_table_divisor=0, synthetic_test_size=4)
    reset_counts()
    metrics0, logits0 = inference.main(exact, device=dev)
    torch.cuda.synchronize()
    n = counts()
    print(f"[main] serving, divisor 0: launches {n}")
    check_outputs(metrics0, logits0, 4)
    if n != expect(k2_fwd=4):
        raise RuntimeError("the divisor-0 run did not go through K2 alone")

    # ---- phase 3b: the training entry at the preset, then divisor 0 ------
    train_preset = Config.diag2021().replace(
        synthetic_data=True, synthetic_train_size=3 * 4,
        synthetic_test_size=4, kfold=1, epochs=1, checkpoints="#")
    train_counts = {
        "k1": run_training_entry(train_preset, dev, 3,
                                 dict(k1_fwd=4, k1_bwd=4), dict(k1_fwd=4),
                                 card),
        "k2": run_training_entry(
            train_preset.replace(cpb_table_divisor=0, synthetic_train_size=4),
            dev, 1, dict(k2_fwd=4, k2_bwd=4), dict(k2_fwd=4), card)}
    torch.cuda.empty_cache()

    # ---- phase 3c: the student's serving and training entries ----------
    student = preset.replace(mode="student")
    for cfg, batches, per_batch in (
            (student, 3, dict(k1_fwd=2, k3_knn=2, k3_parent=2)),
            (student.replace(cpb_table_divisor=0, synthetic_test_size=4), 1,
             dict(k2_fwd=2, k3_knn=2, k3_parent=2))):
        reset_counts()
        t0 = time.perf_counter()
        metrics_s, logits_s = inference.main(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts()
        print(f"[main] student serving, divisor {cfg.cpb_table_divisor}: "
              f"{batches} batches in {wall:.2f} s (set-up included); "
              f"launches {n}")
        check_outputs(metrics_s, logits_s, 4 * batches)
        want = expect(**{k: v * batches for k, v in per_batch.items()})
        if n != want:
            raise RuntimeError(f"student serving: launches {n}, want {want}")
    student_train = train_preset.replace(mode="student")
    train_counts["k3"] = run_training_entry(
        student_train, dev, 3, dict(k1_fwd=2, k1_bwd=2, k3_knn=2, k3_parent=2),
        dict(k1_fwd=2, k3_knn=2, k3_parent=2), card)
    torch.cuda.empty_cache()

    # ---- phase 5: f32 on the card vs the same weights on the CPU ---------
    f32 = preset.replace(attn_bf16_streams=False)
    batch = next(iter(inference.build_fold0_test_loader(f32)))
    with torch.inference_mode():
        card_out = define_net(f32, dev)(
            **model_inputs(batch, dev, "teacher"))[2]
        cpu_out = define_net(f32, "cpu")(
            **model_inputs(batch, "cpu", "teacher"))[2]
    errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
            for k in cpu_out}
    err = max(errs.values())
    print(f"[f32] card vs CPU logits max_abs_err={err:.3e} (tol {LOGITS_TOL})"
          f"; per output {errs}")
    if not err <= LOGITS_TOL:
        for name, out in (("card", card_out), ("cpu", cpu_out)):
            conf = [torch.softmax(out[f"logits_tea{s}"].float().cpu(), 1)
                    .amax(1).tolist() for s in ("10", "20")]
            print(f"[f32] {name} max-confidence tea10 {conf[0]} tea20 "
                  f"{conf[1]}; logits {out['logits_teas'].cpu().tolist()}")
    if not err <= LOGITS_TOL:
        raise RuntimeError("f32 logits on the card disagree with the CPU")

    # ---- phase 5b: one f32 train step on the card vs on the CPU ----------
    compare_train_step(f32.replace(deterministic_training=True), batch, dev)

    # ---- phase 5c: the student in f32, card vs CPU -----------------------
    s32 = f32.replace(mode="student")
    with torch.inference_mode():
        card_out = define_net(s32, dev)(
            **model_inputs(batch, dev, "student"))[2]
        cpu_out = define_net(s32, "cpu")(
            **model_inputs(batch, "cpu", "student"))[2]
    errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
            for k in cpu_out}
    print(f"[f32] student card vs CPU logits max_abs_err "
          f"{max(errs.values()):.3e} (tol {LOGITS_TOL}); per output {errs}")
    if not max(errs.values()) <= LOGITS_TOL:
        raise RuntimeError("f32 student logits on the card disagree with "
                           "the CPU")
    compare_train_step(s32.replace(deterministic_training=True), batch, dev)
    torch.cuda.empty_cache()

    # ---- phase 6: timings -------------------------------------------------
    with torch.inference_mode():
        k1_ms, k1_plain = interleaved_ms(
            lambda: cpb.table_interp_reference(table, taps, fracs, side),
            lambda: cpb.table_interp(table, taps, fracs, side), 50)
        k2_ms, k2_plain = interleaved_ms(
            lambda: cpb.cpb_bias_transposed_reference(grid_q, gkv2, *w),
            lambda: cpb.cpb_bias_transposed(grid_q, gkv2, *w), 20)
        # bytes and flops counted from the shapes; peaks: 3.35 TB/s HBM,
        # 67 TFLOP/s f32 outside the tensor cores (H100 SXM data sheet)
        k1_bytes = taps.shape[0] * side * side * 4
        k2_flops = k2_fwd_flops(gkv2.shape[0] * K * side * side, 1)
        print(f"[time] K1 table_interp R=4608 side=50: kernel {k1_ms:.4f} ms,"
              f" plain {k1_plain:.4f} ms; {k1_bytes / k1_ms / 1e9:.3f} TB/s "
              f"written = {k1_bytes / k1_ms / 1e9 / 3.35:.1%} of 3.35 TB/s "
              f"| {card}")
        flush = torch.empty(32 * 2 ** 20, device=dev)  # 128 MB > 50 MB L2
        k1_cold = median(ms_samples(
            lambda: cpb.table_interp(table, taps, fracs, side), 50,
            flush=flush))
        k1_plain_cold = median(ms_samples(
            lambda: cpb.table_interp_reference(table, taps, fracs, side), 20,
            flush=flush))
        del flush
        print(f"[time] K1 table_interp R=4608 side=50, L2 flushed before "
              f"each call (median): kernel {k1_cold:.4f} ms, plain "
              f"{k1_plain_cold:.4f} ms; {k1_bytes / k1_cold / 1e9:.3f} TB/s "
              f"written | {card}")
        print(f"[time] K2 cpb_bias_transposed 32x144x2500: kernel "
              f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms; "
              f"{k2_flops / k2_ms / 1e9:.2f} TFLOP/s = "
              f"{k2_flops / k2_ms / 1e9 / 67:.1%} of 67 TFLOP/s f32 | {card}")
        for cfg in (preset, preset.replace(cpb_table_divisor=0)):
            model = define_net(cfg, dev)
            x = model_inputs(batch, dev, "teacher")
            ms = ms_samples(lambda: model(**x), 50)
            med, p80 = median(ms), ms[int(0.8 * len(ms))]
            print(f"[time] eval forward B=4 fixdim=2500 divisor "
                  f"{cfg.cpb_table_divisor} bf16_streams "
                  f"{cfg.attn_bf16_streams}: median {med:.3f} ms/batch = "
                  f"{4000.0 / med:.1f} bags/s, p80 {p80:.3f} ms "
                  f"(50 forwards) | {card}")
        model = define_net(preset, dev)
        x = model_inputs(batch, dev, "teacher")
        profile("eval forward", lambda: model(**x))

    # ---- phase 6b: backward kernels and the train step -------------------
    bwd_ms = time_backward_kernels(cpb, bwd, card)
    time_train_steps((train_preset, train_preset.replace(cpb_table_divisor=0),
                      train_preset), batch, dev, card)

    # ---- phase 6c: K3 and the student ------------------------------------
    dpc_ms = time_dpc_kernels(dpc, card)
    with torch.inference_mode():
        model = define_net(student, dev)
        x = model_inputs(batch, dev, "student")
        ms = ms_samples(lambda: model(**x), 50)
        print(f"[time] student eval forward B=4 fixdim=2500 divisor 1 "
              f"bf16_streams True: median {median(ms):.3f} ms/batch = "
              f"{4000.0 / median(ms):.1f} bags/s, p80 "
              f"{ms[int(0.8 * len(ms))]:.3f} ms = "
              f"{4000.0 / ms[int(0.8 * len(ms))]:.1f} bags/s (50 forwards) "
              f"| {card}")
        del model
    time_train_steps((student_train,), batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phase 2d: K4, and K2 at the 1-D shape, against plain versions ---
    k4 = check_table1d_kernels(dev, card)
    torch.cuda.empty_cache()
    k2_1d = check_exact_1d_kernels(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 3d: deformpathomic's serving and training entries --------
    train_counts["k4"] = run_deformpathomic_entries(preset, train_preset, dev,
                                                    card)
    torch.cuda.empty_cache()

    # ---- phase 5d: deformpathomic in f32, card vs CPU --------------------
    for cfg in DEFORMPATHOMIC_F32:
        c32 = f32.replace(mode="deformpathomic", **cfg)
        with torch.inference_mode():
            card_out = define_net(c32, dev)(
                **model_inputs(batch, dev, "deformpathomic"))
            cpu_out = define_net(c32, "cpu")(
                **model_inputs(batch, "cpu", "deformpathomic"))
        errs = [(a.cpu() - b).abs().max().item() for a, b in
                zip(list(card_out[:3]) + list(card_out[3]),
                    list(cpu_out[:3]) + list(cpu_out[3]))]
        print(f"[f32] deformpathomic {cfg} card vs CPU: features, vectors "
              f"and logits max_abs_err {max(errs):.3e} (tol {LOGITS_TOL}); "
              f"per output {[f'{e:.2e}' for e in errs]}")
        if not max(errs) <= LOGITS_TOL:
            raise RuntimeError("f32 deformpathomic outputs on the card "
                               "disagree with the CPU")
        del card_out, cpu_out
        compare_train_step(c32.replace(deterministic_training=True), batch,
                           dev)
        torch.cuda.empty_cache()

    # ---- phase 6d: K4 and deformpathomic timings ------------------------
    k4_ms = time_table1d_kernels(k4, k2_1d, card)
    time_deformpathomic(preset, train_preset, batch, dev, card)

    print(json.dumps({"kernels": kernel_line(
        train_counts, dict(k1=k1_err, k2=max(*k2_err.values(), k2_1d["err"]),
                           k1_bwd=bwd["k1"]["err"],
                           k2_bwd=max(bwd["k2"]["err"], k2_1d["bwd_err"]),
                           k3=dpc["err"], k4=k4["err"], k4_bwd=k4["bwd_err"]),
        dict(k1=(k1_ms, k1_plain), k2=(k2_ms, k2_plain),
             k1_bwd=bwd_ms["k1"], k2_bwd=bwd_ms["k2"], **dpc_ms, **k4_ms),
        dict(table=table, taps=taps, fracs=fracs, side=side, gkv=gkv2,
             w=w, n=side * side), bwd, dpc, k4)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_line(launches, errs, times, fwd, bwd, dpc, k4) -> list[dict]:
    """The kernels JSON line: each kernel's launches in its training run,
    its error against its plain version, its time and its plain version's,
    and its bound from this run's inputs (bytes: inputs read once, outputs
    written once; flops: the MLP's or the dot products' multiply-adds as
    2 each)."""
    side, n = fwd["side"], fwd["n"]
    R = fwd["taps"].shape[0]
    tbl = 4 * (fwd["table"].numel() + 4 * R)  # table, taps, fracs
    k1_bound = bound(tbl + 4 * R * side * side, 9 * R * side * side)
    k1b = bwd["k1"]
    k1b_bytes = 4 * (2 * k1b["table"].numel() + 6 * k1b["taps"].shape[0]
                     + k1b["dout"].numel())
    k1b_bound = bound(k1b_bytes, 16 * k1b["dout"].numel())
    points = fwd["gkv"].shape[0] * fwd["gkv"].shape[1] * n
    k2_bound = bound(4 * (points + 2 * n + fwd["gkv"].numel()),
                     k2_fwd_flops(points, 1))
    k2b = bwd["k2"]
    bpoints = k2b["dbias"].numel()
    k2b_bound = bound(4 * (bpoints + 2 * k2b["gkv"].numel() + 2 * n),
                      k2_bwd_flops(bpoints, 1))
    B, N, C = dpc["x"].shape
    dots = 2 * B * N * N * C
    x_bytes = 4 * (B * N * C + B * N)  # x and x2
    k3k_bound = bound(x_bytes + 4 * B * N * (dpc["k"] + 1), dots)
    k3p_bound = bound(x_bytes + 4 * B * N * 2, dots)
    # K4: the bias written once (fwd) or its cotangent read once (bwd), the
    # table, taps and fractions read once; 3 flops per output (two products,
    # a sum), 7 per cotangent element (the scatter's two products and two
    # sums, the shift term's difference, product and sum)
    k4_out = k4["out_numel"]
    k4_small = 4 * (k4["table"].numel() + 2 * k4["taps"].shape[0])
    k4_bound = bound(4 * k4_out + k4_small, 3 * k4_out)
    k4b_bound = bound(4 * k4_out + k4_small + 4 * (k4["table"].numel()
                                                   + k4["taps"].shape[0]),
                      7 * k4_out)
    rows = [
        ("cpb_table_interp_fwd (K1-fwd)", TABLE_SRC, f"{PALLAS}:2158",
         launches["k1"]["k1_fwd"], errs["k1"], times["k1"], k1_bound),
        ("cpb_table_interp_bwd (K1-bwd)", f"{CSRC}/cpb_table_bwd.cu",
         f"{PALLAS}:2186", launches["k1"]["k1_bwd"], errs["k1_bwd"],
         times["k1_bwd"], k1b_bound),
        ("cpb_exact_fwd (K2-fwd)", EXACT_SRC, f"{PALLAS}:1422",
         launches["k2"]["k2_fwd"], errs["k2"], times["k2"], k2_bound),
        ("cpb_exact_bwd (K2-bwd)", f"{CSRC}/cpb_exact_bwd.cu",
         f"{PALLAS}:1443", launches["k2"]["k2_bwd"], errs["k2_bwd"],
         times["k2_bwd"], k2b_bound),
        ("dpc_knn (K3-knn)", DPC_SRC, f"{PALLAS_DPC}:93",
         launches["k3"]["k3_knn"], errs["k3"], times["k3_knn"], k3k_bound),
        ("dpc_parent (K3-parent)", DPC_SRC, f"{PALLAS_DPC}:111",
         launches["k3"]["k3_parent"], errs["k3"], times["k3_parent"],
         k3p_bound),
        ("cpb_table_1d_fwd (K4-fwd)", TABLE1D_SRC, f"{PALLAS}:2434",
         launches["k4"]["k4_fwd"], errs["k4"], times["k4_fwd"], k4_bound),
        ("cpb_table_1d_bwd (K4-bwd)", f"{CSRC}/cpb_table_1d_bwd.cu",
         f"{PALLAS}:2450", launches["k4"]["k4_bwd"], errs["k4_bwd"],
         times["k4_bwd"], k4b_bound),
    ]
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": nl, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bms, "bound_by": by, "library_ms": None}
            for name, src, rep, nl, err, (ms, plain), (bms, by) in rows]


def check_dpc_kernels(dev, card: str) -> dict:
    """Phase 2c: K3-knn and K3-parent at B=4, N=2500, C=128, k=5 against
    their plain versions on the card (f32) and in float64, on LayerNormed
    random tokens and on the same bags with their second half one repeated
    vector; then the assignment (2 clusters) on the card against the
    plain version on the CPU, exactly."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cluster, dpc_knn

    B, N, C, k = 4, 2500, 128, 5
    gen = torch.Generator().manual_seed(2)
    x = torch.nn.functional.layer_norm(torch.randn(B, N, C, generator=gen),
                                       (C,))
    repeated = x.clone()
    repeated[:, N // 2:] = (torch.randint(0, 2, (C,), generator=gen) * 2
                            - 1).float()
    noise = torch.rand(B, N, generator=gen)
    err, timed = 0.0, None
    for case, xh in (("random", x), ("repeated half", repeated)):
        xd = xh.to(dev)
        x2 = (xd * xd).sum(-1)
        knn2, rmax2 = dpc_knn.knn_stream(xd, x2, k)
        density = (torch.exp(-knn2.clamp_min(1e-12).mean(-1) / C)
                   + noise.to(dev) * 1e-6)
        parent2 = dpc_knn.parent_stream(xd, x2, density)
        torch.cuda.synchronize()
        plain = dpc_knn.knn_stream_reference(xd, x2, k) + (
            dpc_knn.parent_stream_reference(xd, x2, density),)
        x64 = xd.double()
        x2_64 = (x64 * x64).sum(-1)
        f64 = dpc_knn.knn_stream_reference(x64, x2_64, k) + (
            dpc_knn.parent_stream_reference(x64, x2_64, density.double()),)
        tol = K3_TOL_ULPS * C * 2.0 ** -24 * x2.max().item()
        for name, got, p, want in zip(("knn2", "rowmax2", "parent2"),
                                      (knn2, rmax2, parent2), plain, f64):
            real = want < 1e37  # the no-parent sentinel compared apart
            e = (got - p).abs().max().item()
            e64 = (got.double() - want)[real].abs().max().item()
            p64 = (p.double() - want)[real].abs().max().item()
            same_sentinels = torch.equal(got >= 1e37, p >= 1e37)
            print(f"[K3] {case} B={B} N={N} C={C} k={k} {name}: kernel vs "
                  f"plain max_abs_err {e:.3e} (tol {tol:.3e}); vs float64: "
                  f"kernel {e64:.3e}, f32 plain {p64:.3e}; no-parent "
                  f"tokens {int((~real).sum())}, the same: {same_sentinels}"
                  f" | {card}")
            if not e <= tol or not same_sentinels:
                raise RuntimeError(f"K3 {name} disagrees with its plain "
                                   "version")
            err = max(err, e)
        card_idx, card_centers = cluster.dpc_knn_cluster(
            xd, 2, k, density_noise=noise.to(dev))
        host_idx, host_centers = cluster.dpc_knn_cluster(
            xh, 2, k, density_noise=noise)
        same = (torch.equal(card_centers.cpu(), host_centers)
                and torch.equal(card_idx.cpu(), host_idx))
        print(f"[K3] {case}: centres on the card {card_centers.tolist()}, "
              f"plain on the CPU {host_centers.tolist()}; index_down and "
              f"idx_cluster identical: {same}")
        if not same:
            raise RuntimeError("the assignment on the card differs from the "
                               "plain version's")
        if timed is None:
            timed = dict(x=xd, x2=x2, density=density, k=k)
    return dict(timed, err=err)


def time_dpc_kernels(dpc: dict, card: str) -> dict:
    """Phase 6c: K3-knn and K3-parent against their plain versions on the
    random bags of phase 2c."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import dpc_knn

    x, x2, density, k = dpc["x"], dpc["x2"], dpc["density"], dpc["k"]
    B, N, C = x.shape
    flops = 2 * B * N * N * C
    out = {}
    with torch.inference_mode():
        out["k3_knn"] = interleaved_ms(
            lambda: dpc_knn.knn_stream_reference(x, x2, k),
            lambda: dpc_knn.knn_stream(x, x2, k), 20)
        out["k3_parent"] = interleaved_ms(
            lambda: dpc_knn.parent_stream_reference(x, x2, density),
            lambda: dpc_knn.parent_stream(x, x2, density), 20)
    for name, (ms, plain) in out.items():
        print(f"[time] {name} B={B} N={N} C={C}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms; {flops / ms / 1e9:.2f} TFLOP/s = "
              f"{flops / ms / 1e9 / 67:.1%} of 67 TFLOP/s f32 | {card}")
    torch.cuda.empty_cache()
    return out


def run_training_entry(cfg, dev, steps: int, per_step: dict,
                       per_eval: dict, card: str):
    """Phases 3b and 3c: the training entry (``main.main``) for one fold;
    every count set to 0 just before, read just after, and held to
    ``per_step`` launches per train step and ``per_eval`` per eval batch
    (0 for every kernel not named)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch import main as train_main

    reset_counts()
    t0 = time.perf_counter()
    results = train_main.main(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    final = results[0]
    losses = final["train_losses"]
    eval_batches = -(-cfg.synthetic_test_size // cfg.batch_size)
    want = expect(**{k: per_step.get(k, 0) * steps
                     + per_eval.get(k, 0) * eval_batches
                     for k in set(per_step) | set(per_eval)})
    print(f"[train] entry, {setting(cfg)}: {len(losses)} steps + "
          f"{eval_batches} eval batch in {wall:.2f} s (data generation and "
          f"first-call set-up included); losses {losses}; launches {n} "
          f"| {card}")
    if (len(losses) != steps or not all(map(math.isfinite, losses))
            or not all(math.isfinite(final[k]) for k in
                       ("acc", "auc", "f1"))):
        raise RuntimeError(f"training entry: bad losses or metrics {final}")
    if n != want:
        raise RuntimeError(f"training entry: launches {n}, want {want}")
    return n


def compare_train_step(cfg, batch, dev) -> None:
    """Phases 5b and 5c: one ``deterministic_training`` f32 step of
    ``cfg.mode`` from the same seeded weights on the same batch, on the
    card and on the CPU."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    out = {}
    for device in (dev, "cpu"):
        model = define_net(cfg, device)
        step = make_train_step(model, cfg, make_optimizer(
            cfg, model.parameters()))
        m = step(batch_to_tensors(batch, device))
        task_key = "loss3" if cfg.mode == "deformpathomic" else "taskloss"
        out[device] = ((m["loss"].item(), m[task_key].item()),
                       {name: p.grad.double().cpu()
                        for name, p in model.named_parameters()})
    ((loss_card, task_card), g_card), ((loss_cpu, task_cpu), g_cpu) = (
        out[dev], out["cpu"])
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    task_err = abs(task_card - task_cpu) / abs(task_cpu)
    errs, bias_ok, bias_ratio = {}, True, 0.0
    for name, want in g_cpu.items():
        got = g_card[name]
        if name.endswith(ZERO_GRAD_BIASES):
            rel = ZERO_GRAD_FLOOR_1D if ".attn1d." in name else ZERO_GRAD_FLOOR
            scale = g_cpu[name[:-4] + "weight"].abs().max().item()
            ratio = max(got.abs().max().item(), want.abs().max().item()) / scale
            bias_ok &= ratio <= rel
            bias_ratio = max(bias_ratio, ratio)
            continue
        # the MaxNets' classifiers get a zero gradient on both sides
        errs[name] = ((got - want).norm()
                      / max(want.norm().item(), 1e-30)).item()
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"[f32 step] {setting(cfg)}: card task loss "
          f"{task_card:.7f} vs CPU {task_cpu:.7f} (rel {task_err:.2e}, tol "
          f"{TASK_LOSS_TOL}); loss {loss_card:.7f} vs {loss_cpu:.7f} (rel "
          f"{loss_err:.2e}, tol {STEP_LOSS_TOL}); {len(errs)} gradients, "
          f"worst rel-L2 {worst} (tol {GRAD_TOL}); zero-gradient biases at "
          f"most {bias_ratio:.2e} of their weights' gradient, below their "
          f"floor: {bias_ok} | {card_line()}")
    if (not loss_err <= STEP_LOSS_TOL or not task_err <= TASK_LOSS_TOL
            or not bias_ok
            or not all(e <= GRAD_TOL for e in errs.values())):
        raise RuntimeError("the f32 train step on the card disagrees with "
                           "the CPU")


def time_backward_kernels(cpb, bwd: dict, card: str) -> dict:
    """Phase 6b: each backward kernel against the plain backward, which is
    autograd through the plain forward with its graph kept
    (``retain_graph``), so that only the backward is timed; the written-out
    plain backward (the kernels' oracle) is timed beside them."""
    import torch

    k1, k2 = bwd["k1"], bwd["k2"]
    side = k1["side"]
    t = k1["table"].detach().requires_grad_()
    f = k1["fracs"].detach().requires_grad_()
    out = cpb.table_interp_reference(t, k1["taps"], f, side)
    k1_ms, k1_plain = interleaved_ms(
        lambda: torch.autograd.grad(out, (t, f), k1["dout"],
                                    retain_graph=True),
        lambda: cpb.table_interp_backward(k1["table"], k1["taps"],
                                          k1["fracs"], k1["dout"], side), 20)
    k1_explicit = cuda_ms(lambda: cpb.table_interp_backward_reference(
        k1["table"], k1["taps"], k1["fracs"], k1["dout"], side), 10)
    del out
    print(f"[time] K1-bwd R=4608 side=50: kernel {k1_ms:.4f} ms, plain "
          f"(autograd) {k1_plain:.4f} ms, plain written out "
          f"{k1_explicit:.4f} ms; {46.08e6 / k1_ms / 1e9:.3f} TB/s of dw "
          f"read | {card}")
    leaves = [k2["gkv"].detach().requires_grad_()] + [
        x.detach().requires_grad_() for x in k2["w"]]
    out = cpb.cpb_bias_transposed_reference(k2["grid_q"], *leaves)
    k2_ms, k2_plain = interleaved_ms(
        lambda: torch.autograd.grad(out, leaves, k2["dbias"],
                                    retain_graph=True),
        lambda: cpb.cpb_bias_transposed_backward(k2["grid_q"], k2["gkv"],
                                                 *k2["w"], k2["dbias"]), 5)
    del out
    torch.cuda.empty_cache()
    k2_explicit = cuda_ms(lambda: cpb.cpb_bias_transposed_backward_reference(
        k2["grid_q"], k2["gkv"], *k2["w"], k2["dbias"]), 3, warmup=1)
    flops = k2_bwd_flops(k2["dbias"].numel(), 1)
    print(f"[time] K2-bwd 32x144x2500 O=1: kernel {k2_ms:.4f} ms, plain "
          f"(autograd) {k2_plain:.4f} ms, plain written out "
          f"{k2_explicit:.4f} ms; {flops / k2_ms / 1e9:.2f} TFLOP/s = "
          f"{flops / k2_ms / 1e9 / 67:.1%} of 67 TFLOP/s f32 | {card}")
    torch.cuda.empty_cache()
    return {"k1": (k1_ms, k1_plain), "k2": (k2_ms, k2_plain)}


def time_train_steps(configs, batch, dev, card: str, n: int = 30) -> None:
    """Phases 6b and 6c: train bags/s of each config (the teacher at the
    preset, at divisor 0 and at the preset again; the student at the
    preset): CUDA events around each of ``n`` steps on a resident batch,
    after 3 warm-up steps; then the profiler over one step of the last."""
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    x = batch_to_tensors(batch, dev)
    for c in configs:
        model = define_net(c, dev)
        opt = make_optimizer(c, model.parameters())
        step = make_train_step(model, c, opt, make_scheduler(c, opt, 1000))
        ms = ms_samples(lambda: step(x), n)
        med, p80 = median(ms), ms[int(0.8 * len(ms))]
        print(f"[time] train step B=4 fixdim=2500 {setting(c)}: median {med:.3f} ms = {4000.0 / med:.1f} train bags/s, p80 "
              f"{p80:.3f} ms = {4000.0 / p80:.1f} bags/s ({n} steps) "
              f"| {card}")
    profile(f"train step ({setting(configs[-1])})", lambda: step(x), n=3)


def check_outputs(metrics: dict, logits: dict, n_bags: int,
                  n_metrics: int = 21) -> None:
    import numpy as np

    for k, v in logits.items():
        if v.shape != (n_bags, 4) or not np.isfinite(v).all():
            raise RuntimeError(f"{k}: shape {v.shape} or non-finite values")
    if (len(metrics) != n_metrics
            or not all(map(math.isfinite, metrics.values()))):
        raise RuntimeError(f"bad metrics {metrics}")


def setting(cfg) -> str:
    """A config's cell: mode, divisor, bf16 streams (and deformpathomic's
    attn_dim and return_vgrid)."""
    out = (f"{cfg.mode}, divisor {cfg.cpb_table_divisor}, bf16 streams "
           f"{cfg.attn_bf16_streams}")
    if cfg.mode == "deformpathomic":
        out += f", attn_dim {cfg.attn_dim}, return_vgrid {cfg.return_vgrid}"
    return out


def deformpathomic_settings(cfg) -> tuple:
    """``cfg`` (the preset, serving or training) as deformpathomic's three
    main-path settings: attn_dim 1 at the preset's divisor 1 (K4), attn_dim
    1 at divisor 0 (K2 with O=2), attn_dim 2 with return_vgrid (K1)."""
    dp1 = cfg.replace(mode="deformpathomic", attn_dim=1)
    return (dp1, dp1.replace(cpb_table_divisor=0),
            cfg.replace(mode="deformpathomic", attn_dim=2, return_vgrid=True))


def check_table1d_kernels(dev, card: str) -> dict:
    """Phase 2d: K4-fwd at deformpathomic's preset shape (B=4 x G=4 rows of
    K=625 kv points, O=2 channels, n_q=2501 queries, kv points up to 25%
    past the bound so that some rows clip) against its plain version, and
    K4-bwd against its plain version in float64 (the f32 plain version's
    own error printed beside), called twice to show that it is
    deterministic."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

    B, G, K, O, n_q = 4, 4, 625, 2, 2501
    kv_bound = 1.0 + 2.0 * 2.0 / (K - 1)  # offset_scale 2 over n_ds - 1
    gen = torch.Generator().manual_seed(4)
    w = list(mlp_weights(O, gen, dev))
    w[0] = w[0][:1].contiguous()  # the 1-coordinate first layer
    table = cpb1d.cpb_table_1d(*w, n_q=n_q, kv_bound=kv_bound)
    gkv = ((torch.rand(B * G, K, generator=gen) * 2 - 1)
           * kv_bound * 1.25).to(dev)
    taps, fracs = cpb1d.table1d_taps(
        cpb1d.table1d_shifts(gkv, n_q=n_q, kv_bound=kv_bound),
        n_q=n_q, tn=table.shape[1])
    clipped = (fracs < 0) | (fracs > 1)
    with torch.inference_mode():
        got = cpb1d.table1d_interp(table, taps, fracs, n_q, K)
        want = cpb1d.table1d_interp_reference(table, taps, fracs, n_q, K)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"[K4] R={B * G * K} O={O} n_q={n_q} tn={table.shape[1]} out "
          f"{tuple(got.shape)} clipped rows={int(clipped.sum())} "
          f"max_abs_err={err:.3e} (tol {K4_TOL}), bitwise equal: "
          f"{torch.equal(got, want)} | {card}")
    if (table.shape[1] != 5023 or not clipped.any() or got.shape != want.shape
            or not err <= K4_TOL):
        raise RuntimeError("K4 disagrees with its plain version")
    del got, want
    dout = torch.randn(B * G, O, K, n_q, generator=gen).to(dev)
    kb = [cpb1d.table1d_interp_backward(table, taps, fracs, dout, n_q, K)
          for _ in range(2)]
    torch.cuda.synchronize()
    det = all(torch.equal(a, b) for a, b in zip(*kb))
    want = cpb1d.table1d_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), n_q, K)
    plain = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                    n_q, K)
    errs = {n: (rel_err(g, ww), rel_err(p, ww))
            for n, g, p, ww in zip(("dtable", "dshifts"), kb[0], plain, want)}
    bwd_err = max((g.double() - ww).abs().max().item()
                  for g, ww in zip(kb[0], want))
    clipped_dsh = kb[0][1][clipped].abs().min().item()
    for n, (e, pe) in errs.items():
        print(f"[K4-bwd] R={B * G * K} O={O} n_q={n_q} {n}: rel err vs f64 "
              f"kernel {e:.3e}, f32 plain {pe:.3e} (tol {K4_BWD_TOL[n]}) "
              f"| {card}")
    print(f"[K4-bwd] clipped rows' smallest |dshift| {clipped_dsh:.3e}; "
          f"deterministic (2 calls bitwise equal): {det}; max_abs_err "
          f"{bwd_err:.3e}")
    if (not det or not clipped_dsh > 0
            or not all(e <= K4_BWD_TOL[n] for n, (e, _) in errs.items())):
        raise RuntimeError("K4-bwd disagrees with its plain version or is "
                           "not deterministic")
    return dict(table=table, taps=taps, fracs=fracs, dout=dout, n_q=n_q,
                kv=K, err=err, bwd_err=bwd_err, out_numel=dout.numel())


def exact_backward_in_chunks(cpb, grid_q, gkv, w, dbias, dtype,
                             rows: int = 2) -> tuple:
    """K2's plain backward in ``dtype``, ``rows`` rows of ``gkv`` at a time
    (the weight cotangents summed over the chunks), so that float64 fits
    the card at the 1-D attention's shape (a chunk's [2, 625, 2501, 32]
    float64 intermediates are 800 MB each)."""
    import torch

    parts = [cpb.cpb_bias_transposed_backward_reference(
        grid_q.to(dtype), gkv[i:i + rows].to(dtype),
        *(t.to(dtype) for t in w), dbias[i:i + rows].to(dtype))
        for i in range(0, gkv.shape[0], rows)]
    return (torch.cat([p[0] for p in parts]),) + tuple(
        sum(p[j] for p in parts) for j in range(1, 7))


def check_exact_1d_kernels(dev, card: str) -> dict:
    """Phase 2d: K2 at the shape deformpathomic's attn_dim-1 layers give it
    at divisor 0 (B=4 x G=4 rows of K=625 kv points, n_q=2501 queries, O=2
    channels, the 1-D coordinate padded with a zero second one and a zero
    row of ``w1``, as ``models/deform_attention.py`` pads it): K2-fwd
    against its plain version within ``K2_TOL`` abs, and K2-bwd against
    its plain version in float64 within ``K2_BWD_TOL`` norm-relative (the
    f32 plain version's own error printed beside), bitwise equal over two
    calls.  Returns the inputs (for the timings) and the errors."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    BG, K, O, n_q = 16, 625, 2, 2501
    gen = torch.Generator().manual_seed(5)
    w = list(mlp_weights(O, gen, dev))
    w[0][1].zero_()
    grid_q = torch.stack([torch.linspace(-1, 1, n_q, device=dev),
                          torch.zeros(n_q, device=dev)], dim=-1)
    gkv = torch.stack([(torch.rand(BG, K, generator=gen) * 2 - 1).to(dev),
                       torch.zeros(BG, K, device=dev)], dim=-1)
    with torch.inference_mode():
        got = cpb.cpb_bias_transposed(grid_q, gkv, *w)
        want = cpb.cpb_bias_transposed_reference(grid_q, gkv, *w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"[K2] at the 1-D shape BG={BG} K={K} N={n_q} O={O} out "
          f"{tuple(got.shape)} bias range [{want.min().item():.3f}, "
          f"{want.max().item():.3f}] max_abs_err={err:.3e} (tol {K2_TOL}) "
          f"| {card}")
    if got.shape != (BG, O, K, n_q) or not err <= K2_TOL:
        raise RuntimeError("K2 disagrees with its plain version at the 1-D "
                           "shape")
    del got, want
    dbias = torch.randn(BG, O, K, n_q, generator=gen).to(dev)
    kb = [cpb.cpb_bias_transposed_backward(grid_q, gkv, *w, dbias)
          for _ in range(2)]
    torch.cuda.synchronize()
    det = all(torch.equal(a, b) for a, b in zip(*kb))
    want = exact_backward_in_chunks(cpb, grid_q, gkv, w, dbias, torch.float64)
    plain = exact_backward_in_chunks(cpb, grid_q, gkv, w, dbias,
                                     torch.float32)
    names = ("dgrid_kv", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    errs = {n: (rel_err(g, ww), rel_err(p, ww))
            for n, g, p, ww in zip(names, kb[0], plain, want)}
    bwd_err = max((g.double() - ww).abs().max().item()
                  for g, ww in zip(kb[0], want))
    print(f"[K2-bwd] at the 1-D shape BG={BG} K={K} N={n_q} O={O} rel err "
          "vs f64, kernel / f32 plain: " + ", ".join(
              f"{n} {e:.2e} / {pe:.2e}" for n, (e, pe) in errs.items())
          + f"; deterministic: {det}; max_abs_err {bwd_err:.3e} | {card}")
    tol = {n: K2_BWD_TOL["dgrid_kv" if n == "dgrid_kv" else "dw"]
           for n in names}
    if not det or not all(e <= tol[n] for n, (e, _) in errs.items()):
        raise RuntimeError("K2-bwd disagrees with its plain version at the "
                           "1-D shape or is not deterministic")
    return dict(grid_q=grid_q, gkv=gkv, w=w, dbias=dbias, err=err,
                bwd_err=bwd_err)


def run_deformpathomic_entries(preset, train_preset, dev, card: str) -> dict:
    """Phase 3d: deformpathomic's serving entry (3 batches at attn_dim 1,
    divisor 1; 1 batch at each other setting) and training entry (3 steps
    at attn_dim 1, divisor 1; 1 step at each other setting), every count
    set to 0 just before a run and read just after.  Returns the counts of
    the attn_dim-1, divisor-1 training run (K4's main path)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference

    kernel = ("k4", "k2", "k1")  # of each setting, in deformpathomic_settings
    serve = deformpathomic_settings(preset)
    for cfg, k, batches in zip(serve, kernel, (3, 1, 1)):
        cfg = cfg.replace(synthetic_test_size=4 * batches)
        reset_counts()
        t0 = time.perf_counter()
        metrics, logits = inference.main(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts()
        print(f"[main] serving, {setting(cfg)}: {batches} batches in "
              f"{wall:.2f} s (set-up included); launches {n}")
        check_outputs(metrics, logits, 4 * batches, n_metrics=7)
        if n != expect(**{f"{k}_fwd": 2 * batches}):
            raise RuntimeError(f"deformpathomic serving: launches {n}")
    train = deformpathomic_settings(train_preset)
    main_counts = None
    for cfg, k, steps in zip(train, kernel, (3, 1, 1)):
        n = run_training_entry(
            cfg.replace(synthetic_train_size=4 * steps), dev, steps,
            {f"{k}_fwd": 2, f"{k}_bwd": 2}, {f"{k}_fwd": 2}, card)
        main_counts = main_counts or n
        torch.cuda.empty_cache()
    return main_counts


def time_table1d_kernels(k4: dict, k2_1d: dict, card: str) -> dict:
    """Phase 6d: K4-fwd and K4-bwd against their plain versions (for the
    backward, autograd through the plain forward with its graph kept), on
    phase 2d's inputs; then K2-fwd and K2-bwd the same way on phase 2d's
    inputs at the 1-D attention's shape, with their bounds."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb, cpb1d

    t, taps, fracs, dout = k4["table"], k4["taps"], k4["fracs"], k4["dout"]
    n_q, kv = k4["n_q"], k4["kv"]
    nbytes = 4 * dout.numel()
    with torch.inference_mode():
        fwd = interleaved_ms(
            lambda: cpb1d.table1d_interp_reference(t, taps, fracs, n_q, kv),
            lambda: cpb1d.table1d_interp(t, taps, fracs, n_q, kv), 50)
    tt, ff = t.detach().requires_grad_(), fracs.detach().requires_grad_()
    out = cpb1d.table1d_interp_reference(tt, taps, ff, n_q, kv)
    bwd = interleaved_ms(
        lambda: torch.autograd.grad(out, (tt, ff), dout, retain_graph=True),
        lambda: cpb1d.table1d_interp_backward(t, taps, fracs, dout, n_q, kv),
        20)
    del out
    for name, (ms, plain) in (("K4-fwd", fwd), ("K4-bwd", bwd)):
        print(f"[time] {name} R={taps.shape[0]} O=2 n_q={n_q}: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms; {nbytes / ms / 1e9:.3f} "
              f"TB/s of the {nbytes / 1e6:.0f} MB bias "
              f"{'written' if name == 'K4-fwd' else 'cotangent read'} = "
              f"{nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s | {card}")
    torch.cuda.empty_cache()

    grid_q, gkv, w, dbias = (k2_1d[k] for k in ("grid_q", "gkv", "w", "dbias"))
    with torch.inference_mode():
        k2f = interleaved_ms(
            lambda: cpb.cpb_bias_transposed_reference(grid_q, gkv, *w),
            lambda: cpb.cpb_bias_transposed(grid_q, gkv, *w), 3)
    leaves = [gkv.detach().requires_grad_()] + [
        x.detach().requires_grad_() for x in w]
    out = cpb.cpb_bias_transposed_reference(grid_q, *leaves)
    k2b = interleaved_ms(
        lambda: torch.autograd.grad(out, leaves, dbias, retain_graph=True),
        lambda: cpb.cpb_bias_transposed_backward(grid_q, gkv, *w, dbias), 3)
    del out, leaves
    torch.cuda.empty_cache()
    n_kv = gkv.shape[0] * gkv.shape[1]
    points = n_kv * n_q
    fwd_bound = bound(4 * (dbias.numel() + 2 * n_q + gkv.numel()),
                      k2_fwd_flops(points, 2))
    bwd_bound = bound(4 * (dbias.numel() + 2 * gkv.numel() + 2 * n_q),
                      k2_bwd_flops(points, 2))
    for name, (ms, plain), (bms, by) in (("K2-fwd", k2f, fwd_bound),
                                         ("K2-bwd", k2b, bwd_bound)):
        print(f"[time] {name} at the 1-D shape {gkv.shape[0]}x{kv}x{n_q} O=2:"
              f" kernel {ms:.4f} ms, plain{' (autograd)' * (name == 'K2-bwd')}"
              f" {plain:.4f} ms; bound {bms:.4f} ms by {by} "
              f"({points / 1e6:.1f} M points) | {card}")
    return {"k4_fwd": fwd, "k4_bwd": bwd}


def time_deformpathomic(preset, train_preset, batch, dev, card: str) -> None:
    """Phase 6d: eval bags/s (median and p80 of 30 forwards, CUDA events,
    batch resident) and a profiled forward of each deformpathomic setting,
    then each setting's train step (bags/s and a profiled step)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    x = model_inputs(batch, dev, "deformpathomic")
    for cfg in deformpathomic_settings(preset):
        model = define_net(cfg, dev)
        with torch.inference_mode():
            ms = ms_samples(lambda: model(**x), 30)
            med, p80 = median(ms), ms[int(0.8 * len(ms))]
            print(f"[time] eval forward B=4 fixdim=2500 {setting(cfg)}: "
                  f"median {med:.3f} ms/batch = {4000.0 / med:.1f} bags/s, "
                  f"p80 {p80:.3f} ms = {4000.0 / p80:.1f} bags/s "
                  f"(30 forwards) | {card}")
            profile(f"eval forward ({setting(cfg)})", lambda: model(**x))
        del model
        torch.cuda.empty_cache()
    for cfg in deformpathomic_settings(train_preset):
        time_train_steps((cfg,), batch, dev, card)
        torch.cuda.empty_cache()


def profile(label: str, fn, n: int = 5) -> None:
    """torch.profiler over ``n`` calls of ``fn`` after 3 warm-up calls:
    the kernel table and the device's busy and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    avg = prof.key_averages()
    print(avg.table(sort_by="self_device_time_total", row_limit=30))
    # device rows only (the op rows repeat their kernels' time)
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / n
    print(f"[profile] per {label} (profiler on): device busy {busy:.3f} ms "
          f"of {wall:.3f} ms wall = {busy / wall:.1%} busy, "
          f"{1 - busy / wall:.1%} idle")


if __name__ == "__main__":
    sys.exit(main())

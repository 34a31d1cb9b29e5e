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
   train step of each (device-busy share);
2e. holds K1-fwd with the bf16 store (``cpb_table_bf16``) and K5-fwd (the
   table CPB at divisor 2 and 4, tn 274 and 544, f32 and bf16 store, R =
   4608 rows of side 50, clipped rows included) bitwise against their plain
   versions, K1-bwd with a bf16 cotangent (within ``K1_BWD_TOL``) and
   K5-bwd (f32 and bf16 cotangents, within ``K5_BWD_TOL``) against their
   plain version in float64, deterministic, every clipped row's shift
   cotangent kept; K6-fwd (the fused table attention, BH=32, K=144,
   N=2500, D=64) against its plain version at dropout 0 and 0.1 with the
   same mask, and K6-bwd against the plain version's autograd in float64,
   deterministic;
3e. runs the teacher's serving entry (1 batch) and training entry (2
   steps and 1 eval batch) in the three opt-in settings of the preset:
   (a) ``fused_table_attention`` (K6-fwd 4 per forward, K6-bwd 4 per step,
   K1's wrappers never; each K6-bwd launch also runs K1-bwd's two scatter
   kernels on its ``ds``, counted as part of K6-bwd), (b) ``cpb_table_divisor 4`` (K5-fwd and K5-bwd the same way,
   K1 never), (c) ``cpb_table_bf16`` (K1-fwd and K1-bwd with the bf16
   store and cotangent), exact counts;
5e. compares the f32 forward (logits within 1e-4) and one f32
   ``deterministic_training`` step of (a) and (b) on the card with the CPU;
6e. times K1-fwd with the bf16 store, K5-fwd (divisor 2 and 4, f32 and
   bf16) and K5-bwd against their plain versions, K6-fwd and K6-bwd at
   dropout 0 and 0.1 against their plain versions and beside the port's
   unfused divisor-1 composition (K1 + matmul + softmax + dropout +
   matmul, and its autograd backward), and the teacher's eval forward and
   train step in (a), (b) and (c) (bags/s and a profiled call each);
2f. holds K2-nk (the exact CPB written in the "nk" layout, closing the TPU's
   four layout kernels v1, v5, v2 and wide4) at the teacher's shape (32 x
   2500 x 144, O=1) and at the 1-D attention's (16 x 2501 x 625, O=2):
   bitwise equal to K2 transposed and within ``K2_TOL`` of its plain
   version; K2-nk-bwd against float64 within ``K2_BWD_TOL``, bitwise equal
   over two calls and to K2-bwd on the transposed cotangent; K7 (the fused
   exact-CPB attention, q [32, 2500, 64], k and v [32, 144, 64]) in both
   layouts at dropout 0 and 0.1, and at the 1-D attention's K = 625 (q
   [16, 2501, 16], the kv points in four chunks) at dropout 0.1: out and
   attn within ``K2_TOL``, the
   layouts bitwise equal, and K7-bwd against float64 (dq, dk, dv within
   ``K6_BWD_TOL``, grid_kv and the weights within ``K2_BWD_TOL``),
   deterministic;
3f. runs the teacher built with ``define_net(cfg, attn_layout="nk")`` at
   the preset (which "nk" runs with the exact CPB): 3 eval batches through
   the ``Evaluator`` (K2-nk-fwd 4 per forward) and 2 train steps through
   ``train/steps.py`` (K2-nk-fwd and -bwd 4 each per step), every other
   kernel never; deformpathomic at attn_dim 1 in "nk" (K2-nk at O=2, 2 per
   forward and step); and K7 through its public entry, one forward and
   backward in each layout, exact counts;
5f. compares the f32 "nk" teacher's forward (logits within 1e-4) and one
   f32 ``deterministic_training`` step on the card with the CPU;
6f. times K2-nk-fwd and -bwd at both shapes and K7-fwd and -bwd in both
   layouts at dropout 0.1 against their plain versions, with their bounds,
   and the "nk" teacher's eval forward and train step (bags/s and a
   profiled call each).

The main paths (the inference entry and the training entry) each run at
the preset's divisor 1 and at the ``Config`` default divisor 0, and the
teacher's also in the opt-in settings (a), (b) and (c), every count set to
0 just before a run and read just after.  In the kernels line the
``launches`` are those of the training runs (K1 and K2: the teacher's at
divisor 1 and 0; K3: the student's at the preset; K4: deformpathomic's at
attn_dim 1, divisor 1; K5: the teacher's in (b); K6: the teacher's in
(a); K2-nk: the "nk" teacher's train steps; K7: its entry's run), and K2's
``max_abs_err`` is the larger of its errors at the 2-D and the 1-D shape.
Launches made for comparisons and timings are not counted.  K5's times are
at divisor 4 in f32, K6's at the preset's dropout 0.1, K2-nk's at the
teacher's shape, K7's in "nk" at dropout 0.1.
Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its flops over 67
TFLOP/s (f32 outside the tensor cores), counted from this run's inputs
(H100 SXM data sheet); ``library_ms`` is null for all sixteen: no single
PyTorch call computes any of their functions (K6 and K7 include the table
windows or the CPB MLP, and a softmax over the kv axis, which
``scaled_dot_product_attention`` does not take as a bias it builds).
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
# through K2 alike (this step at full width), hence ZERO_GRAD_FLOOR_1D; so
# does the 2-D attention's with the exact CPB ("nk": 360 k distinct
# cotangents per batch-head, 1.9e-5 of the weight gradient on the H100)
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias")
ZERO_GRAD_FLOOR, ZERO_GRAD_FLOOR_1D = 1e-5, 1e-4
# K4: the kernel rounds the two-term lerp op by op as its plain version
# does, so it should agree bitwise; 1e-6 abs is the stated bound.  K4-bwd
# against float64: the shift cotangents sum 5,002 terms d * (T[i+1] - T[i])
# and the table entries ~4,000 contributions each, in f32
K4_TOL = 1e-6
K4_BWD_TOL = {"dtable": 1e-5, "dshifts": 1e-5}
# K5 (and K1 with the bf16 store) rounds every op as its plain version does
# and is held to bitwise equality.  K5-bwd against float64: dtable entries
# sum up to a few hundred contributions, the shift cotangents 2,500 terms
# that cancel, in f32
K5_BWD_TOL = 1e-5
# K6-fwd against its plain version: the products sum in another order than
# cuBLAS (sim of O(1), 64 terms), the softmax sums in another order; attn
# within 1e-6 abs, out (sums of 144 weighted v) within 1e-5.  K6-bwd against
# the plain version's autograd in float64, norm-relative: dq, dk and dv
# 2e-5 (sums over 144 kv points or 2,500 queries); dtable and dfracs (the
# K1-bwd scatter of ds, whose column sums cancel) 1e-4 or twice the f32
# plain version's own error, whichever is larger
K6_ATTN_TOL, K6_OUT_TOL = 1e-6, 1e-5
K6_BWD_TOL, K6_TABLE_BWD_TOL = 2e-5, 1e-4
# K7-bwd's CPB cotangents: the bias cotangent ds of the softmax sums to 0
# over each query's kv points, so the weight cotangents (sums over 11.5 M
# points) cancel far more than K2-bwd's random ones: the f32 plain version
# itself sits 2.3e-3 off float64 on db2 (H100 run); hence K2_BWD_TOL or
# twice the f32 plain version's own error.  db3 is a sum of all of ds, 0 in
# exact arithmetic; its f32 residue reached 1.1e-5 of dw3 (the kernel), so
# it is held below 1e-4 of dw3, the floor of the 1-D attention's output bias
K7_DB3_FLOOR = 1e-4
HBM_BYTES_PER_MS = 3.35e9     # 3.35 TB/s
F32_FLOPS_PER_MS = 67e9       # 67 TFLOP/s outside the tensor cores
CSRC = "disentangled_multimodal_learning_tpu_torch/csrc"
TABLE_SRC = f"{CSRC}/cpb_table.cu"
EXACT_SRC = f"{CSRC}/cpb_exact.cu"
DPC_SRC = f"{CSRC}/dpc_knn.cu"
TABLE1D_SRC = f"{CSRC}/cpb_table_1d.cu"
STRIDED_SRC = f"{CSRC}/cpb_table_strided.cu"
FUSED_SRC = f"{CSRC}/fused_table.cu"
FUSED_EXACT_SRC = f"{CSRC}/fused_exact.cu"
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
    from disentangled_multimodal_learning_tpu_torch.ops import (
        cpb, cpb1d, dpc_knn, fused_exact, fused_table)

    return {"k1_fwd": cpb.table_interp,
            "k1_bwd": cpb.table_interp_backward,
            "k2_fwd": cpb.cpb_bias_transposed,
            "k2_bwd": cpb.cpb_bias_transposed_backward,
            "k3_knn": dpc_knn.knn_stream,
            "k3_parent": dpc_knn.parent_stream,
            "k4_fwd": cpb1d.table1d_interp,
            "k4_bwd": cpb1d.table1d_interp_backward,
            "k5_fwd": cpb.table_interp_strided,
            "k5_bwd": cpb.table_interp_strided_backward,
            "k6_fwd": fused_table.fused_table_attention,
            "k6_bwd": fused_table.fused_table_attention_backward,
            "k2nk_fwd": cpb.cpb_bias_nk,
            "k2nk_bwd": cpb.cpb_bias_nk_backward,
            "k7_fwd": fused_exact.fused_exact_attention,
            "k7_bwd": fused_exact.fused_exact_attention_backward}


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
    torch.cuda.empty_cache()

    # ---- phase 2e: K5 (and the bf16 store) and K6 against plain versions -
    k5 = check_table_strided_kernels(cpb, dev, card)
    k6 = check_fused_kernels(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 3e: the teacher's entries in the opt-in settings ---------
    train_counts.update(run_opt_in_entries(preset, train_preset, dev, card))

    # ---- phase 5e: (a) and (b) in f32, card vs CPU ----------------------
    for cfg in opt_in_settings(f32)[:2]:
        with torch.inference_mode():
            card_out = define_net(cfg, dev)(
                **model_inputs(batch, dev, "teacher"))[2]
            cpu_out = define_net(cfg, "cpu")(
                **model_inputs(batch, "cpu", "teacher"))[2]
        errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
                for k in cpu_out}
        print(f"[f32] {setting(cfg)} card vs CPU logits max_abs_err "
              f"{max(errs.values()):.3e} (tol {LOGITS_TOL}); per output "
              f"{errs}")
        if not max(errs.values()) <= LOGITS_TOL:
            raise RuntimeError("f32 logits on the card disagree with the CPU")
        compare_train_step(cfg.replace(deterministic_training=True), batch,
                           dev)
        torch.cuda.empty_cache()

    # ---- phase 6e: K5, K6 and the opt-in settings' timings --------------
    opt_ms = time_opt_in_kernels(cpb, k5, k6, card)
    time_opt_in_settings(preset, train_preset, batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phase 2f: K2-nk and K7 against plain versions and float64 ------
    nk = check_nk_kernels(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 3f: the "nk" layout's paths, and K7's entry --------------
    train_counts.update(run_nk_paths(preset, train_preset, dev, card))
    torch.cuda.empty_cache()

    # ---- phase 5f: the "nk" teacher in f32, card vs CPU ------------------
    with torch.inference_mode():
        card_out = define_net(f32, dev, attn_layout="nk")(
            **model_inputs(batch, dev, "teacher"))[2]
        cpu_out = define_net(f32, "cpu", attn_layout="nk")(
            **model_inputs(batch, "cpu", "teacher"))[2]
    errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
            for k in cpu_out}
    print(f"[f32] nk layout, {setting(f32)}: card vs CPU logits max_abs_err "
          f"{max(errs.values()):.3e} (tol {LOGITS_TOL}); per output {errs}")
    if not max(errs.values()) <= LOGITS_TOL:
        raise RuntimeError("f32 nk logits on the card disagree with the CPU")
    del card_out, cpu_out
    compare_train_step(f32.replace(deterministic_training=True), batch, dev,
                       layout="nk")
    torch.cuda.empty_cache()

    # ---- phase 6f: K2-nk, K7 and the "nk" teacher's timings -------------
    nk_ms = time_nk(nk, preset, train_preset, batch, dev, card)

    print(json.dumps({"kernels": kernel_line(
        train_counts, dict(k1=k1_err, k2=max(*k2_err.values(), k2_1d["err"]),
                           k1_bwd=max(bwd["k1"]["err"], k5["k1_bwd_err"]),
                           k2_bwd=max(bwd["k2"]["err"], k2_1d["bwd_err"]),
                           k3=dpc["err"], k4=k4["err"], k4_bwd=k4["bwd_err"],
                           k5=k5["err"], k5_bwd=k5["bwd_err"], k6=k6["err"],
                           k6_bwd=k6["bwd_err"], k2nk=nk["err"],
                           k2nk_bwd=nk["bwd_err"], k7=nk["k7_err"],
                           k7_bwd=nk["k7_bwd_err"]),
        dict(k1=(k1_ms, k1_plain), k2=(k2_ms, k2_plain),
             k1_bwd=bwd_ms["k1"], k2_bwd=bwd_ms["k2"], **dpc_ms, **k4_ms,
             k5_fwd=opt_ms[("k5_fwd", 4, torch.float32)],
             k5_bwd=opt_ms[("k5_bwd", 4)],
             k6_fwd=opt_ms[("k6", 0.1)][0], k6_bwd=opt_ms[("k6", 0.1)][1]),
        dict(table=table, taps=taps, fracs=fracs, side=side, gkv=gkv2,
             w=w, n=side * side), bwd, dpc, k4, k5, k6, nk_ms)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_line(launches, errs, times, fwd, bwd, dpc, k4, k5, k6,
                nk_ms) -> list[dict]:
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
    # K5 at divisor 4, f32 (phase 6e's timed case)
    k5_bound, k5b_bound = table_bounds(k5[4]["table"], k5[4]["taps"], side)
    # K6: q, k, v, the table, taps and fractions read, out and attn written
    # (forward); the backward also reads attn and both cotangents and
    # writes dq, dk, dv, dtable and dfracs; 2 flops per multiply-add of the
    # two (forward) or four (backward) BH x K x N x D products
    bh, n6, d6 = k6["q"].shape
    kv6 = k6["k"].shape[1]
    small6 = 4 * (k6["table"].numel() + 4 * bh * kv6)
    qkv = 4 * (bh * n6 * d6 + 2 * bh * kv6 * d6)
    macs = bh * kv6 * n6 * d6
    k6_bound = bound(qkv + small6 + 4 * (bh * n6 * d6 + bh * kv6 * n6),
                     4 * macs)
    k6b_bound = bound(2 * qkv + small6 + 4 * (bh * n6 * d6
                                              + 2 * bh * kv6 * n6
                                              + k6["table"].numel()
                                              + 2 * bh * kv6), 8 * macs)
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
        ("cpb_table_strided_fwd (K5-fwd)", STRIDED_SRC, f"{PALLAS}:2019",
         launches["k5"]["k5_fwd"], errs["k5"], times["k5_fwd"], k5_bound),
        ("cpb_table_strided_bwd (K5-bwd)", f"{CSRC}/cpb_table_strided_bwd.cu",
         f"{PALLAS}:2040", launches["k5"]["k5_bwd"], errs["k5_bwd"],
         times["k5_bwd"], k5b_bound),
        ("fused_table_fwd (K6-fwd)", FUSED_SRC, f"{PALLAS}:2910",
         launches["k6"]["k6_fwd"], errs["k6"], times["k6_fwd"], k6_bound),
        ("fused_table_bwd (K6-bwd)", f"{CSRC}/fused_table_bwd.cu",
         f"{PALLAS}:2949", launches["k6"]["k6_bwd"], errs["k6_bwd"],
         times["k6_bwd"], k6b_bound),
        # K2-nk closes the four TPU layout kernels of the exact CPB: v1
        # :640 (the one the TPU's "nk" runs), v5 :1196, v2 :428, wide4 :912
        # (backwards :668, :1205, :447, :931); K7 closes the nk tiles :96
        # and v8 :1664 (backwards :125, :1698).  Times: K2-nk at the
        # teacher's shape, K7 in "nk" at rate 0.1
        ("cpb_exact_nk_fwd (K2-nk-fwd)", EXACT_SRC, f"{PALLAS}:640",
         launches["k2nk"]["k2nk_fwd"], errs["k2nk"],
         nk_ms["2-D"]["fwd"][0], nk_ms["2-D"]["fwd"][1]),
        ("cpb_exact_nk_bwd (K2-nk-bwd)", f"{CSRC}/cpb_exact_bwd.cu",
         f"{PALLAS}:668", launches["k2nk"]["k2nk_bwd"], errs["k2nk_bwd"],
         nk_ms["2-D"]["bwd"][0], nk_ms["2-D"]["bwd"][1]),
        ("fused_exact_fwd (K7-fwd)", FUSED_EXACT_SRC, f"{PALLAS}:96",
         launches["k7"]["k7_fwd"], errs["k7"], nk_ms["nk"]["fwd"][0],
         nk_ms["nk"]["fwd"][1]),
        ("fused_exact_bwd (K7-bwd)", f"{CSRC}/fused_exact_bwd.cu",
         f"{PALLAS}:125", launches["k7"]["k7_bwd"], errs["k7_bwd"],
         nk_ms["nk"]["bwd"][0], nk_ms["nk"]["bwd"][1]),
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


def compare_train_step(cfg, batch, dev, layout: str = "auto") -> None:
    """Phases 5b, 5c, 5d, 5e and 5f: one ``deterministic_training`` f32
    step of ``cfg.mode`` (its attentions in ``layout``) from the same seeded
    weights on the same batch, on the card and on the CPU."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    out = {}
    for device in (dev, "cpu"):
        model = define_net(cfg, device, attn_layout=layout)
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
            rel = (ZERO_GRAD_FLOOR_1D if ".attn1d." in name or layout == "nk"
                   else ZERO_GRAD_FLOOR)
            scale = g_cpu[name[:-4] + "weight"].abs().max().item()
            ratio = max(got.abs().max().item(), want.abs().max().item()) / scale
            bias_ok &= ratio <= rel
            bias_ratio = max(bias_ratio, ratio)
            continue
        # the MaxNets' classifiers get a zero gradient on both sides
        errs[name] = ((got - want).norm()
                      / max(want.norm().item(), 1e-30)).item()
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"[f32 step] {setting(cfg)}, layout {layout}: card task loss "
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
    """A config's cell: mode, divisor, bf16 streams, the opt-in table paths
    when set (and deformpathomic's attn_dim and return_vgrid)."""
    out = (f"{cfg.mode}, divisor {cfg.cpb_table_divisor}, bf16 streams "
           f"{cfg.attn_bf16_streams}")
    if cfg.fused_table_attention:
        out += ", fused table attention"
    if cfg.cpb_table_bf16:
        out += ", bf16 table store"
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


def opt_in_settings(cfg) -> tuple:
    """``cfg`` (the preset, serving or training) in the three opt-in
    settings of the 2-D attention: (a) the fused table attention (K6), (b)
    the table at divisor 4 (K5), (c) the bf16 table store (K1)."""
    return (cfg.replace(fused_table_attention=True),
            cfg.replace(cpb_table_divisor=4),
            cfg.replace(cpb_table_bf16=True))


# the teacher's kernels in each opt-in setting, per forward or train step
OPT_IN_KERNELS = (("k6_fwd", "k6_bwd"), ("k5_fwd", "k5_bwd"),
                  ("k1_fwd", "k1_bwd"))


def table_bounds(table, taps, side: int, out_bytes: int = 4) -> tuple:
    """``(forward, backward)`` bounds of a table kernel (K1, K5): the
    forward reads the table, taps and fractions once and writes the
    windows (``out_bytes`` a value), 9 flops a value (four products, three
    sums, the two 1 - f); the backward reads the window cotangent, the
    table, taps and fractions, and writes the table cotangent and the
    fraction cotangents, 16 flops a cotangent value."""
    R = taps.shape[0]
    values = R * side * side
    small = 4 * table.numel() + 16 * R
    return (bound(small + out_bytes * values, 9 * values),
            bound(small + 4 * table.numel() + 8 * R + out_bytes * values,
                  16 * values))


def strided_case(cpb, dev, divisor: int, gen, side: int = 50, bh: int = 32,
                 k: int = 144):
    """A table at ``divisor`` and the taps and fractions of ``bh x k`` kv
    points up to 25% past the bound of the teacher's 12 x 12 deformed grid,
    so that some rows clip and extrapolate."""
    import torch

    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    w = mlp_weights(1, gen, dev)
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound, divisor=divisor)
    gkv = ((torch.rand(bh, k, 2, generator=gen) * 2 - 1)
           * kv_bound * 1.25).to(dev)
    taps, fracs = cpb.table_taps(
        cpb.table_shifts(gkv, side=side, kv_bound=kv_bound, divisor=divisor),
        side=side, tn=table.shape[0], divisor=divisor)
    return table, taps, fracs


def check_table_strided_kernels(cpb, dev, card: str) -> dict:
    """Phase 2e (K5 and the bf16 store): K1-fwd with the bf16 store, and
    K5-fwd at divisor 2 and 4 (tn 274 and 544) in f32 and with the bf16
    store, at R = 4608 rows of side 50 with clipped rows, each against its
    plain version (bitwise equal: the same ops rounded the same way); K1-bwd
    with a bf16 window cotangent and K5-bwd with f32 and bf16 ones through
    :func:`check_table_backward`.  Returns the inputs (for the timings) and
    the errors."""
    import torch

    gen = torch.Generator().manual_seed(6)
    side = 50
    out = {"err": 0.0, "bwd_err": 0.0}
    table, taps, fracs = strided_case(cpb, dev, 1, gen)
    with torch.inference_mode():
        got = cpb.table_interp(table, taps, fracs, side, torch.bfloat16)
        want = cpb.table_interp_reference(table, taps, fracs, side,
                                          out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    same = got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)
    print(f"[K1 bf16] R={taps.shape[0]} side={side} tn={table.shape[0]} bf16 "
          f"store bitwise equal to its plain version: {same} | {card}")
    if not same:
        raise RuntimeError("K1 with the bf16 store disagrees with its plain "
                           "version")
    dout = torch.randn(taps.shape[0], side, side, generator=gen).to(dev)
    out["k1_bwd_err"] = check_table_backward(
        cpb, "K1-bwd", table, taps, fracs, dout.to(torch.bfloat16), side, 1,
        K1_BWD_TOL, card)
    out["k1_bf16"] = dict(table=table, taps=taps, fracs=fracs)
    for d in (2, 4):
        table, taps, fracs = strided_case(cpb, dev, d, gen)
        R = taps.shape[0]
        clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
        for dt in (torch.float32, torch.bfloat16):
            with torch.inference_mode():
                got = cpb.table_interp_strided(table, taps, fracs, side, d, dt)
                want = cpb.table_interp_reference(table, taps, fracs, side, d,
                                                  dt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = got.dtype == want.dtype == dt and torch.equal(got, want)
            print(f"[K5] divisor {d} R={R} side={side} tn={table.shape[0]} "
                  f"{str(dt)[6:]} store: clipped rows {int(clipped.sum())}, "
                  f"max_abs_err {err:.3e}, bitwise equal {same} | {card}")
            if not same or not clipped.any():
                raise RuntimeError("K5 disagrees with its plain version")
            out["err"] = max(out["err"], err)
        dout = torch.randn(R, side, side, generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            out["bwd_err"] = max(out["bwd_err"], check_table_backward(
                cpb, "K5-bwd", table, taps, fracs, dout.to(dt),
                side, d, dict.fromkeys(("dtable", "dfracs"), K5_BWD_TOL),
                card))
        out[d] = dict(table=table, taps=taps, fracs=fracs, dout=dout)
        torch.cuda.empty_cache()
    return out


def check_table_backward(cpb, name: str, table, taps, fracs, dout,
                         side: int, divisor: int, tol: dict,
                         card: str) -> float:
    """K1-bwd (divisor 1) or K5-bwd with the window cotangent ``dout`` (f32
    or bf16) against its plain version in float64, each cotangent
    norm-relative within its ``tol`` (the f32 plain version's own error
    beside), bitwise equal over two calls, every clipped row's shift
    cotangent kept.  Returns the largest absolute error against float64."""
    import torch

    def bwd():
        if divisor == 1:
            return cpb.table_interp_backward(table, taps, fracs, dout, side)
        return cpb.table_interp_strided_backward(table, taps, fracs, dout,
                                                 side, divisor)

    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    kb = [bwd() for _ in range(2)]
    torch.cuda.synchronize()
    det = all(torch.equal(a, b) for a, b in zip(*kb))
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), side, divisor)
    plain = cpb.table_interp_backward_reference(table, taps, fracs, dout,
                                                side, divisor)
    errs = {n: (rel_err(g, ww), rel_err(p, ww)) for n, g, p, ww in
            zip(("dtable", "dfracs"), kb[0], plain, want)}
    clipped_dsh = (kb[0][1][clipped].abs().amax(dim=1).min().item()
                   if clipped.any() else 0.0)
    abs_err = max((g.double() - ww).abs().max().item()
                  for g, ww in zip(kb[0], want))
    print(f"[{name}] divisor {divisor} R={taps.shape[0]} side={side} "
          f"{str(dout.dtype)[6:]} cotangent: rel "
          f"err vs f64, kernel / f32 plain: " + ", ".join(
              f"{n} {e:.3e} / {pe:.3e} (tol {tol[n]})"
              for n, (e, pe) in errs.items())
          + f"; clipped rows {int(clipped.sum())}, their "
          f"smallest |dfracs| {clipped_dsh:.3e}; deterministic {det}; "
          f"max_abs_err {abs_err:.3e} | {card}")
    if (not det or not clipped_dsh > 0
            or not all(e <= tol[n] for n, (e, _) in errs.items())):
        raise RuntimeError(f"{name} disagrees with its plain "
                           "version or is not deterministic")
    return abs_err


def fused_case(dev, gen, bh: int = 32, k: int = 144, side: int = 50,
               d: int = 64) -> dict:
    """q (pre-scaled), k, v, the divisor-1 table and the shifts of the
    teacher's attention (BH = 32, K = 144, N = 2500, D = 64), kv points up
    to 25% past the bound, and random output and map cotangents."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    w = mlp_weights(1, gen, dev)
    gkv = (torch.rand(bh, k, 2, generator=gen) * 2 - 1) * kv_bound * 1.25

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    n = side * side
    return dict(q=rnd(bh, n, d, scale=d ** -0.5), k=rnd(bh, k, d),
                v=rnd(bh, k, d),
                table=cpb.cpb_table(*w, side=side, kv_bound=kv_bound),
                shifts=cpb.table_shifts(gkv.to(dev), side=side,
                                        kv_bound=kv_bound),
                g_out=rnd(bh, n, d), g_attn=rnd(bh, k, n), side=side)


def check_fused_kernels(dev, card: str) -> dict:
    """Phase 2e (K6): K6-fwd against its plain version at rate 0 and 0.1
    (the same mask), ``attn`` within ``K6_ATTN_TOL`` and ``out`` within
    ``K6_OUT_TOL`` abs; K6-bwd (with the map's own cotangent) against the
    plain version's autograd in float64, norm-relative: dq, dk, dv within
    ``K6_BWD_TOL``, dtable and dfracs within ``K6_TABLE_BWD_TOL`` or twice
    the f32 plain version's own error, whichever is larger; bitwise equal
    over two calls.  Returns the inputs (for the timings) and the errors."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb, fused_table

    gen = torch.Generator().manual_seed(7)
    c = fused_case(dev, gen)
    q, k, v, table, shifts, side = (c[n] for n in ("q", "k", "v", "table",
                                                   "shifts", "side"))
    taps, fracs = cpb.table_taps(shifts, side=side, tn=table.shape[0])
    out = {"err": 0.0, "bwd_err": 0.0}
    names = ("dq", "dk", "dv", "dtable", "dfracs")
    for rate in (0.0, 0.1):
        seed = 1234 + int(rate * 10)
        with torch.inference_mode():
            got = fused_table.fused_table_attention(q, k, v, table, shifts,
                                                    side, seed, rate)
            want = fused_table.fused_table_attention_reference(
                q, k, v, table, shifts, side, seed, rate)
        torch.cuda.synchronize()
        e_out, e_attn = ((a - b).abs().max().item() for a, b in zip(got, want))
        kept = (fused_table.dropout_keep_mask(seed, want[1].shape, rate, dev)
                .float().mean().item())
        print(f"[K6] BH={q.shape[0]} K={k.shape[1]} N={q.shape[1]} "
              f"D={q.shape[2]} rate {rate}: kept {kept:.4f}; max_abs_err out "
              f"{e_out:.3e} (tol {K6_OUT_TOL}), attn {e_attn:.3e} (tol "
              f"{K6_ATTN_TOL}) | {card}")
        if not e_out <= K6_OUT_TOL or not e_attn <= K6_ATTN_TOL:
            raise RuntimeError("K6 disagrees with its plain version")
        out["err"] = max(out["err"], e_out, e_attn)
        attn = got[1]
        kb = [fused_table.fused_table_attention_backward(
            q, k, v, table, taps, fracs, attn, c["g_out"], c["g_attn"], side,
            seed, rate) for _ in range(2)]
        torch.cuda.synchronize()
        det = all(torch.equal(a, b) for a, b in zip(*kb))
        del got, want
        ref = {}
        for dt in (torch.float64, torch.float32):
            ref[dt] = fused_table.fused_table_attention_backward_reference(
                *(c[n].to(dt) for n in ("q", "k", "v", "table")), taps,
                fracs.to(dt), c["g_out"].to(dt), c["g_attn"].to(dt), side,
                seed, rate)
            torch.cuda.empty_cache()
        errs = {n: (rel_err(g, w64), rel_err(p, w64)) for n, g, p, w64 in
                zip(names, kb[0], ref[torch.float32], ref[torch.float64])}
        tol = {n: (K6_BWD_TOL if n in ("dq", "dk", "dv")
                   else max(K6_TABLE_BWD_TOL, 2 * errs[n][1])) for n in names}
        abs_err = max((g.double() - w64).abs().max().item()
                      for g, w64 in zip(kb[0], ref[torch.float64]))
        print(f"[K6-bwd] rate {rate}: rel err vs f64, kernel / f32 plain: "
              + ", ".join(f"{n} {e:.3e} / {pe:.3e} (tol {tol[n]:.1e})"
                          for n, (e, pe) in errs.items())
              + f"; deterministic {det}; max_abs_err {abs_err:.3e} | {card}")
        if not det or not all(e <= tol[n] for n, (e, _) in errs.items()):
            raise RuntimeError("K6-bwd disagrees with its plain version or is "
                               "not deterministic")
        out["bwd_err"] = max(out["bwd_err"], abs_err)
        del kb, ref
        torch.cuda.empty_cache()
    out.update(c, taps=taps, fracs=fracs)
    return out


def run_opt_in_entries(preset, train_preset, dev, card: str) -> dict:
    """Phase 3e: the teacher's serving entry (1 batch) and training entry
    (2 steps and 1 eval batch) in each opt-in setting, every count set to
    0 just before a run and read just after: per forward 4 launches of the
    setting's forward kernel (K6, K5 or K1), per step 4 of its backward, 0
    of every other kernel (K6-bwd's count includes the K1-bwd scatter
    kernels that each of its launches runs on its ``ds``).  Returns the training runs' counts of (a) and
    (b), the main paths of K6 and K5."""
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference

    for cfg, (fwd, _) in zip(opt_in_settings(preset), OPT_IN_KERNELS):
        cfg = cfg.replace(synthetic_test_size=4)
        reset_counts()
        t0 = time.perf_counter()
        metrics, logits = inference.main(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts()
        print(f"[main] serving, {setting(cfg)}: 1 batch in {wall:.2f} s "
              f"(set-up included); launches {n}")
        check_outputs(metrics, logits, 4)
        if n != expect(**{fwd: 4}):
            raise RuntimeError(f"opt-in serving, {setting(cfg)}: launches {n}")
    runs = []
    for cfg, (fwd, bwd) in zip(opt_in_settings(train_preset), OPT_IN_KERNELS):
        runs.append(run_training_entry(
            cfg.replace(synthetic_train_size=8), dev, 2, {fwd: 4, bwd: 4},
            {fwd: 4}, card))
        torch.cuda.empty_cache()
    print("[main] fused: each K6-bwd launch above includes one launch of "
          "K1-bwd's scatter kernels (partial tables + block-order sum) on "
          "its ds; K1-bwd's own wrapper is not called, so its count is 0")
    return {"k6": runs[0], "k5": runs[1]}


def unfused_attention(cpb, q, k, v, table, shifts, side, rate):
    """The port's unfused divisor-1 composition that K6 replaces: the taps,
    K1, then ``k q^T + bias``, the softmax over K, dropout and PV, in f32."""
    import torch
    import torch.nn.functional as F

    taps, fracs = cpb.table_taps(shifts, side=side, tn=table.shape[0])
    bias = cpb.table_interp(table, taps, fracs, side).reshape(
        k.shape[0], k.shape[1], -1)
    attn = torch.softmax(torch.matmul(k, q.transpose(1, 2)) + bias, dim=1)
    return torch.matmul(F.dropout(attn, rate, True).transpose(1, 2), v), attn


def time_opt_in_kernels(cpb, k5: dict, k6: dict, card: str) -> dict:
    """Phase 6e, kernels: K5-fwd (divisor 2 and 4, f32 and the bf16 store)
    and K1-fwd with the bf16 store against their plain versions; K5-bwd
    against the plain backward (autograd through the plain forward, its
    graph kept); K6-fwd and K6-bwd (rate 0 and 0.1) against their plain
    versions and beside the port's unfused composition (K1 + matmul +
    softmax + dropout + matmul, forward, and its backward by autograd,
    K1-bwd included).  Returns the times of the kernels line: K5 at
    divisor 4 in f32, K6 at rate 0.1 (the preset's dropout)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import fused_table

    side, times = 50, {}
    with torch.inference_mode():
        c1 = k5["k1_bf16"]
        ms, plain = interleaved_ms(
            lambda: cpb.table_interp_reference(c1["table"], c1["taps"],
                                               c1["fracs"], side,
                                               out_dtype=torch.bfloat16),
            lambda: cpb.table_interp(c1["table"], c1["taps"], c1["fracs"],
                                     side, torch.bfloat16), 50)
        bms, by = table_bounds(c1["table"], c1["taps"], side, 2)[0]
        print(f"[time] K1-fwd bf16 store R=4608 side=50: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms; bound {bms:.4f} ms by {by} | {card}")
        times["k1_bf16"] = (ms, plain)
        for d in (2, 4):
            c = k5[d]
            for dt in (torch.float32, torch.bfloat16):
                ms, plain = interleaved_ms(
                    lambda: cpb.table_interp_reference(
                        c["table"], c["taps"], c["fracs"], side, d, dt),
                    lambda: cpb.table_interp_strided(
                        c["table"], c["taps"], c["fracs"], side, d, dt), 50)
                nbytes = c["dout"].numel() * (4 if dt == torch.float32 else 2)
                print(f"[time] K5-fwd divisor {d} {str(dt)[6:]} store "
                      f"R=4608 side=50 tn={c['table'].shape[0]}: kernel "
                      f"{ms:.4f} ms, plain {plain:.4f} ms; "
                      f"{nbytes / ms / 1e9:.3f} TB/s written = "
                      f"{nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s | {card}")
                times[("k5_fwd", d, dt)] = (ms, plain)
    for d in (2, 4):
        c = k5[d]
        t = c["table"].detach().requires_grad_()
        f = c["fracs"].detach().requires_grad_()
        o = cpb.table_interp_reference(t, c["taps"], f, side, d)
        ms, plain = interleaved_ms(
            lambda: torch.autograd.grad(o, (t, f), c["dout"],
                                        retain_graph=True),
            lambda: cpb.table_interp_strided_backward(
                c["table"], c["taps"], c["fracs"], c["dout"], side, d), 20)
        del o
        print(f"[time] K5-bwd divisor {d} R=4608 side=50: kernel {ms:.4f} ms,"
              f" plain (autograd) {plain:.4f} ms; "
              f"{4 * c['dout'].numel() / ms / 1e9:.3f} TB/s of dw read | "
              f"{card}")
        times[("k5_bwd", d)] = (ms, plain)
        torch.cuda.empty_cache()

    q, k, v, table, shifts, side = (k6[n] for n in ("q", "k", "v", "table",
                                                     "shifts", "side"))
    taps, fracs = k6["taps"], k6["fracs"]
    for rate in (0.0, 0.1):
        seed = 99
        with torch.inference_mode():
            fwd = interleaved_ms(
                lambda: fused_table.fused_table_attention_reference(
                    q, k, v, table, shifts, side, seed, rate),
                lambda: fused_table.fused_table_attention(
                    q, k, v, table, shifts, side, seed, rate), 10)
            unfused = cuda_ms(lambda: unfused_attention(
                cpb, q, k, v, table, shifts, side, rate), 10)
            attn = fused_table.fused_table_attention(q, k, v, table, shifts,
                                                     side, seed, rate)[1]
        leaves = [x.detach().requires_grad_()
                  for x in (q, k, v, table, shifts)]
        outs = fused_table.fused_table_attention_reference(*leaves, side,
                                                           seed, rate)
        cot = (k6["g_out"], k6["g_attn"])
        bwd = interleaved_ms(
            lambda: torch.autograd.grad(outs, leaves, cot, retain_graph=True),
            lambda: fused_table.fused_table_attention_backward(
                q, k, v, table, taps, fracs, attn, *cot, side, seed, rate), 5)
        del outs
        uouts = unfused_attention(cpb, *leaves, side, rate)
        unfused_bwd = cuda_ms(lambda: torch.autograd.grad(
            uouts, leaves, cot, retain_graph=True), 5)
        del uouts
        torch.cuda.empty_cache()
        for name, (ms, plain), un in (("K6-fwd", fwd, unfused),
                                      ("K6-bwd", bwd, unfused_bwd)):
            print(f"[time] {name} BH=32 K=144 N=2500 D=64 rate {rate}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, the port's unfused "
                  f"composition (K1 + matmul + softmax + dropout + matmul"
                  f"{', backward by autograd' if name == 'K6-bwd' else ''}) "
                  f"{un:.4f} ms | {card}")
        times[("k6", rate)] = (fwd, bwd, unfused, unfused_bwd)
    return times


def time_opt_in_settings(preset, train_preset, batch, dev, card: str) -> None:
    """Phase 6e, end to end: the teacher's eval forward (bags/s, median and
    p80 of 30, and a profiled forward) and train step (30 steps and a
    profiled step) in each opt-in setting; in (c) the CPB bias is checked
    to come out of the table in bf16."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    x = model_inputs(batch, dev, "teacher")
    for cfg in opt_in_settings(preset):
        model = define_net(cfg, dev)
        dtypes = set()
        hooks = [m.register_forward_hook(
            lambda mod, args, out: dtypes.add(out.dtype))
            for name, m in model.named_modules() if name.endswith(
                "rel_pos_bias")]
        with torch.inference_mode():
            model(**x)
            for h in hooks:
                h.remove()
            ms = ms_samples(lambda: model(**x), 30)
            med, p80 = median(ms), ms[int(0.8 * len(ms))]
            print(f"[time] eval forward B=4 fixdim=2500 {setting(cfg)}: "
                  f"median {med:.3f} ms/batch = {4000.0 / med:.1f} bags/s, "
                  f"p80 {p80:.3f} ms = {4000.0 / p80:.1f} bags/s (30 "
                  f"forwards); CPB bias dtypes {sorted(map(str, dtypes))} "
                  f"| {card}")
            profile(f"eval forward ({setting(cfg)})", lambda: model(**x))
        if cfg.cpb_table_bf16 and dtypes != {torch.bfloat16}:
            raise RuntimeError("cpb_table_bf16: the CPB bias is not bf16")
        del model
        torch.cuda.empty_cache()
    for cfg in opt_in_settings(train_preset):
        time_train_steps((cfg,), batch, dev, card)
        torch.cuda.empty_cache()


def check_nk_kernels(dev, card: str) -> dict:
    """Phase 2f: K2-nk at the teacher's shape (32 x 2500 x 144, O = 1) and
    at the 1-D attention's (16 x 2501 x 625, O = 2, the coordinate padded
    with a zero second one and a zero row of ``w1``): the forward bitwise
    equal to K2's transposed and within ``K2_TOL`` of its plain version;
    K2-nk-bwd against the plain backward in float64 (row chunks) within
    ``K2_BWD_TOL``, bitwise equal over two calls and to K2-bwd on the
    transposed cotangent.  Then K7 at q ``[32, 2500, 64]``, k and v ``[32,
    144, 64]`` in both layouts at rate 0 and 0.1, and at the 1-D
    attention's q ``[16, 2501, 16]``, k and v ``[16, 625, 16]`` (the kv
    points in four chunks) at rate 0.1: out and attn within
    ``K2_TOL`` of the plain version, "nk" equal to "kn" transposed bitwise;
    K7-bwd against the plain version's autograd in float64 (batch-head
    chunks, the same dropout mask): dq, dk, dv within ``K6_BWD_TOL``,
    grid_kv and the weights within ``K2_BWD_TOL`` or twice the f32 plain
    version's own error, whichever is larger, the CPB output bias below
    ``K7_DB3_FLOOR`` of its weight's, bitwise equal over two calls.
    Returns the inputs (for the timings) and the errors."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb, fused_exact

    gen = torch.Generator().manual_seed(8)
    side, kv_bound = 50, cpb.kv_bound_2d(4.0, 12, 12)
    grid2 = normalized_grid_flat(side, dev)
    w2 = list(mlp_weights(2, gen, dev))
    w2[0][1].zero_()
    n_q = 2501
    cases = {
        "2-D": (grid2, ((torch.rand(32, 144, 2, generator=gen) * 2 - 1)
                        * kv_bound).to(dev), mlp_weights(1, gen, dev)),
        "1-D": (torch.stack([torch.linspace(-1, 1, n_q, device=dev),
                             torch.zeros(n_q, device=dev)], dim=-1),
                torch.stack([(torch.rand(16, 625, generator=gen) * 2 - 1)
                             .to(dev), torch.zeros(16, 625, device=dev)],
                            dim=-1), w2)}
    out = {"err": 0.0, "bwd_err": 0.0}
    names = ("dgrid_kv", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    for label, (gq, gkv, w) in cases.items():
        BG, K, N, O = gkv.shape[0], gkv.shape[1], gq.shape[0], w[4].shape[1]
        with torch.inference_mode():
            nk = cpb.cpb_bias_nk(gq, gkv, *w)
            same = torch.equal(nk, cpb.cpb_bias_transposed(gq, gkv, *w)
                               .transpose(-1, -2))
            err = (nk - cpb.cpb_bias_nk_reference(gq, gkv, *w)).abs().max(
                ).item()
        print(f"[K2-nk] {label} BG={BG} N={N} K={K} O={O} out "
              f"{tuple(nk.shape)}: bitwise equal to K2 transposed {same}; "
              f"max_abs_err vs plain {err:.3e} (tol {K2_TOL}) | {card}")
        if not same or not err <= K2_TOL:
            raise RuntimeError("K2-nk disagrees with K2 or its plain version")
        out["err"] = max(out["err"], err)
        dbias = torch.randn(nk.shape, generator=gen).to(dev)
        del nk
        kb = [cpb.cpb_bias_nk_backward(gq, gkv, *w, dbias) for _ in range(2)]
        kn = cpb.cpb_bias_transposed_backward(
            gq, gkv, *w, dbias.transpose(-1, -2).contiguous())
        torch.cuda.synchronize()
        det = all(torch.equal(a, b) for a, b in zip(*kb))
        same = all(torch.equal(a, b) for a, b in zip(kb[0], kn))
        dbias_kn = dbias.transpose(-1, -2)
        want = exact_backward_in_chunks(cpb, gq, gkv, w, dbias_kn,
                                        torch.float64)
        plain = exact_backward_in_chunks(cpb, gq, gkv, w, dbias_kn,
                                         torch.float32)
        errs = {n: (rel_err(g, ww), rel_err(pp, ww))
                for n, g, pp, ww in zip(names, kb[0], plain, want)}
        bwd_err = max((g.double() - ww).abs().max().item()
                      for g, ww in zip(kb[0], want))
        print(f"[K2-nk-bwd] {label} rel err vs f64, kernel / f32 plain: "
              + ", ".join(f"{n} {e:.2e} / {pe:.2e}"
                          for n, (e, pe) in errs.items())
              + f" (tol {K2_BWD_TOL['dw']}); deterministic {det}; bitwise "
              f"equal to K2-bwd on the transposed cotangent {same}; "
              f"max_abs_err {bwd_err:.3e} | {card}")
        if not det or not same or not all(
                e <= K2_BWD_TOL["dgrid_kv" if n == "dgrid_kv" else "dw"]
                for n, (e, _) in errs.items()):
            raise RuntimeError("K2-nk-bwd disagrees with its plain version "
                               "or is not deterministic")
        out["bwd_err"] = max(out["bwd_err"], bwd_err)
        out[label] = dict(grid_q=gq, gkv=gkv, w=w, dbias=dbias)
        del kb, kn, want, plain
        torch.cuda.empty_cache()

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def k7_args(BH, K, D, gq, gkv, padded=False):
        w = list(mlp_weights(1, gen, dev))
        if padded:  # the 1-D attention's zero row of w1 for its zero y
            w[0][1].zero_()
        return (rnd(BH, gq.shape[0], D, scale=D ** -0.5), rnd(BH, K, D),
                rnd(BH, K, D), gq, gkv, *w)

    out.update(k7_err=0.0, k7_bwd_err=0.0)
    # the teacher's shape (one chunk of kv points: everything on the SM), at
    # dropout 0 and 0.1; then the 1-D attention's (K = 625: four chunks, the
    # map and dp parked in device memory), at dropout 0.1, with its padded
    # coordinate: every y difference is exactly 0, where the kernels take
    # the derivative of sign(p) log1p(|p|) as 1 and autograd as 0, so w1's
    # y row is 0 as in the attention
    k7_cases = (
        ("2-D", k7_args(32, 144, 64, grid2, ((torch.rand(
            32, 144, 2, generator=gen) * 2 - 1) * kv_bound).to(dev)),
         (0.0, 0.1), 8),
        ("1-D", k7_args(16, 625, 16, cases["1-D"][0], cases["1-D"][1],
                        padded=True), (0.1,), 4))
    names7 = ("dq", "dk", "dv") + names
    for label, args, rates, rows in k7_cases:
        BH, N, D = args[0].shape
        K = args[1].shape[1]
        g_out, g_attn = rnd(BH, N, D), rnd(BH, N, K)
        if label == "2-D":
            out["k7"] = dict(args=args, g_out=g_out, g_attn=g_attn)
        for rate in rates:
            seed = 4321 + int(rate * 10)
            with torch.inference_mode():
                got = {lay: fused_exact.fused_exact_attention(*args, seed,
                                                              rate, lay)
                       for lay in ("nk", "kn")}
                want = fused_exact.fused_exact_attention_reference(
                    *args, seed, rate)
            torch.cuda.synchronize()
            same = (torch.equal(got["nk"][0], got["kn"][0]) and torch.equal(
                got["nk"][1], got["kn"][1].transpose(1, 2)))
            e_out = (got["nk"][0] - want[0]).abs().max().item()
            e_attn = (got["nk"][1] - want[1]).abs().max().item()
            print(f"[K7] {label} BH={BH} N={N} K={K} D={D} rate {rate}: "
                  f"max_abs_err out {e_out:.3e}, attn {e_attn:.3e} (tol "
                  f"{K2_TOL}); nk and kn bitwise equal (out, attn transposed)"
                  f" {same} | {card}")
            if not same or not max(e_out, e_attn) <= K2_TOL:
                raise RuntimeError("K7 disagrees with its plain version or "
                                   "between layouts")
            out["k7_err"] = max(out["k7_err"], e_out, e_attn)
            del want
            for lay in ("nk", "kn"):
                ga = (g_attn if lay == "nk"
                      else g_attn.transpose(1, 2).contiguous())
                kb = [fused_exact.fused_exact_attention_backward(
                    *args, got[lay][1], g_out, ga, seed, rate, lay)
                    for _ in range(2)]
                torch.cuda.synchronize()
                det = all(torch.equal(a, b) for a, b in zip(*kb))
                ref = {dt: fused_exact_backward_in_chunks(
                    args, g_out, ga, seed, rate, lay, dt, rows)
                    for dt in (torch.float64, torch.float32)}
                errs = {n: (rel_err(g, ww), rel_err(pp, ww))
                        for n, g, pp, ww in zip(names7[:9], kb[0],
                                                ref[torch.float32],
                                                ref[torch.float64])}
                b3 = kb[0][9].abs().max().item() / kb[0][8].abs().max().item()
                abs_err = max((g.double() - ww).abs().max().item()
                              for g, ww in zip(kb[0][:9], ref[torch.float64]))
                tol = {n: K6_BWD_TOL if n in ("dq", "dk", "dv") else max(
                    K2_BWD_TOL["dgrid_kv" if n == "dgrid_kv" else "dw"],
                    2 * errs[n][1]) for n in names7[:9]}
                print(f"[K7-bwd] {label} {lay} rate {rate}: rel err vs f64, "
                      "kernel / f32 plain (tol): " + ", ".join(
                          f"{n} {e:.2e} / {pe:.2e} ({tol[n]:.1e})"
                          for n, (e, pe) in errs.items())
                      + f"; |db3| / |dw3| {b3:.2e} (floor {K7_DB3_FLOOR}); "
                      f"deterministic {det}; the mask of the forward in the "
                      f"backward: dv within tol; max_abs_err {abs_err:.3e} "
                      f"| {card}")
                if (not det or not b3 <= K7_DB3_FLOOR
                        or not all(e <= tol[n] for n, (e, _) in errs.items())):
                    raise RuntimeError("K7-bwd disagrees with its plain "
                                       "version or is not deterministic")
                out["k7_bwd_err"] = max(out["k7_bwd_err"], abs_err)
                del kb, ref
                torch.cuda.empty_cache()
            del got
    return out


def fused_exact_backward_in_chunks(args, g_out, g_attn, seed, rate, layout,
                                   dtype, rows: int = 8) -> tuple:
    """K7's plain backward in ``dtype``, ``rows`` batch-heads at a time (the
    weight cotangents summed over the chunks, the dropout mask of the whole
    call), so that float64 fits the card: a chunk's [8, 2500, 144, 32]
    float64 hiddens are 740 MB each."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import fused_exact

    q, k, v, gq, gkv, *w = args
    parts = []
    for i in range(0, q.shape[0], rows):
        s = slice(i, i + rows)
        parts.append(fused_exact.fused_exact_attention_backward_reference(
            *(t[s].to(dtype) for t in (q, k, v)), gq.to(dtype),
            gkv[s].to(dtype), *(t.to(dtype) for t in w), g_out[s].to(dtype),
            g_attn[s].to(dtype), seed, rate, layout, bh0=i))
    return tuple(torch.cat([p[j] for p in parts]) for j in range(4)) + tuple(
        sum(p[j] for p in parts) for j in range(4, 10))


def run_nk_paths(preset, train_preset, dev, card: str,
                 k7_shape=(32, 2500, 144, 64)) -> dict:
    """Phase 3f: the teacher at the preset's widths built with
    ``define_net(cfg, attn_layout="nk")`` (the divisor 1 and the bf16
    streams of the preset: "nk" takes the exact CPB whatever the divisor,
    and bf16 only as the matmuls' operands): 3 eval batches through the
    ``Evaluator`` (K2-nk-fwd 4 per forward) and 2 train steps through
    ``train/steps.py`` (K2-nk-fwd and K2-nk-bwd 4 each per step), every
    other kernel 0; deformpathomic at attn_dim 1 in "nk" (K2-nk at O = 2):
    one eval forward and one train step, 2 launches each; then K7 through
    its public entry (the op, as the JAX package exposes it; no module
    reaches it): one forward and ``backward()`` in each layout at the
    preset's dropout.  Every count set to 0 just before a run and read just
    after.  Returns the train run's counts (K2-nk's main path) and the op
    run's (K7's)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.ops import fused_exact
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        Evaluator)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    result = {}
    for cfg, eval_batches, per_fwd in (
            (preset.replace(synthetic_test_size=12), 3, 4),
            (preset.replace(mode="deformpathomic", attn_dim=1,
                            synthetic_test_size=4), 1, 2)):
        model = define_net(cfg, dev, attn_layout="nk")
        model_type = "fused" if cfg.mode == "deformpathomic" else "teacher"
        evaluator = Evaluator(model, cfg, dev, model_type)
        loader = inference.build_fold0_test_loader(cfg)
        reset_counts()
        t0 = time.perf_counter()
        logits, labels = evaluator.logits(loader)
        metrics = evaluator.metrics(logits, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts()
        print(f"[main] nk layout, serving through the Evaluator, "
              f"{setting(cfg)}: {eval_batches} batches in {wall:.2f} s; "
              f"launches {n} | {card}")
        check_outputs(metrics, logits, 4 * eval_batches,
                      n_metrics=7 * (3 if model_type == "teacher" else 1))
        if n != expect(k2nk_fwd=per_fwd * eval_batches):
            raise RuntimeError(f"nk serving: launches {n}")
        steps = 2 if cfg.mode == "teacher" else 1
        tcfg = train_preset.replace(mode=cfg.mode, attn_dim=cfg.attn_dim,
                                    synthetic_train_size=4 * steps)
        train_ds, test_ds = train_main.synthetic_fold_datasets(tcfg, 0)
        train_loader, _ = train_main.make_loaders(tcfg, train_ds, test_ds)
        opt = make_optimizer(tcfg, model.parameters())
        step = make_train_step(model, tcfg, opt,
                               make_scheduler(tcfg, opt, steps))
        reset_counts()
        t0 = time.perf_counter()
        losses = [step(batch_to_tensors(b, dev))["loss"]
                  for b in train_loader]
        losses = [float(x) for x in losses]
        wall = time.perf_counter() - t0
        n = counts()
        print(f"[train] nk layout, {setting(tcfg)}: {len(losses)} steps in "
              f"{wall:.2f} s; losses {losses}; launches {n} | {card}")
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"nk train steps: bad losses {losses}")
        if n != expect(k2nk_fwd=per_fwd * steps, k2nk_bwd=per_fwd * steps):
            raise RuntimeError(f"nk train steps: launches {n}")
        if cfg.mode == "teacher":
            result["k2nk"] = n
        del model, evaluator, step, opt
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(9)
    BH, N, K, D = k7_shape
    kv_bound = 1.0 + 8.0 / 11
    leaves = [(torch.randn(*sh, generator=gen) * sc).to(dev).requires_grad_()
              for sh, sc in (((BH, N, D), D ** -0.5), ((BH, K, D), 1.0),
                             ((BH, K, D), 1.0))]
    gkv = ((torch.rand(BH, K, 2, generator=gen) * 2 - 1) * kv_bound).to(dev)
    leaves.append(gkv.requires_grad_())
    leaves += [t.requires_grad_() for t in mlp_weights(1, gen, dev)]
    grid_q = normalized_grid_flat(math.isqrt(N), dev)
    reset_counts()
    for layout in ("nk", "kn"):
        out, attn = fused_exact.fused_exact_attention(
            *leaves[:3], grid_q, *leaves[3:], 77, preset.dropout_rate, layout)
        ((out ** 2).sum() + torch.sin(attn).sum()).backward()
    torch.cuda.synchronize()
    n = counts()
    finite = all(torch.isfinite(t.grad).all().item() for t in leaves)
    print(f"[main] K7 through its public entry (autograd, both layouts, rate "
          f"{preset.dropout_rate}): launches {n}; gradients finite {finite} "
          f"| {card}")
    if n != expect(k7_fwd=2, k7_bwd=2) or not finite:
        raise RuntimeError(f"K7's entry: launches {n}")
    result["k7"] = n
    return result


def time_nk(nk: dict, preset, train_preset, batch, dev, card: str) -> dict:
    """Phase 6f: K2-nk-fwd and K2-nk-bwd at both shapes against their plain
    versions (the backward's: autograd through the plain forward, its graph
    kept), K7-fwd and K7-bwd in both layouts at rate 0.1 against theirs,
    with their bounds; the "nk" teacher's eval forward and train step
    (bags/s, median and p80) and a profiled forward and step (device-busy
    share).  Returns the times of the kernels line: K2-nk at the teacher's
    shape, K7 in "nk"."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.ops import cpb, fused_exact
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    times = {}
    for label in ("2-D", "1-D"):
        c = nk[label]
        gq, gkv, w, dbias = c["grid_q"], c["gkv"], c["w"], c["dbias"]
        with torch.inference_mode():
            fwd = interleaved_ms(
                lambda: cpb.cpb_bias_nk_reference(gq, gkv, *w),
                lambda: cpb.cpb_bias_nk(gq, gkv, *w), 10 if label == "2-D"
                else 3)
        leaves = [gkv.detach().requires_grad_()] + [
            x.detach().requires_grad_() for x in w]
        out = cpb.cpb_bias_nk_reference(gq, *leaves)
        bwd = interleaved_ms(
            lambda: torch.autograd.grad(out, leaves, dbias, retain_graph=True),
            lambda: cpb.cpb_bias_nk_backward(gq, gkv, *w, dbias), 3)
        del out, leaves
        torch.cuda.empty_cache()
        points, O = dbias.numel() // w[4].shape[1], w[4].shape[1]
        n_q = gq.shape[0]
        fb = bound(4 * (dbias.numel() + 2 * n_q + gkv.numel()),
                   k2_fwd_flops(points, O))
        bb = bound(4 * (dbias.numel() + 2 * gkv.numel() + 2 * n_q),
                   k2_bwd_flops(points, O))
        for name, (ms, plain), (bms, by) in (("K2-nk-fwd", fwd, fb),
                                             ("K2-nk-bwd", bwd, bb)):
            print(f"[time] {name} {label} {gkv.shape[0]}x{n_q}x{gkv.shape[1]}"
                  f" O={O}: kernel {ms:.4f} ms, plain"
                  f"{' (autograd)' * (name == 'K2-nk-bwd')} {plain:.4f} ms; "
                  f"bound {bms:.4f} ms by {by} | {card}")
        times[label] = dict(fwd=(fwd, fb), bwd=(bwd, bb))

    c7 = nk["k7"]
    args, g_out = c7["args"], c7["g_out"]
    BH, N, D = args[0].shape
    K = args[1].shape[1]
    b7 = k7_bounds(BH, N, K, D)
    rate, seed = 0.1, 99
    for lay in ("nk", "kn"):
        ga = (c7["g_attn"] if lay == "nk"
              else c7["g_attn"].transpose(1, 2).contiguous())
        with torch.inference_mode():
            fwd = interleaved_ms(
                lambda: fused_exact.fused_exact_attention_reference(
                    *args, seed, rate, lay),
                lambda: fused_exact.fused_exact_attention(*args, seed, rate,
                                                          lay), 5)
            attn = fused_exact.fused_exact_attention(*args, seed, rate,
                                                     lay)[1]
        leaves = [x.detach().requires_grad_() for x in args[:3] + args[4:]]
        outs = fused_exact.fused_exact_attention_reference(
            *leaves[:3], args[3], *leaves[3:], seed, rate, lay)
        bwd = interleaved_ms(
            lambda: torch.autograd.grad(outs, leaves, (g_out, ga),
                                        retain_graph=True),
            lambda: fused_exact.fused_exact_attention_backward(
                *args, attn, g_out, ga, seed, rate, lay), 3)
        del outs, leaves, attn
        torch.cuda.empty_cache()
        for name, (ms, plain), (bms, by) in (("K7-fwd", fwd, b7[0]),
                                             ("K7-bwd", bwd, b7[1])):
            print(f"[time] {name} {lay} BH={BH} N={N} K={K} D={D} rate "
                  f"{rate}: kernel {ms:.4f} ms, plain"
                  f"{' (autograd)' * (name == 'K7-bwd')} {plain:.4f} ms; "
                  f"bound {bms:.4f} ms by {by} | {card}")
        times[lay] = dict(fwd=(fwd, b7[0]), bwd=(bwd, b7[1]))

    x = model_inputs(batch, dev, "teacher")
    model = define_net(preset, dev, attn_layout="nk")
    with torch.inference_mode():
        ms = ms_samples(lambda: model(**x), 30)
        med, p80 = median(ms), ms[int(0.8 * len(ms))]
        print(f"[time] eval forward B=4 fixdim=2500 nk layout, "
              f"{setting(preset)}: median {med:.3f} ms/batch = "
              f"{4000.0 / med:.1f} bags/s, p80 {p80:.3f} ms = "
              f"{4000.0 / p80:.1f} bags/s (30 forwards) | {card}")
        profile(f"eval forward (nk layout, {setting(preset)})",
                lambda: model(**x))
    del model
    model = define_net(train_preset, dev, attn_layout="nk")
    opt = make_optimizer(train_preset, model.parameters())
    step = make_train_step(model, train_preset, opt,
                           make_scheduler(train_preset, opt, 1000))
    xt = batch_to_tensors(batch, dev)
    ms = ms_samples(lambda: step(xt), 20)
    med, p80 = median(ms), ms[int(0.8 * len(ms))]
    print(f"[time] train step B=4 fixdim=2500 nk layout, "
          f"{setting(train_preset)}: median {med:.3f} ms = "
          f"{4000.0 / med:.1f} train bags/s, p80 {p80:.3f} ms = "
          f"{4000.0 / p80:.1f} bags/s (20 steps) | {card}")
    profile(f"train step (nk layout, {setting(train_preset)})",
            lambda: step(xt), n=3)
    del model, step, opt
    torch.cuda.empty_cache()
    return times


def k7_bounds(BH: int, N: int, K: int, D: int) -> tuple:
    """``(forward, backward)`` bounds of K7: the forward reads q, k, v,
    grid_q, grid_kv and the weights and writes out and attn, and does K2's
    MLP flops at every (query, kv) point plus the sim and PV products (2
    flops a multiply-add); the backward also reads attn and both
    cotangents and writes dq, dk, dv, dgrid_kv and the weight cotangents,
    and does K2-bwd's flops plus twice the products (dp, dv, dq, dk)."""
    points = BH * N * K
    macs = BH * N * K * D
    qkv = 4 * (BH * N * D + 2 * BH * K * D)
    small = 4 * (2 * N + 2 * BH * K + 2 * cpb_param_count(1))
    fwd = bound(qkv + small + 4 * (BH * N * D + points),
                k2_fwd_flops(points, 1) + 4 * macs)
    bwd = bound(2 * qkv + small + 4 * (BH * N * D + 2 * points),
                k2_bwd_flops(points, 1) + 8 * macs)
    return fwd, bwd


def cpb_param_count(o: int, hid: int = 32) -> int:
    return hid * (2 + 1 + hid + 1) + (hid + 1) * o


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

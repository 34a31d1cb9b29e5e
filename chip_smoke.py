#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``disentangled_multimodal_learning_tpu_torch`` (never JAX) through its
serving entry and its training entry, for the teacher, the student,
deformpathomic, distillation, multiscale and the nine baselines (and the
teacher on the survival task and on a demo cohort of real-data files), at
the full width of ``config/config_mine_diag2021.yaml``
(fixdim 2500, B=4, dims 128, 8 heads; the student with ``path_cluster_num``
0.0008, 2 clusters per bag; deformpathomic at ``attn_dim`` 1, where the cls
token makes N = 2501 and the 1-D attention K = 625, and at ``attn_dim`` 2
with ``return_vgrid``) with seeded random weights:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, run
   together), prints the ptxas figures of the K2 kernels' instances
   (registers, spills, barriers) with the dynamic shared memory of a
   block, those of the K6 kernels with their tensor-core (HMMA) and
   f32 FMA (FFMA) instruction counts in the SASS, and those of K1-bwd's,
   K5-bwd's, K4-bwd's, K1-fwd's, K5-fwd's and K7-fwd's instances (K7-fwd
   with its HMMA and FFMA counts), and holds each forward
   kernel against its plain PyTorch version on the card at production
   shapes:
   K1 (table CPB, R=4608, side=50, tn=139, clipped rows included) bitwise
   (and so within 1e-5 abs), then at odd shapes (side 7 and 33, R 1 and 5)
   bitwise, K2 (exact CPB, BH=32, K=144, N=2500, O=1 and O=2) within 1e-4
   abs on a bias of O(1) (FMA contraction and another sum order);
2b. holds K1-bwd (same shapes) and K2-bwd (O=1 and O=2) against their plain
   versions in float64 on the card, norm-relative (``K1_BWD_TOL``,
   ``K2_BWD_TOL``, with the f32 plain version's own error printed beside
   the kernel's, and the shift cotangents dfy and dfx apart), and checks
   that two calls give bitwise-equal results;
   then K2 and K2-bwd at an odd shape (BH 3 x K 7 x N 130, O=3) within
   ``K2_TOL`` and ``K2_BWD_TOL``, bitwise over two calls;
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
   forward (bags/s) with CUDA events, after warm-up (a kernel's calls are
   queued behind a spin of the card, so that the host's time to launch
   them is not counted in theirs), with K1's bound (K1 also with the L2
   cache flushed before each call, since its 46 MB output fits the 50 MB
   L2), and prints a torch.profiler table of the preset forward with the
   device's idle share;
6b. times each backward kernel against the plain backward (autograd
   through the plain forward, its graph kept by ``retain_graph``), the
   train step (bags/s, median and p80 of 30 steps) at divisor 1 and 0, and
   profiles its steps at divisor 0 and at the preset (device-busy share);
2c. holds K3-knn and K3-parent (the streamed DPC-KNN passes) against their
   plain versions at B=4, N=2500, C=128, k=5 on LayerNormed random tokens
   and on bags whose second half repeats one vector of +-1 entries (its
   distances are exactly 0 in any summation order, so the ties are exact),
   within ``K3_TOL_ULPS * C * 2^-24 * max|x|^2`` (the f32 plain version's
   own error against float64 printed beside), bitwise equal over two
   calls, and the whole assignment (centres and clusters) against the
   plain version on the CPU, exactly; then the kernels the same way at the
   split and tile edges (B=1, N=2501, C=12, k=8); phase 2 prints
   ``[K3 ptxas]`` and ``[K3 SASS]`` lines for their instances;
3c. runs the student serving entry at the preset (3 batches: per batch
   K3-knn 2, K3-parent 2, K1-fwd 2, K2 0) and at divisor 0 (1 batch: K2-fwd
   2, K1 0), and the student training entry (3 steps and 1 eval batch: per
   step K3 2 + 2, K1-fwd 2, K1-bwd 2);
5c. compares one f32 student forward (logits within 1e-4) and one f32
   ``deterministic_training`` student step on the card with the CPU;
6c. times K3 against its plain versions, with its bound (the dots as f32
   FMAs over 67 TFLOP/s: the committed design runs no tensor cores), and
   the student's eval forward and train step (bags/s, median and p80), and
   profiles one student train step (device-busy share);
2d. holds K4-fwd (the 1-D table CPB, R = 10,000 rows of B=4 x G=4 x K=625,
   O=2, n_q=2501, clipped rows included) against its plain version within
   ``K4_TOL`` abs, and K4-bwd against its plain version in float64 within
   ``K4_BWD_TOL`` norm-relative, bitwise equal over two calls, every
   clipped row's shift cotangent kept, at the wrapper's plan, at a forced
   small row-group count, and at an odd shape (n_q 37, kv 3, 21 rows in
   groups of 6); then K2 at
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
6d. times K4-fwd, K4-bwd and K2 at the 1-D shape (O=2) against their
   plain versions, with their bounds, the deformpathomic eval forward and train step of
   each setting (bags/s, median and p80), and profiles one forward and one
   train step of each (device-busy share);
2e. holds K1-fwd with the bf16 store (``cpb_table_bf16``; also at phase
   2's odd shapes) and K5-fwd (the
   table CPB at divisor 2 and 4, tn 274 and 544, f32 and bf16 store, R =
   4608 rows of side 50, clipped rows included) bitwise against their plain
   versions, K1-bwd with a bf16 cotangent (within ``K1_BWD_TOL``) and
   K5-bwd (f32 and bf16 cotangents, within ``K5_BWD_TOL``) against their
   plain version in float64, deterministic, every clipped row's shift
   cotangent kept; K6-fwd (the fused table attention, BH=32, K=144,
   N=2500, D=64) against its plain version at dropout 0 and 0.1 with the
   same mask, and K6-bwd against the plain version's autograd in float64,
   both also at an odd shape (BH 3, K 17, side 11, D 12) and bitwise
   equal over two calls;
3e. runs the teacher's serving entry (1 batch) and training entry (2
   steps and 1 eval batch) in the three opt-in settings of the preset:
   (a) ``fused_table_attention`` (K6-fwd 4 per forward, K6-bwd 4 per step,
   K1's wrappers never; each K6-bwd launch also runs K1-bwd's two kernels
   on its ``ds``, counted as part of K6-bwd), (b) ``cpb_table_divisor 4`` (K5-fwd and K5-bwd the same way,
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
   over two calls and to K2-bwd on the transposed cotangent, and both at
   phase 2b's odd shape the same way; K7 (the fused
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
   profiled call each);
3g. at the preset, with the checkpoints in a temporary directory under
   ``build/``: the teacher's training entry (3 steps) writes a
   metric-stamped checkpoint; the distillation training entry restores it
   (``checkpoints_teacher``) and trains 2 epochs of 3 steps with the
   teacher-output cache, with exact counts per epoch (epoch 1, every batch
   a miss: per step K1-fwd 4 + 2, K1-bwd 2, K3-knn 2, K3-parent 2; epoch
   2, every batch a hit: K1-fwd 2 per step, the teacher's never; each
   epoch's eval batch the student's forward) and the cache's 3 misses and
   3 hits; one epoch with ``distill_teacher_cache false`` runs the teacher
   every step; the serving entry in distillation mode, restored from the
   student's checkpoint, gives the logits of that run's final evaluation
   bitwise; the survival preset (``config/config_mine_surv.yaml``, B 8)
   trains its teacher 3 steps and prints a finite c-index per tag;
5g. compares one f32 ``deterministic_training`` distillation step on the
   card with the CPU (as 5c the student), and a distillation fold of 2
   epochs stopped after epoch 1's rolling checkpoint and resumed with the
   uninterrupted fold: epoch 2's losses within ``RESUME_LOSS_TOL``;
6g. times the distillation train step, uncached and cached (a replay from
   the cache timed with it): bags/s, median and p80 of 30 steps, a
   profiled call each (device-busy share); and a cache fill and a replay
   alone;
3h. runs the multiscale training entry at the preset (a teacher and a
   student per magnification; 1 fold, 3 steps, then the final evaluation),
   its checkpoint in a temporary directory under ``build/``, with exact
   counts (per step K1-fwd 6, K1-bwd 6, K3-knn 2, K3-parent 2; per eval
   batch K1-fwd 6, K3 2 + 2) and every loss finite; 1 step at divisor 0
   (K2-fwd and K2-bwd 6 each, K1 never); the serving entry in multiscale
   mode, restored from the fold's checkpoint, gives the final evaluation's
   logits bitwise on all five tags (tea10, tea20, stu10, stu20, stus);
5h. compares the f32 multiscale forward (five logits within
   ``LOGITS_TOL``) and one f32 ``deterministic_training`` multiscale step
   on the card with the CPU (``STEP_LOSS_TOL``, ``GRAD_TOL``,
   ``ZERO_GRAD_FLOOR``);
6h. times the multiscale eval forward and train step (bags/s, median and
   p80; a profiled call each: device-busy share);
3i. writes the demo cohorts (``data/demo_cohort.py``: TCGA 10 slides of 8
   patients, IvYGAP 6 with its 20x bags packed, CPTAC 6; 431 gene columns,
   59 tumor and 361 immune genes; ``[n, 1024]`` f32 bags, n 1,600, 2,500
   or 3,100; ~0.5 GB) into a temporary directory under ``build/`` and runs
   the training entry on them (TCGA + IvYGAP co-training, 2 folds, split
   dumps: the fold sizes printed, no patient in both halves; the teacher's
   exact counts), fold 0 with ``buckets 1600,2500`` (every batch of one
   bucket, sides printed, a train batch at side 40 and one at 50, the same
   counts per step; then K1-fwd bitwise and K1-bwd against float64 at the
   side-40 shapes), the serving entry
   with ``external_eval`` on CPTAC (every logit finite), and IvYGAP's 20x
   batch from the pack and from the ``.npy`` files (bitwise);
6i. times the host's build of a batch of 4 at the preset (``.npy``, pack,
   a whole co-training batch) and the wall of one co-training epoch of
   teacher train steps with and without ``PrefetchLoader``, five of each,
   alternating (a gain is claimed only where every prefetched epoch beats
   every plain one); builds a co-training batch of 4 with the threaded C++
   reader (``data/native_io.py``) and with numpy (``DMLT_NO_NATIVE``),
   bitwise equal, 8 bags read each way, both host times beside the host's
   CPU;
3j. runs both entries of every baseline at the preset's widths (``path``,
   ``transmil``, ``omic``, ``pathomic`` with concat and with ``fusion_type
   pofusion``, ``pathomic_original``, ``pathomic_fg``,
   ``pathomic_ensemble``, ``mcat``, ``cmta``: 2 steps and 1 eval batch;
   ``mcat`` and ``cmta`` also on the survival preset, B 8, 1 step, the
   c-index): 0 launches of every kernel in every step and evaluation, the
   checkpoint served bitwise equal to the fold's final evaluation (0
   launches); then deformpathomic with BilinearFusion (``gradient_modulate``
   off) at its usual counts (K1-fwd 2 and K1-bwd 2 a step), served
   bitwise;
5j. compares each baseline's f32 forward (every output within
   ``LOGITS_TOL``) and one f32 ``deterministic_training`` step
   (``compare_train_step``) on the card with the CPU; TransMIL, CMTA and
   MCAT (``F64_MODES``) also against float64 on the CPU, the card within
   ``NYSTROM_F64_FACTOR`` times the CPU f32's own error (or within
   ``LOGITS_TOL`` / ``GRAD_TOL``), forward and step;
6j. times each baseline's eval forward (50) and train step (30, dropout
   on): bags/s median and p80, the profiler's device-busy share, and for
   TransMIL and CMTA the share of the device time in their Nystrom cores
   (the cores profiled alone at the models' shapes, forward and
   forward + backward);
3k. runs the teacher's training entry at the preset with its logging on
   (``debug`` off, ``log_dir`` in a temporary directory under ``build/``;
   2 steps, a cadence evaluation, the final one: K1-fwd 16, K1-bwd 8) and
   reads its JSONL line back (JAX's keys, every value finite); the serving
   entry restores the fold's checkpoint with ``save4visualization`` (K1-fwd
   8) and logs its line; ``utils/heatmap.render_export`` renders the npz
   to 16 RGB PNGs of 400 x 400 (4 slides x 4 maps) and ``summary.csv``;
   both entries under ``debug`` write no file (every other phase runs
   under ``debug``);
3l. the uniteacher's f32 eval forward (K1-fwd 4, logits within
   ``LOGITS_TOL``) and ``deterministic_training`` step (K1-fwd 4, K1-bwd 4,
   ``compare_train_step``) on the card against the CPU, and one teacher
   step each on ``grade`` and ``subtype`` (3 classes) the same way;
5k. integrated gradients (32 steps) and expected-gradients SHAP (8
   baselines x 16 steps) of ``pathomic`` and ``mcat`` on a batch of 4 bags
   at 431 genes, card against the CPU from the same weights within
   ``IMPORTANCE_TOL`` rel-L2 (MCAT against float64, as in 5j), 0 launches;
   IG's completeness on pathomic at 256 steps (``COMPLETENESS_TOL``);
6k. ``utils/profiling.trace`` around 5 teacher train steps: the Chrome
   trace names K1-fwd's and K1-bwd's kernels 20 times each; the
   ``StepTimer`` over 30 steps against the CUDA events' median
   (``STEP_TIMER_TOL``); ablation and permutation importance (1 trial) of
   pathomic over 8 eval bags, timed;
3m. the training entry at the preset in a ``torch.distributed`` group of
   one rank under NCCL (a ``chip_smoke.py --rank`` subprocess with the
   ``DMLT_COORDINATOR`` / ``DMLT_NUM_PROCESSES`` / ``DMLT_PROCESS_ID``
   rendezvous; 3 steps and an eval batch, K1-fwd 4 and K1-bwd 4 a step),
   then in that subprocess one ``deterministic_training`` preset step in a
   group of one rank against the same step without a group, run three
   times: the metrics bitwise, the gradients bitwise or, as the plain step
   does not repeat bitwise on the card (``grid_sample``'s backward adds
   with atomics), within ``REPEAT_FACTOR`` times the plain runs' largest
   spread;
5m. two ranks on the one card under gloo (NCCL refuses two ranks on one
   device; the kernels are built before the spawn, so each rank loads the
   library), on phase 5's f32 batch under ``deterministic_training``:
   data parallelism on the teacher, TransMIL's token axis (2,501 tokens
   padded to 2,560, 256 landmarks, 1,280 tokens a rank), tensor
   parallelism on the teacher at divisor 1 and 0 (4 heads a rank), the
   scale branches on multiscale and distillation as a 2-stage pipeline of
   2 microbatches: each step against the single-process step on the card
   from the same weights (``compare_train_step``'s tolerances; the updated
   model's eval logits within ``LOGITS_TOL``), the ranks' parameters
   bitwise equal, every rank's launches exact and printed (no time: two
   ranks sharing a card measure no scaling).

3n. a teacher fold that the JAX package trained and saved
   (``tests/data/jax_teacher_fold.ckpt``, written with JAX's
   ``save_checkpoint`` by ``tests/make_jax_checkpoint_fixture.py``: fixdim
   2,500, divisor 1, f32 streams, ``deterministic_training``, model width
   16, 3 AdamW steps) served through the serving entry with ``--checkpoint
   ...ckpt`` on its fold-0 test set (4 bags drawn with numpy from the
   stored seed; K1-fwd 4), its logits within ``LOGITS_TOL`` of JAX's stored
   ones;
5n. the same file resumed by the training entry as the fold's rolling
   checkpoint (``teacher_fold_1_latest.ckpt`` in a temporary directory
   under ``build/``; ``resume``): it starts at JAX's epoch 3 of 5 and takes
   2 steps (K1-fwd 4 and K1-bwd 4 a step, K1-fwd 4 for the final
   evaluation), their losses within ``STEP_LOSS_TOL`` relative of JAX's
   stored ones; both errors on a line of their own.

The main paths (the inference entry and the training entry) each run at
the preset's divisor 1 and at the ``Config`` default divisor 0, and the
teacher's also in the opt-in settings (a), (b) and (c), every count set to
0 just before a run and read just after.  In the kernels line the
``launches`` are those of the training runs (K1 and K2: the teacher's at
divisor 1 and 0; K3: the student's at the preset; K4: deformpathomic's at
attn_dim 1, divisor 1; K5: the teacher's in (b); K6: the teacher's in
(a); K2-nk: the "nk" teacher's train steps; K7: its entry's run; the
distillation runs of phase 3g, the multiscale runs of 3h, the
real-data runs of 3i and the baselines of 3j add no kernel and change no
entry; the per-rank counts of 3m and 5m are on their own lines), and K2's
``max_abs_err`` is the larger of its errors at the 2-D and the 1-D shape.
Launches made for comparisons and timings are not counted.  K5's times are
at divisor 4 in f32, K6's at the preset's dropout 0.1, K2-nk's at the
teacher's shape, K7's in "nk" at dropout 0.1.
Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its flops over 67
TFLOP/s (f32 outside the tensor cores), counted from this run's inputs
(H100 SXM data sheet; K3's dots are f32 FMAs); for K6-fwd, K6-bwd and
K7-fwd's and K7-bwd's attention parts,
whose products run on the tensor cores as 3xTF32, those products count
three TF32 passes over 494.7 TFLOP/s (dense TF32) instead; ``library_ms``
is null for all sixteen: no single
PyTorch call computes any of their functions (K6 and K7 include the table
windows or the CPB MLP, and a softmax over the kv axis, which
``scaled_dot_product_attention`` does not take as a bias it builds).
Any failure raises: there is no fallback and no phase is caught.  Exits
non-zero without a result line when there is no CUDA device.
"""

from __future__ import annotations

import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

K1_TOL = 1e-5
K2_TOL = 1e-4
LOGITS_TOL = 1e-4
# phase 3m: the card's train step does not repeat bitwise (atomics in
# grid_sample's backward): the step in a group of one rank is held within
# this factor of the plain step's largest run-to-run spread
REPEAT_FACTOR = 4
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
# K3: the kernel sums each C-term dot as one f32 FMA chain in ascending
# channel order (the zero-padded channels of its last 32-channel slice add
# exact zeros; no tensor cores), cuBLAS in an order of its own.  Each such
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
# cotangents per batch-head, 1.9e-5 of the weight gradient on the H100).
# The baselines' attention-pooling score biases (ABMIL's attention_1, the
# gated pooling's attention_c) shift every score of a softmax over the
# bag, so their gradient is 0 in exact arithmetic too; their f32 residue
# reached 1.0e-5 of the weight gradient in JAX on the CPU (MCAT's pooling
# over 4 tokens), hence ZERO_GRAD_FLOOR_1D for them
POOLING_BIASES = ("attention_1.bias", "attention_c.bias")
ZERO_GRAD_BIASES = ("rel_pos_bias.mlp.2.bias", "cluster_merge.score.bias",
                    *POOLING_BIASES)
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
TF32_FLOPS_PER_MS = 494.7e9   # 494.7 TFLOP/s dense TF32 on the tensor cores
CSRC = "disentangled_multimodal_learning_tpu_torch/csrc"
TABLE_SRC = f"{CSRC}/cpb_table.cu"
EXACT_SRC = f"{CSRC}/cpb_exact.cu"
DPC_SRC = f"{CSRC}/dpc_knn.cu"
TABLE1D_SRC = f"{CSRC}/cpb_table_1d.cu"
STRIDED_SRC = f"{CSRC}/cpb_table_strided.cu"
FUSED_SRC = f"{CSRC}/fused_table.cu"
FUSED_EXACT_SRC = f"{CSRC}/fused_exact.cu"
# phases 3j, 5j and 6j: the baselines, (mode, settings) at the preset
BASELINES = (("path", {}), ("transmil", {}), ("omic", {}), ("pathomic", {}),
             ("pathomic", {"fusion_type": "pofusion"}),
             ("pathomic_original", {}), ("pathomic_fg", {}),
             ("pathomic_ensemble", {}), ("mcat", {}), ("cmta", {}))
# the baselines held against float64: TransMIL and CMTA, whose Nystrom
# pinv (a cubic Newton-Schulz iteration, 6 steps) amplifies f32 rounding
# (tests/test_ops.py compares it in float64), and MCAT, whose co-attention
# averages the 2,500 patches for each of its 4 signature queries, so the
# 4 tokens its path pooling weighs nearly coincide and that pooling's
# gradients cancel (card against CPU f32: 1.1e-3 rel-L2 on
# path_attention_head, the score bias 6.0e-4 of its weight's gradient,
# H100 run).  The card's f32 and the CPU's f32 are each held against a
# float64 CPU run, the card within twice the CPU f32's own error (or
# within LOGITS_TOL / GRAD_TOL, should the CPU's be smaller than those);
# the zero-gradient biases within ZERO_GRAD_FLOOR_1D of their weight's
# gradient or twice the CPU f32's residue
F64_MODES = ("transmil", "cmta", "mcat")
NYSTROM_F64_FACTOR = 2
# phase 5d's f32 deformpathomic settings (the preset's divisor 1 unless named)
DEFORMPATHOMIC_F32 = ({"attn_dim": 1}, {"attn_dim": 1, "cpb_table_divisor": 0},
                      {"attn_dim": 2, "return_vgrid": True})
PALLAS = "disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py"
PALLAS_DPC = "disentangled_multimodal_learning_tpu/ops/pallas/dpc_knn.py"
# kernels redesigned for the card after their port: when, or into what
REDESIGNED = {name: "PR 7" for name in (
    "cpb_exact_fwd (K2-fwd)", "cpb_exact_bwd (K2-bwd)",
    "cpb_exact_nk_fwd (K2-nk-fwd)", "cpb_exact_nk_bwd (K2-nk-bwd)")}
REDESIGNED.update({name: "3xTF32 tensor-core products" for name in (
    "fused_table_fwd (K6-fwd)", "fused_table_bwd (K6-bwd)",
    "fused_exact_bwd (K7-bwd)")})
REDESIGNED.update({name: "table tiles" for name in (
    "cpb_table_interp_bwd (K1-bwd)", "cpb_table_strided_bwd (K5-bwd)")})
REDESIGNED.update({
    name: "one wave over tile pairs, register-tiled f32 FMA" for name in (
        "dpc_knn (K3-knn)", "dpc_parent (K3-parent)")})
REDESIGNED["cpb_table_1d_bwd (K4-bwd)"] = "1-D table tiles, owner computes"
REDESIGNED["cpb_table_interp_fwd (K1-fwd)"] = (
    "one-wave row pipeline, vector stores")
REDESIGNED["cpb_table_strided_fwd (K5-fwd)"] = (
    "x-phase pair planes (d >= 3), a block a row, 4 outputs in flight")
REDESIGNED["fused_exact_fwd (K7-fwd)"] = (
    "four-point MLP bias, 3xTF32 tensor-core products")
# the K6 kernels (the resident attention backward serves K7-bwd too; the
# earlier design's instances are fused_attention_bwd_kernel<...>), whose
# ptxas and SASS figures phase 2 prints
K6_KERNELS = ("fused_table_fwd_kernel", "fused_attention_bwd_resident_kernel",
              "fused_attention_bwd_kernel")
# the K3 kernels (an instance per k of K3-knn's, one of K3-parent's)
K3_KERNELS = ("dpc_split_kernel", "dpc_finish_kernel")
# K4-bwd's kernels and K1-fwd's (an instance per store type)
K4_BWD_KERNELS = ("table1d_bwd_tile_kernel", "table1d_bwd_finish_kernel")
K1_FWD_KERNELS = ("cpb_table_interp_fwd_kernel",)
# K5-fwd's two kernels (the main one an instance per store type and
# source), and K7-fwd's (an instance for one kv chunk and one for more)
K5_FWD_KERNELS = ("strided_pairs_kernel", "strided_row_kernel")
K7_FWD_KERNELS = ("fused_exact_fwd_kernel",)


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


def hold_queue(calls: int) -> None:
    """Queue a spin of the card long enough for the host to launch
    ``calls`` calls behind it (100 us each), so that events around them
    time the card's work and not the host's launches: a kernel of ~0.02 ms
    is otherwise timed at its wrapper's host cost."""
    import torch

    torch.cuda._sleep(int(calls * 1e-4 * 2e9))  # cycles at up to 2 GHz


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    hold_queue(iters)
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


def bound(nbytes: float, flops: float,
          tc_flops: float = 0.0) -> tuple[float, str]:
    """The least time of the card for the work: ``(ms, bound_by)``;
    ``flops`` run on the CUDA cores in f32, ``tc_flops`` on the tensor
    cores in TF32."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / F32_FLOPS_PER_MS + tc_flops / TF32_FLOPS_PER_MS
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


def table_backward_case(cpb, dev, gen, w, bh: int = 32, k: int = 144,
                        side: int = 50, kv_bound: float | None = None) -> dict:
    """Phase 2b's K1-bwd inputs, drawn from ``gen`` after the MLP weights
    ``w``: the divisor-1 table, the taps and fractions of ``bh x k`` kv
    points up to 25% past the bound (clipped rows), and a random window
    cotangent.  ``kv_bound``: the bound of a 12 x 12 deformed grid (side
    50's) unless given."""
    import torch

    if kv_bound is None:
        kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    table = cpb.cpb_table(*w, side=side, kv_bound=kv_bound)
    gkv = ((torch.rand(bh, k, 2, generator=gen) * 2 - 1)
           * kv_bound * 1.25).to(dev)
    taps, fracs = cpb.table_taps(cpb.table_shifts(gkv, side=side,
                                                  kv_bound=kv_bound),
                                 side=side, tn=table.shape[0])
    dout = torch.randn(taps.shape[0], side, side, generator=gen).to(dev)
    return dict(table=table, taps=taps, fracs=fracs, dout=dout, side=side)


def table_backward_errors(got, plain, want) -> dict:
    """Norm-relative errors against float64 of a table backward's
    ``(dtable, dfracs)`` and of the f32 plain version's, with the two
    shift cotangents also apart: ``{name: (kernel, plain)}`` for dtable,
    dfracs, dfy and dfx."""
    errs = {n: (rel_err(g, w), rel_err(p, w))
            for n, g, p, w in zip(("dtable", "dfracs"), got, plain, want)}
    for i, n in enumerate(("dfy", "dfx")):
        errs[n] = (rel_err(got[1][:, i], want[1][:, i]),
                   rel_err(plain[1][:, i], want[1][:, i]))
    return errs


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
    c = table_backward_case(cpb, dev, gen, w, bh, k)
    table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                               "dout"))
    clipped = ((fracs < 0) | (fracs > 1)).any(dim=1)
    R = taps.shape[0]
    k1 = [cpb.table_interp_backward(table, taps, fracs, dout, side)
          for _ in range(2)]
    torch.cuda.synchronize()
    want = cpb.table_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), side)
    plain = cpb.table_interp_backward_reference(table, taps, fracs, dout, side)
    k1_det = all(torch.equal(a, b) for a, b in zip(*k1))
    errs = table_backward_errors(k1[0], plain, want)
    k1_abs = max((g.double() - ww).abs().max().item()
                 for g, ww in zip(k1[0], want))
    clipped_dfracs = k1[0][1][clipped].abs().max().item()
    for name, (e, pe) in errs.items():
        tol = K1_BWD_TOL.get(name, K1_BWD_TOL["dfracs"])
        print(f"[K1-bwd] R={R} side={side} tn={table.shape[0]} "
              f"{name}: rel err vs f64 kernel {e:.3e}, f32 plain {pe:.3e} "
              f"(tol {tol}) | {card}")
    print(f"[K1-bwd] clipped rows={int(clipped.sum())}, their max |dfracs| "
          f"{clipped_dfracs:.3e}; deterministic (2 calls bitwise equal): "
          f"{k1_det}; max_abs_err {k1_abs:.3e}")
    if (table.shape[0] != 139 or not clipped.any() or not k1_det
            or not clipped_dfracs > 0
            or not all(e <= K1_BWD_TOL[n] for n, (e, _) in errs.items()
                       if n in K1_BWD_TOL)):
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


def check_exact_odd(cpb, dev, card: str, nk: bool) -> float:
    """Phases 2b ("kn") and 2f ("nk"): K2 at an odd shape, BH 3 x K 7 x N
    130 with O = 3 (N not a multiple of the backward's 128-point tile nor
    of the forward's 512-element block, O on the kernels' general path):
    the forward within ``K2_TOL`` of its plain version, the backward
    against float64 within ``K2_BWD_TOL`` and bitwise equal over two
    calls.  Returns the backward's largest absolute error."""
    import torch

    gen = torch.Generator().manual_seed(9 + nk)
    BH, K, N, O = 3, 7, 130, 3
    grid_q = (torch.rand(N, 2, generator=gen) * 2 - 1).to(dev)
    gkv = (torch.rand(BH, K, 2, generator=gen) * 3 - 1.5).to(dev)
    w = mlp_weights(O, gen, dev)
    fwd, bwd = ((cpb.cpb_bias_nk, cpb.cpb_bias_nk_backward) if nk else
                (cpb.cpb_bias_transposed, cpb.cpb_bias_transposed_backward))
    ref, bref = ((cpb.cpb_bias_nk_reference,
                  cpb.cpb_bias_nk_backward_reference) if nk else
                 (cpb.cpb_bias_transposed_reference,
                  cpb.cpb_bias_transposed_backward_reference))
    with torch.inference_mode():
        got = fwd(grid_q, gkv, *w)
        err = (got - ref(grid_q, gkv, *w)).abs().max().item()
    dbias = torch.randn(got.shape, generator=gen).to(dev)
    g = [bwd(grid_q, gkv, *w, dbias) for _ in range(2)]
    torch.cuda.synchronize()
    det = all(torch.equal(a, b) for a, b in zip(*g))
    want = bref(grid_q.double(), gkv.double(), *(t.double() for t in w),
                dbias.double())
    names = ("dgrid_kv", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, g[0], want)}
    abs_err = max((a.double() - b).abs().max().item()
                  for a, b in zip(g[0], want))
    label = "K2-nk" if nk else "K2"
    print(f"[{label}] odd shape BH={BH} K={K} N={N} O={O}: fwd max_abs_err "
          f"{err:.3e} (tol {K2_TOL}); bwd rel err vs f64 " + ", ".join(
              f"{n} {e:.2e}" for n, e in errs.items())
          + f" (tol {K2_BWD_TOL['dw']}); deterministic {det} | {card}")
    if not err <= K2_TOL or not det or not all(
            e <= K2_BWD_TOL["dgrid_kv" if n == "dgrid_kv" else "dw"]
            for n, e in errs.items()):
        raise RuntimeError(f"{label} disagrees with its plain version at "
                           "the odd shape, or is not deterministic")
    return abs_err


def k2_ptxas(log: str, lib) -> list[str]:
    """The ptxas figures of the K2 kernels' instances in the build log
    (registers, spill stores and loads, barriers) and the dynamic shared
    memory a block of each takes (the forward's at K = 144)."""
    import re

    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            fwd = re.search(r"cpb_exact_fwd_kernelILb(\d)E", m.group(1))
            bwd = re.search(r"cpb_exact_bwd_partial_kernelILi(\d+)E",
                            m.group(1))
            if fwd:
                layout = "nk" if fwd.group(1) == "1" else "kn"
                name = f"cpb_exact_fwd_kernel<{layout}>"
                smem = {x: lib.dmlt_cpb_exact_fwd_smem(144, x) for x in (1, 2)}
            elif bwd:
                o = int(bwd.group(1))
                name = f"cpb_exact_bwd_partial_kernel<O={o or 'any'}>"
                smem = {x: lib.dmlt_cpb_exact_bwd_smem(x)
                        for x in ((o,) if o else (3, 64))}
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            regs = line.split("ptxas info    :")[-1].strip()
            lines.append(f"{name}: {regs}; {spills}; dynamic shared memory "
                         + ", ".join(f"{b} B at O={o}"
                                     for o, b in smem.items()))
            name = None
    return lines


# the instances of K6's attention backward (resident or in kv chunks) by
# their mangled names
RESIDENT = {"ILb1E": "<resident>", "ILb0E": "<chunked>"}


def k1_instance(name: str) -> str:
    """K1-fwd's instance of the mangled ``name``: its store type and where
    it reads the table (``kShared``, the first template argument)."""
    store = "bf16" if "nv_bfloat16" in name else "f32"
    where = "in shared memory" if "ILb1E" in name else "through L1"
    return f"<{store} store, table {where}>"


def k5_instance(name: str) -> str:
    """K5-fwd's main kernel instance of the mangled ``name``: its store
    type and where it reads the taps (``kPairs``, the second template
    argument); the first kernel has one instance."""
    if "strided_row_kernel" not in name:
        return ""
    store = "bf16" if "nv_bfloat16" in name else "f32"
    where = "pair planes (d >= 3)" if "ELb1E" in name else "table (d = 2)"
    return f"<{store} store, {where}>"


def k3_instance(name: str) -> str:
    """The instance of a K3 kernel by its mangled name: K3-parent, or
    K3-knn and its k (the earlier design had no k)."""
    import re

    if "ILb1E" in name:
        return "<parent>"
    k = re.search(r"ILb0ELi(\d+)E", name)
    return f"<knn k={k.group(1)}>" if k else "<knn>"


def instance(name: str, key: str, instances) -> str:
    """``key`` with the instance of the mangled ``name``: ``instances`` maps
    a piece of the name to a label, or is a function of the name."""
    if callable(instances):
        return key + instances(name)
    return key + next((v for k, v in instances.items() if k in name), "")


def kernel_ptxas(log: str, keys, instances=RESIDENT) -> list[str]:
    """The ptxas figures (registers, barriers, spills) of each instance of
    the kernels whose names hold one of ``keys``, in the build log."""
    import re

    lines, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((instance(m.group(1), key, instances)
                         for key in keys if key in m.group(1)), None)
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: "
                         f"{line.split('ptxas info    :')[-1].strip()}; "
                         f"{spills}")
            name = None
    return lines


def table_bwd_ptxas(log: str) -> list[tuple[str, str]]:
    """The ptxas figures of K1-bwd's and K5-bwd's kernel instances
    (``csrc/table_bwd_tiles.cuh``, compiled into both sources): ``(K1-bwd
    or K5-bwd, line)``, the line naming the instance (cotangent type,
    strip)."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            fn = m.group(1)
            kind = re.search(r"(table_bwd_tile_kernel|table_bwd_finish_kernel)",
                             fn)
            if kind:
                label = ("K5-bwd" if "cpb_table_strided_bwd_cu" in fn
                         else "K1-bwd")
                name = kind.group(1)
                if name == "table_bwd_tile_kernel":
                    dt = "bf16" if "nv_bfloat16" in fn else "f32"
                    strip = re.search(r"Li(\d+)ELb", fn)
                    name += (f"<{dt} cotangent, strip "
                             f"{strip.group(1) if strip else '?'}>")
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            out.append((label, f"{name}: "
                        f"{line.split('ptxas info    :')[-1].strip()}; "
                        f"{spills}"))
            name = None
    return out


@functools.lru_cache(maxsize=None)
def _sass(lib: str) -> str:
    """``cuobjdump -sass`` of the library ``lib``, dumped once a run (one
    dump takes ~17 s, and three phases read it)."""
    from pathlib import Path

    from disentangled_multimodal_learning_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout


def sass_counts(lib, keys, instances=None) -> list[str]:
    """Per instance of the kernels whose names hold one of ``keys`` in the
    library ``lib`` (named by ``instances`` where given): its tensor-core
    (HMMA), f32 FMA (FFMA), spill store (STL) and spill load (LDL)
    instructions, from ``cuobjdump -sass``."""
    import re

    found = []
    for line in _sass(str(lib)).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = next((k for k in keys if k in m.group(1)), None)
            if key and instances:
                key = instance(m.group(1), key, instances)
            found.append([key, dict.fromkeys(("HMMA", "FFMA", "STL", "LDL"),
                                             0)])
        elif found and found[-1][0]:
            op = re.search(r"\b(HMMA|FFMA|STL|LDL)\b", line)
            if op:
                found[-1][1][op.group(1)] += 1
    return [f"{key}: " + ", ".join(f"{n} {op}" for op, n in ops.items())
            for key, ops in found if key]


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
    for line in k2_ptxas(build.build_log(), build.kernels()):
        print(f"[K2 ptxas] {line}")
    for line in kernel_ptxas(build.build_log(), K6_KERNELS):
        print(f"[K6 ptxas] {line}")
    for line in sass_counts(build.library_dir() / build.LIB_NAME,
                            K6_KERNELS):
        print(f"[K6 SASS] {line}")
    for label, line in table_bwd_ptxas(build.build_log()):
        print(f"[{label} ptxas] {line}")
    for line in kernel_ptxas(build.build_log(), K4_BWD_KERNELS, {}):
        print(f"[K4-bwd ptxas] {line}")
    for line in kernel_ptxas(build.build_log(), K1_FWD_KERNELS,
                             k1_instance):
        print(f"[K1-fwd ptxas] {line}")
    for line in kernel_ptxas(build.build_log(), K5_FWD_KERNELS,
                             k5_instance):
        print(f"[K5-fwd ptxas] {line}")
    k7_smem = ", ".join(
        f"{build.kernels().dmlt_fused_exact_fwd_smem(kk, dd)} B at K {kk}, "
        f"D {dd}" for kk, dd in ((144, 64), (625, 16)))
    for line in kernel_ptxas(build.build_log(), K7_FWD_KERNELS):
        print(f"[K7-fwd ptxas] {line} dynamic shared memory {k7_smem}")
    for line in sass_counts(build.library_dir() / build.LIB_NAME,
                            K7_FWD_KERNELS, RESIDENT):
        print(f"[K7-fwd SASS] {line}")
    for line in kernel_ptxas(build.build_log(), K3_KERNELS, k3_instance):
        print(f"[K3 ptxas] {line}")
    for line in sass_counts(build.library_dir() / build.LIB_NAME,
                            K3_KERNELS, k3_instance):
        print(f"[K3 SASS] {line}")

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
    k1_same = torch.equal(k1, k1_ref)
    print(f"[K1] R={taps.shape[0]} side={side} tn={table.shape[0]} "
          f"clipped rows={n_clipped} max_abs_err={k1_err:.3e} (tol {K1_TOL})"
          f", bitwise equal: {k1_same}")
    if (table.shape[0] != 139 or n_clipped == 0 or not k1_err <= K1_TOL
            or not k1_same):
        raise RuntimeError("K1 disagrees with its plain version")
    check_table_fwd_shapes(cpb, dev, card, torch.float32)

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
    bwd["k2"]["err"] = max(bwd["k2"]["err"], check_exact_odd(cpb, dev, card,
                                                             nk=False))
    torch.cuda.empty_cache()

    # ---- phase 2c: K3 against its plain versions, the assignment exactly -
    dpc = check_dpc_kernels(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 3: the serving entry at the preset (divisor 1, bf16) ------
    # debug: the entries log nothing (phase 3k turns their logging on)
    preset = Config.diag2021().replace(synthetic_data=True,
                                       synthetic_test_size=3 * 4, debug=True)
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
        synthetic_test_size=4, kfold=1, epochs=1, checkpoints="#",
        debug=True)
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
        k1_bound, k1_by = table_bounds(table, taps, side)[0]
        k1_blocks = build.kernels().dmlt_cpb_table_interp_fwd_blocks(
            0, *table.shape)
        print(f"[time] K1 table_interp R=4608 side=50: kernel {k1_ms:.4f} ms,"
              f" plain {k1_plain:.4f} ms; {k1_bytes / k1_ms / 1e9:.3f} TB/s "
              f"written = {k1_bytes / k1_ms / 1e9 / 3.35:.1%} of 3.35 TB/s; "
              f"bound {k1_bound:.4f} ms by {k1_by} "
              f"({k1_bound / k1_ms:.1%} of it); "
              f"{k1_blocks} blocks an SM, the {4 * table.numel()} B table "
              f"in shared memory each | {card}")
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
    nk["bwd_err"] = max(nk["bwd_err"], check_exact_odd(cpb, dev, card,
                                                       nk=True))
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
    torch.cuda.empty_cache()

    # ---- phase 3g: checkpoints, distillation and survival entries -------
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as ckpt_dir:
        teacher_ckpt = run_distillation_entries(train_preset, dev, card,
                                                ckpt_dir)
        torch.cuda.empty_cache()

        # ---- phase 5g: distillation in f32, card vs CPU; a resumed fold --
        compare_train_step(f32.replace(mode="distillation",
                                       deterministic_training=True),
                           batch, dev)
        check_resumed_fold(train_preset, teacher_ckpt, dev, card, ckpt_dir)
    torch.cuda.empty_cache()

    # ---- phase 6g: the distillation step, cached and uncached -----------
    time_distillation(train_preset, batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phases 3h, 5h, 6h: multiscale ----------------------------------
    with tempfile.TemporaryDirectory(dir="build") as ckpt_dir:
        run_multiscale_entries(train_preset, dev, card, ckpt_dir)
    torch.cuda.empty_cache()
    compare_multiscale_f32(f32, batch, dev)
    torch.cuda.empty_cache()
    time_multiscale(preset, train_preset, batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phases 3i, 6i: real data on a demo cohort ----------------------
    from disentangled_multimodal_learning_tpu_torch.data.demo_cohort import (
        write_demo_cohorts)

    with tempfile.TemporaryDirectory(dir="build") as tmp:
        t0 = time.perf_counter()
        write_demo_cohorts(f"{tmp}/data")
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        print(f"[real data] demo cohorts: {size / 1e9:.3f} GB written in "
              f"{time.perf_counter() - t0:.2f} s")
        side40 = run_real_data_entries(f"{tmp}/data", f"{tmp}/ckpt", dev,
                                       card)
        torch.cuda.empty_cache()
        time_real_data(f"{tmp}/data", dev, card)
    torch.cuda.empty_cache()

    # ---- phases 3j, 5j, 6j: the baselines (no kernel on their path) -----
    with tempfile.TemporaryDirectory(dir="build") as ckpt_dir:
        run_baseline_entries(train_preset, dev, card, ckpt_dir)
    torch.cuda.empty_cache()
    compare_baselines_f32(f32, batch, dev)
    torch.cuda.empty_cache()
    time_baselines(preset, train_preset, batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phases 3k, 3l, 5k, 6k: logging, heatmaps, coverage, importance -
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        run_logging_entries(train_preset, dev, card, tmp)
    torch.cuda.empty_cache()
    check_coverage_gaps(f32, batch, dev, card)
    torch.cuda.empty_cache()
    compare_importance(f32, dev, card)
    torch.cuda.empty_cache()
    time_aux(train_preset, f32, batch, dev, card)
    torch.cuda.empty_cache()

    # ---- phases 3m, 5m: training over process groups ---------------------
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        check_group_of_one(train_preset, batch, dev, tmp, card)
        check_parallel_layouts(f32, batch, dev, tmp, card)
    torch.cuda.empty_cache()

    # ---- phases 3n, 5n: a fold that the JAX package wrote ---------------
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        check_jax_fold(dev, card, tmp)
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernel_line(
        train_counts, dict(k1=max(k1_err, side40["k1"]),
                           k2=max(*k2_err.values(), k2_1d["err"]),
                           k1_bwd=max(bwd["k1"]["err"], k5["k1_bwd_err"],
                                      side40["k1_bwd"]),
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
    # K3: every dot an f32 FMA chain on the CUDA cores (no tensor cores)
    B, N, C = dpc["x"].shape
    dots = 2 * B * N * N * C
    x_bytes = 4 * (B * N * C + B * N)  # x and x2
    k3k_bound = bound(x_bytes + 4 * B * N * (dpc["k"] + 1), dots)
    k3p_bound = bound(x_bytes + 4 * B * N * 2, dots)
    k4_bound, k4b_bound = table1d_bounds(k4)
    # K5 at divisor 4, f32 (phase 6e's timed case)
    k5_bound, k5b_bound = table_bounds(k5[4]["table"], k5[4]["taps"], side)
    # K6: q, k, v, the table, taps and fractions read, out and attn written
    # (forward); the backward also reads attn and both cotangents and
    # writes dq, dk, dv, dtable and dfracs; the two (forward) or four
    # (backward) BH x K x N x D products on the tensor cores, 3 TF32 passes
    # of 2 flops a multiply-add each
    bh, n6, d6 = k6["q"].shape
    kv6 = k6["k"].shape[1]
    small6 = 4 * (k6["table"].numel() + 4 * bh * kv6)
    qkv = 4 * (bh * n6 * d6 + 2 * bh * kv6 * d6)
    macs = bh * kv6 * n6 * d6
    k6_bound = bound(qkv + small6 + 4 * (bh * n6 * d6 + bh * kv6 * n6), 0,
                     3 * 4 * macs)
    k6b_bound = bound(2 * qkv + small6 + 4 * (bh * n6 * d6
                                              + 2 * bh * kv6 * n6
                                              + k6["table"].numel()
                                              + 2 * bh * kv6), 0,
                      3 * 8 * macs)
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
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": nl, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bms, "bound_by": by, "library_ms": None}
            for name, src, rep, nl, err, (ms, plain), (bms, by) in rows]
    for entry in line:
        if entry["name"] in REDESIGNED:
            entry["redesigned"] = REDESIGNED[entry["name"]]
    return line


def check_dpc_kernels(dev, card: str) -> dict:
    """Phase 2c: K3-knn and K3-parent at B=4, N=2500, C=128, k=5 against
    their plain versions on the card (f32) and in float64, on LayerNormed
    random tokens and on the same bags with their second half one repeated
    vector, bitwise equal over two calls; then the assignment (2 clusters)
    on the card against the plain version on the CPU, exactly; then the
    kernels the same way at B=1, N=2501, C=12, k=8 (the last 64-token tile
    5 tokens wide, the last 128-neighbour tile 69 wide, 800 pairs over 264
    blocks, so that blocks hold two runs, the 32-channel slice mostly zero
    padding)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cluster, dpc_knn

    err, timed = 0.0, None
    for B, N, C, k in ((4, 2500, 128, 5), (1, 2501, 12, 8)):
        gen = torch.Generator().manual_seed(2)
        x = torch.nn.functional.layer_norm(
            torch.randn(B, N, C, generator=gen), (C,))
        repeated = x.clone()
        repeated[:, N // 2:] = (torch.randint(0, 2, (C,), generator=gen) * 2
                                - 1).float()
        noise = torch.rand(B, N, generator=gen)
        plan = dpc_knn.dpc_plan(B, N)
        for case, xh in (("random", x), ("repeated half", repeated)):
            xd = xh.to(dev)
            x2 = (xd * xd).sum(-1)
            knn2, rmax2 = dpc_knn.knn_stream(xd, x2, k)
            density = (torch.exp(-knn2.clamp_min(1e-12).mean(-1) / C)
                       + noise.to(dev) * 1e-6)
            parent2 = dpc_knn.parent_stream(xd, x2, density)
            again = dpc_knn.knn_stream(xd, x2, k) + (
                dpc_knn.parent_stream(xd, x2, density),)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in
                          zip((knn2, rmax2, parent2), again))
            plain = dpc_knn.knn_stream_reference(xd, x2, k) + (
                dpc_knn.parent_stream_reference(xd, x2, density),)
            x64 = xd.double()
            x2_64 = (x64 * x64).sum(-1)
            f64 = dpc_knn.knn_stream_reference(x64, x2_64, k) + (
                dpc_knn.parent_stream_reference(x64, x2_64,
                                                density.double()),)
            tol = K3_TOL_ULPS * C * 2.0 ** -24 * x2.max().item()
            print(f"[K3] {case} B={B} N={N} C={C} k={k}: {plan.items} "
                  f"pairs of a token and a neighbour tile over "
                  f"{plan.blocks} blocks; bitwise equal over two calls: "
                  f"{bitwise}")
            if not bitwise:
                raise RuntimeError("K3 is not deterministic")
            for name, got, p, want in zip(("knn2", "rowmax2", "parent2"),
                                          (knn2, rmax2, parent2), plain, f64):
                real = want < 1e37  # the no-parent sentinel compared apart
                e = (got - p).abs().max().item()
                e64 = (got.double() - want)[real].abs().max().item()
                p64 = (p.double() - want)[real].abs().max().item()
                same_sentinels = torch.equal(got >= 1e37, p >= 1e37)
                print(f"[K3] {case} B={B} N={N} C={C} k={k} {name}: kernel "
                      f"vs plain max_abs_err {e:.3e} (tol {tol:.3e}); vs "
                      f"float64: kernel {e64:.3e}, f32 plain {p64:.3e}; "
                      f"no-parent tokens {int((~real).sum())}, the same: "
                      f"{same_sentinels} | {card}")
                if not e <= tol or not same_sentinels:
                    raise RuntimeError(f"K3 {name} disagrees with its plain "
                                       "version")
                err = max(err, e)
            if C != 128:
                continue
            card_idx, card_centers = cluster.dpc_knn_cluster(
                xd, 2, k, density_noise=noise.to(dev))
            host_idx, host_centers = cluster.dpc_knn_cluster(
                xh, 2, k, density_noise=noise)
            same = (torch.equal(card_centers.cpu(), host_centers)
                    and torch.equal(card_idx.cpu(), host_idx))
            print(f"[K3] {case}: centres on the card "
                  f"{card_centers.tolist()}, plain on the CPU "
                  f"{host_centers.tolist()}; index_down and idx_cluster "
                  f"identical: {same}")
            if not same:
                raise RuntimeError("the assignment on the card differs from "
                                   "the plain version's")
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
    outputs = {"k3_knn": k + 1, "k3_parent": 2}  # words written a token
    for name, (ms, plain) in out.items():
        # the committed arithmetic: every dot an f32 FMA chain on the CUDA
        # cores, so the bound is the flops over 67 TFLOP/s
        bms, by = bound(4 * (B * N * C + B * N) + 4 * B * N * outputs[name],
                        flops)
        print(f"[time] {name} B={B} N={N} C={C} k={k}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms; {flops / ms / 1e9:.2f} TFLOP/s = "
              f"{flops / ms / 1e9 / 67:.1%} of 67 TFLOP/s f32; bound "
              f"{bms:.4f} ms ({by}: the dots as f32 FMAs over 67 TFLOP/s), "
              f"{bms / ms:.1%} of it | {card}")
    torch.cuda.empty_cache()
    return out


def run_training_entry(cfg, dev, steps: int, per_step: dict,
                       per_eval: dict, card: str, out: dict | None = None):
    """Phases 3b, 3c, 3g and 3h: the training entry (``main.main``) for one
    fold; every count set to 0 just before, read just after, and held to
    ``per_step`` launches per train step and ``per_eval`` per eval batch
    (0 for every kernel not named); the fold's final metrics go to
    ``out["final"]`` where given."""
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
    want = _sum_counts(steps, per_step, eval_batches, per_eval)
    print(f"[train] entry, {setting(cfg)}: {len(losses)} steps + "
          f"{eval_batches} eval batch in {wall:.2f} s (data generation and "
          f"first-call set-up included); losses {losses}; launches {n} "
          f"| {card}")
    if cfg.task_type == "survival":  # the c-index of every tag
        print(f"[train] survival c-index per tag {final['detail']} | {card}")
    names = (tuple(final["detail"]) if cfg.task_type == "survival"
             else ("acc", "auc", "f1"))
    values = final["detail"] if cfg.task_type == "survival" else final
    if (len(losses) != steps or not all(map(math.isfinite, losses))
            or not all(math.isfinite(values[k]) for k in names)):
        raise RuntimeError(f"training entry: bad losses or metrics {final}")
    if n != want:
        raise RuntimeError(f"training entry: launches {n}, want {want}")
    if out is not None:
        out["final"] = final
    return n


def compare_train_step(cfg, batch, dev, layout: str = "auto") -> None:
    """Phases 5b, 5c, 5d, 5e, 5f and 5g: one ``deterministic_training``
    f32 step of ``cfg.mode`` (its attentions in ``layout``; distillation's
    student against its teacher) from the same seeded weights on the same
    batch, on the card and on the CPU."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    out = {}
    for device in (dev, "cpu"):
        model, teacher = define_net(cfg, device, attn_layout=layout), None
        if cfg.mode == "distillation":
            model, teacher = model
        step = make_train_step(model, cfg, make_optimizer(
            cfg, model.parameters()), teacher=teacher)
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
                   or name.endswith(POOLING_BIASES) else ZERO_GRAD_FLOOR)
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
    after 3 warm-up steps; the profiler over the steps of each config at
    the exact CPB (divisor 0), and then over those of the last."""
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
        if c.cpb_table_divisor == 0 and c is not configs[-1]:
            profile(f"train step ({setting(c)})", lambda: step(x), n=3)
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
    when set (and deformpathomic's attn_dim and return_vgrid); a
    baseline's: ``baseline_setting``."""
    if cfg.mode in dict(BASELINES):
        return baseline_setting(cfg)
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


def check_table_fwd_shapes(cpb, dev, card: str, dtype) -> None:
    """K1-fwd with the ``dtype`` store bitwise against its plain version at
    odd shapes: side 7 and 33 (rows that start off the vector alignment, so
    a scalar head and tail), R 1 and 5, kv points up to 25% past the bound
    of the teacher's 12 x 12 deformed grid, from seed 11."""
    import torch

    gen = torch.Generator().manual_seed(11)
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    for side in (7, 33):
        table = cpb.cpb_table(*mlp_weights(1, gen, dev), side=side,
                              kv_bound=kv_bound)
        for R in (1, 5):
            gkv = ((torch.rand(1, R, 2, generator=gen) * 2 - 1)
                   * kv_bound * 1.25).to(dev)
            taps, fracs = cpb.table_taps(
                cpb.table_shifts(gkv, side=side, kv_bound=kv_bound),
                side=side, tn=table.shape[0])
            with torch.inference_mode():
                got = cpb.table_interp(table, taps, fracs, side, dtype)
                want = cpb.table_interp_reference(table, taps, fracs, side,
                                                  out_dtype=dtype)
            torch.cuda.synchronize()
            same = got.dtype == want.dtype == dtype and torch.equal(got, want)
            print(f"[K1 {str(dtype)[6:]} store] side={side} R={R} "
                  f"tn={table.shape[0]}: bitwise equal to its plain version "
                  f"{same} | {card}")
            if not same:
                raise RuntimeError(f"K1 ({str(dtype)[6:]} store) disagrees "
                                   f"with its plain version at side {side}, "
                                   f"R {R}")


def table1d_case(dev) -> dict:
    """Phase 2d's inputs: deformpathomic's preset shape (B=4 x G=4 rows of
    K=625 kv points, O=2 channels, n_q=2501 queries), the 1-D table of a
    random MLP, kv points up to 25% past the bound so that some rows clip,
    and a random f32 bias cotangent, drawn from seed 4 in that order."""
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
    dout = torch.randn(B * G, O, K, n_q, generator=gen).to(dev)
    return dict(table=table, taps=taps, fracs=fracs, dout=dout, n_q=n_q,
                kv=K)


def check_table1d_backward(c: dict, card: str, plans: dict) -> float:
    """K4-bwd on case ``c`` against its plain version in float64 within
    ``K4_BWD_TOL`` norm-relative (the f32 plain version's own error printed
    beside), bitwise equal over two calls, every clipped row's shift
    cotangent kept; at each of ``plans`` (label -> ``TABLE1D_BWD_BLOCKS``
    for the two calls, None for the wrapper's plan).  Returns the largest
    abs error against float64."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

    table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                               "dout"))
    n_q, kv = c["n_q"], c["kv"]
    R = taps.shape[0]
    want = cpb1d.table1d_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), n_q, kv)
    plain = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                    n_q, kv)
    clipped = (fracs < 0) | (fracs > 1)
    bwd_err = 0.0
    for label, blocks in plans.items():
        saved = cpb1d.TABLE1D_BWD_BLOCKS
        cpb1d.TABLE1D_BWD_BLOCKS = blocks or saved
        try:
            plan = cpb1d.table1d_bwd_plan(*table.shape, R)
            kb = [cpb1d.table1d_interp_backward(table, taps, fracs, dout,
                                                n_q, kv) for _ in range(2)]
        finally:
            cpb1d.TABLE1D_BWD_BLOCKS = saved
        torch.cuda.synchronize()
        det = all(torch.equal(a, b) for a, b in zip(*kb))
        errs = {n: (rel_err(g, ww), rel_err(p, ww)) for n, g, p, ww in
                zip(("dtable", "dshifts"), kb[0], plain, want)}
        err = max((g.double() - ww).abs().max().item()
                  for g, ww in zip(kb[0], want))
        bwd_err = max(bwd_err, err)
        kept = bool((kb[0][1][clipped] != 0).all())
        print(f"[K4-bwd] {label}: R={R} O={table.shape[0]} n_q={n_q} "
              f"tn={table.shape[1]}, {plan.groups} row groups of "
              f"{plan.rows_per_group}, {plan.tiles} tiles of {plan.tile}: "
              "rel err vs f64 kernel / f32 plain " + ", ".join(
                  f"{n} {e:.3e} / {pe:.3e} (tol {K4_BWD_TOL[n]})"
                  for n, (e, pe) in errs.items())
              + f"; deterministic (2 calls bitwise equal) {det}; clipped "
              f"rows {int(clipped.sum())}, their dshift kept {kept}; "
              f"max_abs_err {err:.3e} | {card}")
        if (not det or not clipped.any() or not kept
                or not all(e <= K4_BWD_TOL[n] for n, (e, _) in errs.items())):
            raise RuntimeError(f"K4-bwd ({label}) disagrees with its plain "
                               "version or is not deterministic")
        del kb
    return bwd_err


def table1d_odd_case(dev) -> dict:
    """An odd K4 shape: n_q 37, kv 3, 7 (batch, group) rows of 3 kv points
    (21 rows: groups of 6 at 4 row groups), O=2, kv points up to 50% past
    the bound (clipped rows at both ends), from seed 12."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

    BG, K, O, n_q = 7, 3, 2, 37
    kv_bound = 1.0 + 4.0 / (K - 1)
    gen = torch.Generator().manual_seed(12)
    w = list(mlp_weights(O, gen, dev))
    w[0] = w[0][:1].contiguous()
    table = cpb1d.cpb_table_1d(*w, n_q=n_q, kv_bound=kv_bound)
    gkv = ((torch.rand(BG, K, generator=gen) * 2 - 1)
           * kv_bound * 1.5).to(dev)
    taps, fracs = cpb1d.table1d_taps(
        cpb1d.table1d_shifts(gkv, n_q=n_q, kv_bound=kv_bound),
        n_q=n_q, tn=table.shape[1])
    dout = torch.randn(BG, O, K, n_q, generator=gen).to(dev)
    return dict(table=table, taps=taps, fracs=fracs, dout=dout, n_q=n_q,
                kv=K)


def check_table1d_kernels(dev, card: str) -> dict:
    """Phase 2d: K4-fwd on :func:`table1d_case`'s inputs against its plain
    version, and K4-bwd through :func:`check_table1d_backward` at three
    plans: the wrapper's, a forced small row-group count (the fewest the
    1,024-row group limit allows), and :func:`table1d_odd_case`'s odd
    shape in 4 row groups."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

    c = table1d_case(dev)
    table, taps, fracs, n_q, K = (c[n] for n in ("table", "taps", "fracs",
                                                 "n_q", "kv"))
    clipped = (fracs < 0) | (fracs > 1)
    with torch.inference_mode():
        got = cpb1d.table1d_interp(table, taps, fracs, n_q, K)
        want = cpb1d.table1d_interp_reference(table, taps, fracs, n_q, K)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"[K4] R={taps.shape[0]} O={table.shape[0]} n_q={n_q} "
          f"tn={table.shape[1]} out {tuple(got.shape)} clipped "
          f"rows={int(clipped.sum())} max_abs_err={err:.3e} (tol {K4_TOL}), "
          f"bitwise equal: {torch.equal(got, want)} | {card}")
    if (table.shape[1] != 5023 or not clipped.any() or got.shape != want.shape
            or not err <= K4_TOL):
        raise RuntimeError("K4 disagrees with its plain version")
    del got, want
    bwd_err = max(
        check_table1d_backward(c, card, {
            "the wrapper's plan": None,
            "a forced small row-group count": 1}),
        check_table1d_backward(table1d_odd_case(dev), card,
                               {"an odd shape": 8}))
    return dict(c, err=err, bwd_err=bwd_err, out_numel=c["dout"].numel())


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


def table1d_bounds(k4: dict) -> tuple:
    """``(forward, backward)`` bounds of K4 on phase 2d's inputs: the bias
    written once (fwd) or its cotangent read once (bwd), the table, taps
    and fractions read once (the backward also writes the table and shift
    cotangents); 3 flops per output (two products, a sum), 7 per cotangent
    element (the scatter's two products and two sums, the shift term's
    difference, product and sum)."""
    out = k4["out_numel"]
    small = 4 * (k4["table"].numel() + 2 * k4["taps"].shape[0])
    return (bound(4 * out + small, 3 * out),
            bound(4 * out + small + 4 * (k4["table"].numel()
                                         + k4["taps"].shape[0]), 7 * out))


def time_table1d_kernels(k4: dict, k2_1d: dict, card: str) -> dict:
    """Phase 6d: K4-fwd and K4-bwd against their plain versions (for the
    backward, autograd through the plain forward with its graph kept), on
    phase 2d's inputs; then K2-fwd and K2-bwd the same way on phase 2d's
    inputs at the 1-D attention's shape, with their bounds."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb, cpb1d
    from disentangled_multimodal_learning_tpu_torch.ops.build import kernels

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
    fwd_bound, bwd_bound = table1d_bounds(k4)
    for name, (ms, plain), (bms, by) in (("K4-fwd", fwd, fwd_bound),
                                         ("K4-bwd", bwd, bwd_bound)):
        print(f"[time] {name} R={taps.shape[0]} O=2 n_q={n_q}: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms; {nbytes / ms / 1e9:.3f} "
              f"TB/s of the {nbytes / 1e6:.0f} MB bias "
              f"{'written' if name == 'K4-fwd' else 'cotangent read'} = "
              f"{nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s; bound {bms:.4f} "
              f"ms by {by} ({bms / ms:.1%} of it) | {card}")
    plan = cpb1d.table1d_bwd_plan(*t.shape, taps.shape[0])
    print(f"[K4-bwd plan] {plan.groups} row groups of {plan.rows_per_group},"
          f" {plan.tiles} tiles of {plan.tile} entries: {plan.groups * plan.tiles}"
          f" blocks of 256 threads, "
          f"{kernels().dmlt_cpb_table_1d_bwd_blocks(plan.rows_per_group)} an "
          f"SM, {52 * plan.rows_per_group} B of shared memory each | {card}")
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


def opt_in_table_cases(cpb, dev) -> dict:
    """Phase 2e's table inputs at divisors 1, 2 and 4 (see
    :func:`strided_case`), each with a random f32 window cotangent,
    ``{d: dict(table, taps, fracs, dout)}``, drawn from seed 6 in that
    order."""
    import torch

    gen = torch.Generator().manual_seed(6)
    cases = {}
    for d in (1, 2, 4):
        table, taps, fracs = strided_case(cpb, dev, d, gen)
        dout = torch.randn(taps.shape[0], 50, 50, generator=gen).to(dev)
        cases[d] = dict(table=table, taps=taps, fracs=fracs, dout=dout)
    return cases


def check_table_strided_kernels(cpb, dev, card: str) -> dict:
    """Phase 2e (K5 and the bf16 store): K1-fwd with the bf16 store, and
    K5-fwd at divisor 2 and 4 (tn 274 and 544) in f32 and with the bf16
    store, at R = 4608 rows of side 50 with clipped rows, each against its
    plain version (bitwise equal: the same ops rounded the same way); K1-bwd
    with a bf16 window cotangent and K5-bwd with f32 and bf16 ones through
    :func:`check_table_backward`.  Returns the inputs (for the timings) and
    the errors."""
    import torch

    side = 50
    out = {"err": 0.0, "bwd_err": 0.0}
    cases = opt_in_table_cases(cpb, dev)
    table, taps, fracs, dout = (cases[1][n] for n in ("table", "taps",
                                                       "fracs", "dout"))
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
    check_table_fwd_shapes(cpb, dev, card, torch.bfloat16)
    out["k1_bwd_err"] = check_table_backward(
        cpb, "K1-bwd", table, taps, fracs, dout.to(torch.bfloat16), side, 1,
        K1_BWD_TOL, card)
    out["k1_bf16"] = dict(table=table, taps=taps, fracs=fracs,
                          dout=dout.to(torch.bfloat16))
    for d in (2, 4):
        table, taps, fracs, dout = (cases[d][n] for n in ("table", "taps",
                                                           "fracs", "dout"))
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
    errs = table_backward_errors(kb[0], plain, want)
    clipped_dsh = (kb[0][1][clipped].abs().amax(dim=1).min().item()
                   if clipped.any() else 0.0)
    abs_err = max((g.double() - ww).abs().max().item()
                  for g, ww in zip(kb[0], want))
    print(f"[{name}] divisor {divisor} R={taps.shape[0]} side={side} "
          f"{str(dout.dtype)[6:]} cotangent: rel "
          f"err vs f64, kernel / f32 plain: " + ", ".join(
              f"{n} {e:.3e} / {pe:.3e} (tol {tol.get(n, tol['dfracs'])})"
              for n, (e, pe) in errs.items())
          + f"; clipped rows {int(clipped.sum())}, their "
          f"smallest |dfracs| {clipped_dsh:.3e}; deterministic {det}; "
          f"max_abs_err {abs_err:.3e} | {card}")
    if (not det or not clipped_dsh > 0
            or not all(e <= tol[n] for n, (e, _) in errs.items() if n in tol)):
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
    the f32 plain version's own error, whichever is larger; both bitwise
    equal over two calls.  At the teacher's shape, then at an odd one (BH
    3, K 17, side 11, D 12: K, D and the query tail off every tile edge).
    Returns the inputs at the teacher's shape (for the timings) and the
    errors."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops import cpb, fused_table

    gen = torch.Generator().manual_seed(7)
    cases = (fused_case(dev, gen), fused_case(dev, gen, bh=3, k=17, side=11,
                                              d=12))
    out = {"err": 0.0, "bwd_err": 0.0}
    names = ("dq", "dk", "dv", "dtable", "dfracs")
    for c in cases:
        q, k, v, table, shifts, side = (c[n] for n in (
            "q", "k", "v", "table", "shifts", "side"))
        taps, fracs = cpb.table_taps(shifts, side=side, tn=table.shape[0])
        shape = f"BH={q.shape[0]} K={k.shape[1]} N={q.shape[1]} D={q.shape[2]}"
        for rate in (0.0, 0.1):
            seed = 1234 + int(rate * 10)
            with torch.inference_mode():
                got, again = (fused_table.fused_table_attention(
                    q, k, v, table, shifts, side, seed, rate)
                    for _ in range(2))
                want = fused_table.fused_table_attention_reference(
                    q, k, v, table, shifts, side, seed, rate)
            torch.cuda.synchronize()
            e_out, e_attn = ((a - b).abs().max().item()
                             for a, b in zip(got, want))
            det = all(torch.equal(a, b) for a, b in zip(got, again))
            kept = (fused_table.dropout_keep_mask(seed, want[1].shape, rate,
                                                  dev).float().mean().item())
            print(f"[K6] {shape} rate {rate}: kept {kept:.4f}; max_abs_err "
                  f"out {e_out:.3e} (tol {K6_OUT_TOL}), attn {e_attn:.3e} "
                  f"(tol {K6_ATTN_TOL}); deterministic {det} | {card}")
            if not det or not e_out <= K6_OUT_TOL or not e_attn <= K6_ATTN_TOL:
                raise RuntimeError("K6 disagrees with its plain version or is "
                                   "not deterministic")
            out["err"] = max(out["err"], e_out, e_attn)
            attn = got[1]
            kb = [fused_table.fused_table_attention_backward(
                q, k, v, table, taps, fracs, attn, c["g_out"], c["g_attn"],
                side, seed, rate) for _ in range(2)]
            torch.cuda.synchronize()
            det = all(torch.equal(a, b) for a, b in zip(*kb))
            del got, again, want
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
                       else max(K6_TABLE_BWD_TOL, 2 * errs[n][1]))
                   for n in names}
            abs_err = max((g.double() - w64).abs().max().item()
                          for g, w64 in zip(kb[0], ref[torch.float64]))
            print(f"[K6-bwd] {shape} rate {rate}: rel err vs f64, kernel / "
                  "f32 plain: "
                  + ", ".join(f"{n} {e:.3e} / {pe:.3e} (tol {tol[n]:.1e})"
                              for n, (e, pe) in errs.items())
                  + f"; deterministic {det}; max_abs_err {abs_err:.3e} | "
                  f"{card}")
            if not det or not all(e <= tol[n] for n, (e, _) in errs.items()):
                raise RuntimeError("K6-bwd disagrees with its plain version "
                                   "or is not deterministic")
            out["bwd_err"] = max(out["bwd_err"], abs_err)
            del kb, ref
            torch.cuda.empty_cache()
    c = cases[0]
    taps, fracs = cpb.table_taps(c["shifts"], side=c["side"],
                                 tn=c["table"].shape[0])
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
          "K1-bwd's kernels (table tiles + the finishing sums) on its ds; "
          "K1-bwd's own wrapper is not called, so its count is 0")
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
    from disentangled_multimodal_learning_tpu_torch.ops.build import kernels

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
        blocks = kernels().dmlt_cpb_table_interp_fwd_blocks(
            1, *c1["table"].shape)
        print(f"[time] K1-fwd bf16 store R=4608 side=50: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms; bound {bms:.4f} ms by {by} "
              f"({bms / ms:.1%} of it); {blocks} blocks an SM | {card}")
        times["k1_bf16"] = (ms, plain)
        ms = cuda_ms(lambda: cpb.table_interp_backward(
            c1["table"], c1["taps"], c1["fracs"], c1["dout"], side), 20)
        bms, by = table_bounds(c1["table"], c1["taps"], side, 2)[1]
        print(f"[time] K1-bwd bf16 cotangent R=4608 side=50: kernel "
              f"{ms:.4f} ms; bound {bms:.4f} ms by {by} | {card}")
        times["k1_bwd_bf16"] = ms
        for d in (2, 4):
            c = k5[d]
            for dt in (torch.float32, torch.bfloat16):
                ms, plain = interleaved_ms(
                    lambda: cpb.table_interp_reference(
                        c["table"], c["taps"], c["fracs"], side, d, dt),
                    lambda: cpb.table_interp_strided(
                        c["table"], c["taps"], c["fracs"], side, d, dt), 50)
                nbytes = c["dout"].numel() * (4 if dt == torch.float32 else 2)
                bms, by = table_bounds(c["table"], c["taps"], side,
                                       nbytes // c["dout"].numel())[0]
                blocks = kernels().dmlt_cpb_table_strided_fwd_blocks(
                    int(dt == torch.bfloat16), d)
                print(f"[time] K5-fwd divisor {d} {str(dt)[6:]} store "
                      f"R=4608 side=50 tn={c['table'].shape[0]}: kernel "
                      f"{ms:.4f} ms, plain {plain:.4f} ms; "
                      f"{nbytes / ms / 1e9:.3f} TB/s written = "
                      f"{nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s; bound "
                      f"{bms:.4f} ms by {by} ({bms / ms:.1%} of it); "
                      f"{blocks} blocks an SM | {card}")
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


# phase 3g: the distilled student's kernels per train step, on a batch the
# teacher-output cache has not seen (the teacher's forward, K1-fwd 4, and
# the student's) and on one it replays (the student's alone), and per eval
# batch (the student's forward)
DISTILL_MISS = dict(k1_fwd=4 + 2, k1_bwd=2, k3_knn=2, k3_parent=2)
DISTILL_HIT = dict(k1_fwd=2, k1_bwd=2, k3_knn=2, k3_parent=2)
DISTILL_EVAL = dict(k1_fwd=2, k3_knn=2, k3_parent=2)
# phase 5g: a distillation fold (f32, deterministic_training) stopped after
# epoch 1 and resumed, against the uninterrupted fold, epoch 2's losses.
# The state restored is bitwise the state saved (the CPU test holds the
# whole fold bitwise), but F.grid_sample's backward adds its gradients by
# atomics on the card, so two runs of one step differ in the last bits of
# the offset gradients; three AdamW steps carry that to the losses at about
# 1e-6 relative (Adam turns noise into full steps only on leaves whose
# gradient is rounding noise, the CPB output biases, which the softmax over
# kv ignores), hence 1e-5.
RESUME_LOSS_TOL = 1e-5


class _Tee(io.StringIO):
    """Standard output kept, and copied."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def _sum_counts(steps: int, per_step: dict, evals: int = 0,
                per_eval: dict | None = None) -> dict:
    """Every kernel's count over ``steps`` train steps and ``evals`` eval
    batches."""
    per_eval = per_eval or {}
    return expect(**{k: per_step.get(k, 0) * steps + per_eval.get(k, 0) * evals
                     for k in set(per_step) | set(per_eval)})


def run_distillation_entries(train_preset, dev, card: str,
                             ckpt_dir: str) -> str:
    """Phase 3g at the preset: (1) the teacher's training entry (1 fold,
    3 steps) writes a metric-stamped checkpoint; (2) the distillation
    training entry restores it through ``checkpoints_teacher`` and trains 2
    epochs of 3 steps with the teacher-output cache, with exact counts per
    epoch (the logger, called by the eval after each epoch, reads them) and
    3 misses then 3 hits; (3) one epoch without the cache runs the teacher
    every step; (4) the serving entry restores the distilled student's
    checkpoint and gives the logits of the run's final evaluation bitwise;
    (5) the survival preset's teacher training entry (B 8, 3 steps) prints
    a finite c-index per tag.  Returns the teacher's checkpoint."""
    import contextlib
    import glob
    import re
    import types

    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.config import Config

    run_training_entry(train_preset.replace(checkpoints=ckpt_dir), dev, 3,
                       dict(k1_fwd=4, k1_bwd=4), dict(k1_fwd=4), card)
    teacher_ckpt, = glob.glob(f"{ckpt_dir}/teacher_fold_1_epoch_1_*.pt")
    print(f"[distill] teacher checkpoint {teacher_ckpt}")

    distill = train_preset.replace(
        mode="distillation", checkpoints=ckpt_dir,
        checkpoints_teacher=teacher_ckpt, epochs=2, eval_every_iters=3)
    marks = []
    logger = types.SimpleNamespace(log=lambda payload: marks.append(counts()))
    out = _Tee()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        final = train_main.main(distill, device=dev, logger=logger)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    marks.append(counts())
    epochs = [marks[0]] + [{k: b[k] - a[k] for k in a}
                           for a, b in zip(marks, marks[1:])]
    want = [_sum_counts(3, DISTILL_MISS, 1, DISTILL_EVAL),
            _sum_counts(3, DISTILL_HIT, 1, DISTILL_EVAL),
            _sum_counts(0, {}, 1, DISTILL_EVAL)]
    cache = re.findall(r"\[distill cache\] (\d+) hits, (\d+) misses",
                       out.getvalue())
    losses = final["train_losses"]
    print(f"[distill] entry, cache on, {setting(distill)}: 2 epochs of 3 "
          f"steps in {wall:.2f} s (set-up included); losses {losses}; "
          f"launches epoch 1 (misses) + eval {epochs[0]}, epoch 2 (hits) + "
          f"eval {epochs[1]}, final eval {epochs[2]}; cache (hits, misses) "
          f"{cache} | {card}")
    if epochs != want:
        raise RuntimeError(f"distillation entry: launches {epochs}, want "
                           f"{want}")
    if cache != [("3", "3")]:
        raise RuntimeError(f"distillation cache: {cache}, want 3 hits and "
                           "3 misses")
    if len(losses) != 6 or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"distillation entry: bad losses {losses}")
    student_ckpt, = glob.glob(
        f"{ckpt_dir}/distillation_fold_1_epoch_2_*.pt")

    run_training_entry(distill.replace(distill_teacher_cache=False, epochs=1,
                                       checkpoints="#", eval_every_iters=10),
                       dev, 3, DISTILL_MISS, DISTILL_EVAL, card)

    reset_counts()
    metrics, logits = inference.main(
        distill.replace(checkpoints_student=student_ckpt), device=dev)
    torch.cuda.synchronize()
    n = counts()
    same = {k: bool(np.array_equal(v, final["logits"][k]))
            for k, v in logits.items()}
    print(f"[distill] serving from {student_ckpt}: launches {n}; logits "
          f"bitwise equal to the run's final evaluation: {same} | {card}")
    check_outputs(metrics, logits, 4)
    if n != _sum_counts(0, {}, 1, DISTILL_EVAL) or not all(same.values()):
        raise RuntimeError("the distilled student's serving disagrees with "
                           "its final evaluation")

    surv = Config.from_yaml("config/config_mine_surv.yaml").replace(
        synthetic_data=True, synthetic_train_size=3 * 8,
        synthetic_test_size=8, kfold=1, epochs=1, checkpoints=ckpt_dir,
        debug=True)
    run_training_entry(surv, dev, 3, dict(k1_fwd=4, k1_bwd=4),
                       dict(k1_fwd=4), card)
    ckpt = glob.glob(f"{ckpt_dir}/teacher_fold_1_epoch_1_cindex_*.pt")
    print(f"[survival] teacher, B {surv.batch_size}: checkpoint {ckpt} "
          f"| {card}")
    if len(ckpt) != 1:
        raise RuntimeError("the survival run wrote no cindex checkpoint")
    return teacher_ckpt


# phases 3n and 5n: the JAX fold and what JAX computed from it
JAX_FOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jax_teacher_fold")


def check_jax_fold(dev, card: str, tmp: str) -> None:
    """Phases 3n and 5n: the JAX package's ``.ckpt`` served by the serving
    entry and resumed by the training entry, against JAX's stored logits
    and losses."""
    import shutil

    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch.config import Config

    with np.load(JAX_FOLD + ".npz") as z:
        stored = {k: z[k] for k in z.files}
    cfg = Config.diag2021().replace(**json.loads(str(stored["settings"])),
                                    synthetic_data=True, debug=True)
    reset_counts()
    t0 = time.perf_counter()
    metrics, logits = inference.main(cfg, checkpoint=JAX_FOLD + ".ckpt",
                                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    print(f"[jax fold] serving from {JAX_FOLD}.ckpt (seed "
          f"{int(stored['seed'])}, {setting(cfg)}, width {cfg.path_dim}): "
          f"1 batch in {wall:.2f} s (reading the file and set-up included); "
          f"launches {n} | {card}")
    check_outputs(metrics, logits, cfg.synthetic_test_size)
    if n != expect(k1_fwd=4):
        raise RuntimeError(f"serving the JAX fold: launches {n}, want K1-fwd 4")
    logit_err = max(float(np.abs(logits[k] - stored[k]).max())
                    for k in ("logits_tea10", "logits_tea20", "logits_teas"))
    shutil.copy(JAX_FOLD + ".ckpt",
                os.path.join(tmp, "teacher_fold_1_latest.ckpt"))
    out = {}
    run_training_entry(cfg.replace(resume=True, checkpoints=tmp), dev, 2,
                       dict(k1_fwd=4, k1_bwd=4), dict(k1_fwd=4), card, out)
    losses, want = out["final"]["train_losses"], stored["losses"].tolist()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print(f"[jax fold] card vs JAX: served logits max_abs_err "
          f"{logit_err:.3e} (tol {LOGITS_TOL}); resumed losses {losses} vs "
          f"{want}, max rel err {loss_err:.3e} (tol {STEP_LOSS_TOL}) | {card}")
    if not (logit_err <= LOGITS_TOL and loss_err <= STEP_LOSS_TOL):
        raise RuntimeError("the JAX fold on the card disagrees with JAX")


class _Stopped(Exception):
    pass


def check_resumed_fold(train_preset, teacher_ckpt: str, dev, card: str,
                       ckpt_dir: str) -> None:
    """Phase 5g: a distillation fold (f32, ``deterministic_training``, 2
    epochs of 3 steps, a rolling checkpoint every epoch) run whole, then
    run again, stopped after epoch 1's rolling checkpoint, and resumed:
    epoch 2's losses within ``RESUME_LOSS_TOL`` of the whole run's."""
    import numpy as np

    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.train import trainers

    cfg = train_preset.replace(
        mode="distillation", attn_bf16_streams=False,
        deterministic_training=True, epochs=2, save_every_epochs=1,
        checkpoints_teacher=teacher_ckpt)
    dirs = [os.path.join(ckpt_dir, name) for name in ("whole", "resumed")]
    whole = train_main.main(cfg.replace(checkpoints=dirs[0]), device=dev)[0]
    save = trainers.save_checkpoint

    def stopped_after_rolling_save(directory, name, *args, **kw):
        path = save(directory, name, *args, **kw)
        if name.endswith("_latest"):
            raise _Stopped(path)
        return path

    part = cfg.replace(checkpoints=dirs[1])
    trainers.save_checkpoint = stopped_after_rolling_save
    try:
        train_main.main(part, device=dev)
        raise RuntimeError("the run was not stopped after epoch 1")
    except _Stopped:
        pass
    finally:
        trainers.save_checkpoint = save
    resumed = train_main.main(part.replace(resume=True), device=dev)[0]
    a, b = whole["train_losses"][3:], resumed["train_losses"]
    errs = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    logit_err = max(float(np.abs(whole["logits"][k]
                                 - resumed["logits"][k]).max())
                    for k in whole["logits"])
    print(f"[resume] distillation, f32, deterministic: epoch 2 losses whole "
          f"{a}, resumed {b}; rel err {errs} (tol {RESUME_LOSS_TOL}); "
          f"bitwise {a == b}; final logits max_abs_err {logit_err:.3e} "
          f"| {card}")
    if len(b) != 3 or not max(errs) <= RESUME_LOSS_TOL:
        raise RuntimeError("the resumed fold disagrees with the whole fold")


def time_distillation(train_preset, batch, dev, card: str, n: int = 30):
    """Phase 6g: the distillation train step at the preset, uncached (the
    teacher's forward every step) and cached (a replay from the
    teacher-output cache, the replay timed with it): bags/s, median and
    p80 of ``n`` steps on a resident batch, and a profiled call each
    (device-busy share); then a cache fill (a miss: the teacher's forward
    and the store) and a replay (a hit) alone."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.distill_cache import (
        TeacherBoundaryCache)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_distill_cached_step, make_teacher_boundary_fn,
        make_train_step)

    cfg = train_preset.replace(mode="distillation")
    student, teacher = define_net(cfg, dev)
    opt = make_optimizer(cfg, student.parameters())
    sched = make_scheduler(cfg, opt, 1000)
    x = batch_to_tensors(batch, dev)
    idx = batch.indices
    boundary = make_teacher_boundary_fn(teacher)
    cache = TeacherBoundaryCache(boundary, len(idx), dev)
    steps = {"uncached": make_train_step(student, cfg, opt, sched,
                                         teacher=teacher)}
    cached = make_distill_cached_step(student, cfg, opt, sched)
    steps["cached"] = lambda t: cached(dict(t, **cache.boundary(t, idx)))
    for name, step in steps.items():
        ms = ms_samples(lambda: step(x), n)
        med, p80 = median(ms), ms[int(0.8 * len(ms))]
        print(f"[time] distillation train step ({name}) B=4 fixdim=2500 "
              f"{setting(cfg)}: median {med:.3f} ms = {4000.0 / med:.1f} "
              f"train bags/s, p80 {p80:.3f} ms = {4000.0 / p80:.1f} bags/s "
              f"({n} steps) | {card}")
        profile(f"distillation train step ({name}, {setting(cfg)})",
                lambda: step(x), n=3)
    fill = ms_samples(lambda: TeacherBoundaryCache(
        boundary, len(idx), dev).boundary(x, idx), 20)
    replay = ms_samples(lambda: cache.boundary(x, idx), 50)
    print(f"[time] teacher-output cache, B=4: fill (a miss: the teacher's "
          f"forward, the store) median {median(fill):.3f} ms, p80 "
          f"{fill[16]:.3f}; replay (a hit) median {median(replay):.4f} ms, "
          f"p80 {replay[40]:.4f} (hits {cache.hits}, misses {cache.misses})"
          f" | {card}")
    del student, teacher, opt, steps, cached, cache


# multiscale (phase 3h): per train step the teacher's and the student's
# kernels of both scales; per eval batch their forwards
MULTISCALE_STEP = dict(k1_fwd=6, k1_bwd=6, k3_knn=2, k3_parent=2)
MULTISCALE_EVAL = dict(k1_fwd=6, k3_knn=2, k3_parent=2)
MULTISCALE_TAGS = ("tea10", "tea20", "stu10", "stu20", "stus")


def run_multiscale_entries(train_preset, dev, card: str,
                           ckpt_dir: str) -> dict:
    """Phase 3h at the preset: the multiscale training entry (1 fold, 3
    steps, the final evaluation of 4 bags) with exact counts per step and
    eval batch and every loss finite, its checkpoint in ``ckpt_dir``; 1
    step at divisor 0 (K2 6 + 6, K1 never); the serving entry in
    multiscale mode, restored from the fold's checkpoint, gives the final
    evaluation's logits bitwise on all five tags.  Returns the counts of
    the preset run."""
    import glob

    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference

    cfg = train_preset.replace(mode="multiscale", checkpoints=ckpt_dir)
    run = {}
    n = run_training_entry(cfg, dev, 3, MULTISCALE_STEP, MULTISCALE_EVAL,
                           card, out=run)
    final = run["final"]
    if set(final["logits"]) != {f"logits_{t}" for t in MULTISCALE_TAGS}:
        raise RuntimeError(f"multiscale tags {sorted(final['logits'])}")
    exact = dict(k2_fwd=6, k3_knn=2, k3_parent=2)
    run_training_entry(cfg.replace(cpb_table_divisor=0, checkpoints="#",
                                   synthetic_train_size=4),
                       dev, 1, dict(exact, k2_bwd=6), exact, card)
    ckpt, = glob.glob(f"{ckpt_dir}/multiscale_fold_1_epoch_1_*.pt")
    reset_counts()
    metrics, logits = inference.main(cfg.replace(checkpoints_student=ckpt),
                                     device=dev)
    torch.cuda.synchronize()
    served = counts()
    same = {k: bool(np.array_equal(v, final["logits"][k]))
            for k, v in logits.items()}
    print(f"[multiscale] serving from {ckpt}: launches {served}; logits "
          f"bitwise equal to the run's final evaluation: {same} | {card}")
    check_outputs(metrics, logits, 4, n_metrics=7 * 5)
    if (served != _sum_counts(0, {}, 1, MULTISCALE_EVAL)
            or len(same) != 5 or not all(same.values())):
        raise RuntimeError("the served multiscale model disagrees with its "
                           "final evaluation")
    return n


def compare_multiscale_f32(f32, batch, dev) -> None:
    """Phase 5h: the f32 multiscale forward on the card against the CPU
    with the same weights (the five logits within ``LOGITS_TOL``), then
    one ``deterministic_training`` step (``compare_train_step``)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    m32 = f32.replace(mode="multiscale")
    with torch.inference_mode():
        card_out = define_net(m32, dev)(
            **model_inputs(batch, dev, "multiscale"))[2]
        cpu_out = define_net(m32, "cpu")(
            **model_inputs(batch, "cpu", "multiscale"))[2]
    errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
            for k in cpu_out}
    print(f"[f32] multiscale card vs CPU logits max_abs_err "
          f"{max(errs.values()):.3e} (tol {LOGITS_TOL}); per output {errs}")
    if len(errs) != 5 or not max(errs.values()) <= LOGITS_TOL:
        raise RuntimeError("f32 multiscale logits on the card disagree with "
                           "the CPU")
    del card_out, cpu_out
    compare_train_step(m32.replace(deterministic_training=True), batch, dev)


def time_multiscale(preset, train_preset, batch, dev, card: str) -> None:
    """Phase 6h: the multiscale eval forward (bags/s, median and p80 of
    50) and train step (30 steps and a profiled call, ``time_train_steps``)
    at the preset."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    cfg = preset.replace(mode="multiscale")
    with torch.inference_mode():
        model = define_net(cfg, dev)
        x = model_inputs(batch, dev, "multiscale")
        ms = ms_samples(lambda: model(**x), 50)
        med, p80 = median(ms), ms[int(0.8 * len(ms))]
        print(f"[time] multiscale eval forward B=4 fixdim=2500 "
              f"{setting(cfg)}: median {med:.3f} ms/batch = "
              f"{4000.0 / med:.1f} bags/s, p80 {p80:.3f} ms = "
              f"{4000.0 / p80:.1f} bags/s (50 forwards) | {card}")
        profile(f"eval forward ({setting(cfg)})", lambda: model(**x))
        del model
    time_train_steps((train_preset.replace(mode="multiscale"),), batch, dev,
                     card)


def real_data_cfg(data_dir: str, ckpt_dir: str):
    """The diag2021 preset on the cohorts under ``data_dir``: 2 folds of
    1 epoch, checkpoints and split dumps in ``ckpt_dir``."""
    from disentangled_multimodal_learning_tpu_torch.config import Config

    return Config.diag2021().replace(
        synthetic_data=False, dataDir=data_dir, kfold=2, epochs=1,
        checkpoints=ckpt_dir, printDataSplit=True, debug=True)


def run_real_data_entries(data_dir: str, ckpt_dir: str, dev,
                          card: str) -> None:
    """Phase 3i on the demo cohorts (``data/demo_cohort.py``) at the preset:
    (1) the training entry, TCGA + IvYGAP co-training, 2 folds: the fold
    sizes from the split dumps, no patient in both halves of a fold, and
    exact teacher counts (K1-fwd and K1-bwd 4 per step, K1-fwd 4 per eval
    batch); (2) fold 0 with ``buckets 1600,2500`` through the entry's own
    functions: every batch of one bucket (sides printed), a train batch at
    each of sides 40 and 50, the same counts per step, and K1-fwd and
    K1-bwd against their plain versions at side 40's shapes (side 50's are
    phase 2's); (3) the serving entry with ``external_eval`` on CPTAC's fold
    0, every logit finite; (4) IvYGAP's 20x batch from its pack and from
    its ``.npy`` files, bitwise.  Returns the side-40 kernel errors."""
    import csv

    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.data.native_io import (
        load_bag_batch)
    from disentangled_multimodal_learning_tpu_torch.data.datasets import (
        IvYGAP_Dataset)
    from disentangled_multimodal_learning_tpu_torch.data.cohorts import (
        read_manifest)

    cfg = real_data_cfg(data_dir, ckpt_dir)
    reset_counts()
    t0 = time.perf_counter()
    results = train_main.main(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    steps = evals = 0
    sizes = {}
    for fold in (0, 1):
        for cohort in ("tcga", "ivygap"):
            halves = []
            for tag in ("train", "test"):
                path = f"{ckpt_dir}/split_{cohort}_fold{fold}_{tag}.csv"
                with open(path) as f:
                    halves.append([r["patient_id"] for r in csv.DictReader(f)])
            sizes[(fold, cohort)] = tuple(map(len, halves))
            if set(halves[0]) & set(halves[1]):
                raise RuntimeError(f"{cohort} fold {fold}: a patient in "
                                   "both halves")
        n_test = sum(sizes[(fold, c)][1] for c in ("tcga", "ivygap"))
        steps += len(results[fold]["train_losses"])
        evals += -(-n_test // cfg.batch_size)
    losses = [x for r in results.values() for x in r["train_losses"]]
    want = _sum_counts(steps, dict(k1_fwd=4, k1_bwd=4), evals,
                       dict(k1_fwd=4))
    print(f"[real data] co-training, 2 folds, {setting(cfg)}: fold sizes "
          f"(train, test) {sizes}; {steps} steps + {evals} eval batches in "
          f"{wall:.2f} s (set-up and bag reads included); losses {losses}; "
          f"launches {n} | {card}")
    if n != want or not steps or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"real-data entry: launches {n}, want {want}, "
                           f"losses {losses}")

    bucketed = cfg.replace(buckets="1600,2500", cur_fold=0, checkpoints="#",
                           printDataSplit=False)
    fold, train_ds, test_ds = next(train_main.fold_datasets(bucketed))
    # the sizes of the gene lists that write_demo_cohorts writes
    if train_ds.omic_sizes != dict(input_size_omic=431,
                                   input_size_omic_tumor=59,
                                   input_size_omic_immune=361):
        raise RuntimeError(f"omic sizes {train_ds.omic_sizes}")
    bucketed = bucketed.replace(**train_ds.omic_sizes)
    train, test = train_main.make_loaders(bucketed, train_ds, test_ds)
    train.set_epoch(0)
    sides = {"train": [(int(b ** 0.5), len(sel) - pad)
                       for b, sel, pad in train.loader.plan()],
             "test": [(int(b ** 0.5), len(sel) - pad)
                      for b, sel, pad in test.plan()]}
    reset_counts()
    model, final, _ = train_main.dispatch_training(bucketed, dev,
                                                   (train, test))
    torch.cuda.synchronize()
    n = counts()
    want = _sum_counts(len(sides["train"]), dict(k1_fwd=4, k1_bwd=4),
                       len(sides["test"]), dict(k1_fwd=4))
    print(f"[real data] fold 0, buckets 1600,2500: omic sizes "
          f"{train_ds.omic_sizes}; batches (side, bags) {sides}; losses {final['train_losses']}; launches {n} | {card}")
    if (n != want or not all(map(math.isfinite, final["train_losses"]))
            or {s for s, _ in sides["train"]} != {40, 50}
            or {s for s, _ in sides["test"]} - {40, 50}):
        raise RuntimeError(f"bucketed fold: launches {n}, want {want}, "
                           f"train sides {sides['train']} (want 40 and 50)")
    errs = check_table_kernels_at_side(model, bucketed.batch_size, 40, dev,
                                       card)
    del model

    external = cfg.replace(external_eval=True, checkpoints="#")
    reset_counts()
    metrics, logits = inference.main(external, device=dev)
    torch.cuda.synchronize()
    n = counts()
    n_bags = len(next(iter(logits.values())))
    print(f"[real data] serving on CPTAC fold 0: {n_bags} bags; launches "
          f"{n}; auc_teas {metrics['auc_teas']} | {card}")
    check_outputs(metrics, logits, n_bags)
    if n != expect(k1_fwd=4 * -(-n_bags // 4)):
        raise RuntimeError(f"CPTAC serving: launches {n}")

    ivy = IvYGAP_Dataset(read_manifest(cfg, "IvYGAP"), cfg)
    rows = [0, 2, 4, 1]
    ids = [ivy.wsi_id(i) for i in rows]
    from_pack = ivy.batch(rows).x_path20
    from_npy = load_bag_batch([f"{ivy.root}/feats20/{w}.npy" for w in ids],
                              cfg.fixdim, cfg.input_path_dim)
    same = np.array_equal(from_pack, from_npy)
    print(f"[real data] IvYGAP 20x batch {ids}, bag lengths "
          f"{[ivy.bag_len(i) for i in rows]}: pack (rows "
          f"{[ivy._pack_for('feats20').rows(w) for w in ids]}) and .npy "
          f"bitwise equal: {same}")
    if not same:
        raise RuntimeError("the pack and the .npy files give other bags")
    return errs


def check_table_kernels_at_side(model, batch_size: int, side: int, dev,
                                card: str) -> dict:
    """Phase 3i: K1-fwd (bitwise, within ``K1_TOL``) and K1-bwd (within
    ``K1_BWD_TOL`` of float64, deterministic) at the shapes a bucket of
    ``side`` gives the teacher's 2-D attention in ``model``: its deformed
    grid at that side, its kv bound and ``batch_size x heads`` rows of kv
    points, up to 25% past the bound.  Returns the largest absolute errors
    (``k1``, ``k1_bwd``)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.deform_attention \
        import DeformCrossAttention2D
    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    attn = next(m for m in model.modules()
                if isinstance(m, DeformCrossAttention2D))
    conv = attn.to_offsets[0]
    with torch.no_grad():
        gh, gw = attn.to_offsets(torch.zeros(
            1, conv.in_channels, side, side, device=dev)).shape[-2:]
    gen = torch.Generator().manual_seed(2)
    c = table_backward_case(cpb, dev, gen, mlp_weights(1, gen, dev),
                            batch_size * attn.heads, gh * gw, side,
                            cpb.kv_bound_2d(attn.offset_scale, gh, gw))
    table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                               "dout"))
    with torch.inference_mode():
        got = cpb.table_interp(table, taps, fracs, side)
        want = cpb.table_interp_reference(table, taps, fracs, side)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    same = torch.equal(got, want)
    print(f"[K1] side {side} (bucket {side * side}): R={taps.shape[0]} "
          f"({batch_size} x {attn.heads} heads x {gh}x{gw} kv points) "
          f"tn={table.shape[0]} max_abs_err={err:.3e} (tol {K1_TOL}), "
          f"bitwise equal: {same} | {card}")
    if not same or not err <= K1_TOL:
        raise RuntimeError(f"K1 disagrees with its plain version at side "
                           f"{side}")
    return dict(k1=err, k1_bwd=check_table_backward(
        cpb, "K1-bwd", table, taps, fracs, dout, side, 1, K1_BWD_TOL, card))


def time_real_data(data_dir: str, dev, card: str) -> None:
    """Phase 6i on the demo cohorts at the preset, page cache warm: the
    host's time to build a batch of 4 (the ``.npy`` bags of one scale, the
    pack's, and a whole co-training batch: both scales, omics, labels),
    and the wall of one co-training epoch of teacher train steps with and
    without ``PrefetchLoader``, five times each, alternating after an
    epoch not kept, with the verdict: faster only if every prefetched epoch beats every plain one,
    slower only if every one is beaten, else unresolved."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.data.native_io import (
        load_bag_batch)
    from disentangled_multimodal_learning_tpu_torch.data.cohorts import (
        read_manifest)
    from disentangled_multimodal_learning_tpu_torch.data.datasets import (
        ConcatDataset, IvYGAP_Dataset, TCGA_Dataset)
    from disentangled_multimodal_learning_tpu_torch.data.loader import (
        BagLoader, PrefetchLoader)
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    cfg = real_data_cfg(data_dir, "#")
    ivy = IvYGAP_Dataset(read_manifest(cfg, "IvYGAP"), cfg)
    both = ConcatDataset([ivy, TCGA_Dataset(read_manifest(cfg, "TCGA"), cfg)])
    pack = ivy._pack_for("feats20")
    rows = list(range(4))
    ids = [ivy.wsi_id(i) for i in rows]
    npy = [f"{ivy.root}/feats20/{w}.npy" for w in ids]

    def host_ms(fn, n=10):
        fn()
        t = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return median(sorted(t))

    shape = (cfg.fixdim, cfg.input_path_dim)
    print(f"[time] host batch build, 4 bags of [{shape[0]}, {shape[1]}] f32 "
          f"(page cache warm): .npy "
          f"{host_ms(lambda: load_bag_batch(npy, *shape)):.3f}"
          f" ms, pack {host_ms(lambda: pack.get_batch(ids, *shape)):.3f} ms; "
          f"a whole co-training batch (2 scales, .npy) "
          f"{host_ms(lambda: both.batch([0, 7, 12, 15])):.3f} ms "
          f"(median of 10) | {card}")
    compare_native_reader(cfg, both, host_ms, card)
    model = define_net(cfg, dev)
    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(model, cfg, opt, make_scheduler(cfg, opt, 1000))
    walls = []
    # a first epoch not kept: the step's one-time set-up (allocator,
    # cuBLAS handles) would go to whichever setting came first
    for prefetch in (None,) + (False, True) * 5:
        loader = BagLoader(both, cfg.batch_size, shuffle=True, drop_last=True,
                           seed=cfg.seed)
        if prefetch:
            loader = PrefetchLoader(loader, depth=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in loader:
            step(batch_to_tensors(batch, dev))
        torch.cuda.synchronize()
        if prefetch is not None:
            walls.append((prefetch, len(loader),
                           round((time.perf_counter() - t0) * 1e3, 3)))
    plain = [w for p, _, w in walls if not p]
    fetched = [w for p, _, w in walls if p]
    verdict = ("faster" if max(fetched) < min(plain) else
               "slower" if min(fetched) > max(plain) else "unresolved")
    print(f"[time] one co-training epoch of {len(both)} bags, teacher train "
          f"steps at the preset, (prefetch, steps, wall ms): {walls}; "
          f"median plain {median(sorted(plain)):.3f} ms, prefetch "
          f"{median(sorted(fetched)):.3f} ms; prefetch {verdict} | {card}")
    del model, opt, step


def compare_native_reader(cfg, both, host_ms, card: str) -> None:
    """Phase 6i's reader check: a co-training batch of 4 (IvYGAP's 20x bags
    from its pack, the rest from ``.npy`` files) built by the threaded C++
    reader and by numpy (``DMLT_NO_NATIVE``, fresh datasets, so that no
    pack stays mapped natively), bitwise equal, with both host times."""
    import numpy as np

    from disentangled_multimodal_learning_tpu_torch.data import native_io
    from disentangled_multimodal_learning_tpu_torch.data.cohorts import (
        read_manifest)
    from disentangled_multimodal_learning_tpu_torch.data.datasets import (
        ConcatDataset, IvYGAP_Dataset, TCGA_Dataset)

    rows = [0, 7, 12, 15]
    native_io.reads.update(native=0, numpy=0)
    native = both.batch(rows)
    reads = dict(native_io.reads)
    native_ms = host_ms(lambda: both.batch(rows))
    os.environ["DMLT_NO_NATIVE"] = "1"
    try:
        plain_ds = ConcatDataset([
            IvYGAP_Dataset(read_manifest(cfg, "IvYGAP"), cfg),
            TCGA_Dataset(read_manifest(cfg, "TCGA"), cfg)])
        native_io.reads.update(native=0, numpy=0)
        plain = plain_ds.batch(rows)
        numpy_reads = dict(native_io.reads)
        numpy_ms = host_ms(lambda: plain_ds.batch(rows))
    finally:
        del os.environ["DMLT_NO_NATIVE"]
    fields = ("x_path10", "x_path20", "x_omic", "x_omic_tumor",
              "x_omic_immune", "label")
    equal = all(np.array_equal(getattr(native, f), getattr(plain, f))
                for f in fields)
    print(f"[time] a co-training batch of 4 at the preset (2 scales; "
          f"IvYGAP's 20x from its pack): the threaded C++ reader "
          f"{native_ms:.3f} ms (reads {reads}), numpy {numpy_ms:.3f} ms "
          f"(reads {numpy_reads}), host ms, median of 10, page cache warm; "
          f"bitwise equal: {equal} | host {host_cpu()} | {card}")
    if (not equal or reads != {"native": 8, "numpy": 0}
            or numpy_reads != {"native": 0, "numpy": 8}):
        raise RuntimeError("the native reader's batch differs from numpy's, "
                           "or a path read what it should not")


def baseline_configs(train_preset) -> list:
    """Phase 3j's runs: every baseline at the preset, 2 steps and 1 eval
    batch (``pathomic`` also with ``fusion_type pofusion``, the only
    BatchNorm on any path), then MCAT and CMTA on the survival preset (B
    8, 1 step and 1 eval batch, the c-index)."""
    from disentangled_multimodal_learning_tpu_torch.config import Config

    surv = Config.from_yaml("config/config_mine_surv.yaml").replace(
        synthetic_data=True, synthetic_train_size=8, synthetic_test_size=8,
        kfold=1, epochs=1, checkpoints="#", debug=True)
    return ([train_preset.replace(mode=m, synthetic_train_size=2 * 4, **kw)
             for m, kw in BASELINES]
            + [surv.replace(mode=m) for m in ("mcat", "cmta")])


def baseline_setting(cfg) -> str:
    out = cfg.mode
    if cfg.fusion_type != "concat":
        out += f", fusion {cfg.fusion_type}"
    return out + f", {cfg.task_type} B {cfg.batch_size}"


def _tensors(out) -> list:
    """The tensors of a model's output, in order (lists walked; ``None``
    and JAX's placeholder zeros skipped)."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def run_baseline_entries(train_preset, dev, card: str,
                         ckpt_dir: str) -> None:
    """Phase 3j: each baseline run of ``baseline_configs`` through the
    training entry (1 fold, every step and the final evaluation with 0
    launches of every kernel, every loss and metric finite), its
    checkpoint in ``ckpt_dir``; the serving entry restores it and gives
    the final evaluation's outputs bitwise, again with 0 launches.  Then
    deformpathomic at attn_dim 2 with BilinearFusion (``fusion_type
    pofusion``; ``gradient_modulate`` off, which needs the concatenated
    classifier) through both entries with its usual counts (K1-fwd 2 and
    K1-bwd 2 a step, K1-fwd 2 an eval batch), served bitwise."""
    import glob

    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference

    dp = train_preset.replace(mode="deformpathomic", attn_dim=2,
                              fusion_type="pofusion",
                              gradient_modulate=False)
    for cfg in baseline_configs(train_preset) + [dp]:
        cfg = cfg.replace(checkpoints=ckpt_dir)
        per_step, per_eval = ((dict(k1_fwd=2, k1_bwd=2), dict(k1_fwd=2))
                              if cfg.mode == "deformpathomic" else ({}, {}))
        run = {}
        steps = cfg.synthetic_train_size // cfg.batch_size
        run_training_entry(cfg, dev, steps, per_step, per_eval, card, out=run)
        final = run["final"]
        ckpt, = glob.glob(f"{ckpt_dir}/{cfg.mode}_fold_1_epoch_1_*.pt")
        reset_counts()
        metrics, logits = inference.main(cfg.replace(checkpoints_student=ckpt),
                                         device=dev)
        torch.cuda.synchronize()
        served = counts()
        os.remove(ckpt)
        same = {k: bool(np.array_equal(v, final["logits"][k]))
                for k, v in logits.items()}
        n_bags = cfg.synthetic_test_size
        finite = all(np.isfinite(v).all() and v.shape[0] == n_bags
                     for v in logits.values())
        print(f"[baselines] {baseline_setting(cfg)}: served from {ckpt}: "
              f"launches {served}; outputs bitwise equal to the run's final "
              f"evaluation: {same}; metrics {metrics} | {card}")
        if (served != _sum_counts(0, {}, -(-n_bags // cfg.batch_size),
                                  per_eval)
                or set(logits) != set(final["logits"]) or not finite
                or not all(same.values())
                or not all(map(math.isfinite, metrics.values()))):
            raise RuntimeError(f"{baseline_setting(cfg)}: the served model "
                               "disagrees with its final evaluation")


def compare_baselines_f32(f32, batch, dev) -> None:
    """Phase 5j: each baseline's f32 forward (eval mode) on the card against
    the same seeded weights on the CPU, every output within ``LOGITS_TOL``;
    those of ``F64_MODES`` also against a float64 CPU run (card within
    ``NYSTROM_F64_FACTOR`` times the CPU f32's own error, or within
    ``LOGITS_TOL``); then one ``deterministic_training`` step
    (``compare_baseline_step``)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    for mode, kw in BASELINES:
        t0 = time.perf_counter()
        cfg = f32.replace(mode=mode, **kw)
        with torch.inference_mode():
            got = _tensors(define_net(cfg, dev)(
                **model_inputs(batch, dev, mode)))
            want = _tensors(define_net(cfg, "cpu")(
                **model_inputs(batch, "cpu", mode)))
            if mode in F64_MODES:
                x64 = {k: v.double() for k, v in
                       model_inputs(batch, "cpu", mode).items()}
                f64 = _tensors(define_net(cfg, "cpu").double()(**x64))
        errs = [(a.cpu() - b).abs().max().item() for a, b in zip(got, want)]
        line = (f"[f32] {baseline_setting(cfg)} card vs CPU: {len(errs)} "
                f"outputs, max_abs_err {max(errs):.3e} (tol {LOGITS_TOL})")
        ok = len(got) == len(want) and max(errs) <= LOGITS_TOL
        if mode in F64_MODES:
            e_card = max((a.cpu().double() - c).abs().max().item()
                         for a, c in zip(got, f64))
            e_cpu = max((b.double() - c).abs().max().item()
                        for b, c in zip(want, f64))
            line += (f"; against float64: card {e_card:.3e}, CPU f32 "
                     f"{e_cpu:.3e} (tol {NYSTROM_F64_FACTOR} x the CPU's or "
                     f"{LOGITS_TOL})")
            ok = ok or e_card <= max(NYSTROM_F64_FACTOR * e_cpu, LOGITS_TOL)
        print(line + f" | {card_line()}")
        if not ok:
            raise RuntimeError(f"f32 {mode} outputs on the card disagree with "
                               "the CPU")
        compare_baseline_step(cfg.replace(deterministic_training=True), batch,
                              dev)
        torch.cuda.empty_cache()
        print(f"[f32] {baseline_setting(cfg)}: forwards and steps in "
              f"{time.perf_counter() - t0:.2f} s (CPU runs included)")


def compare_baseline_step(cfg, batch, dev) -> None:
    """Phase 5j: one ``deterministic_training`` f32 step of a baseline from
    the same seeded weights on the same batch, on the card and on the CPU
    (``compare_train_step``'s tolerances); for ``F64_MODES`` also in
    float64 on the CPU, the card's loss and gradients held to it within
    ``NYSTROM_F64_FACTOR`` times the CPU f32's own errors or within
    ``TASK_LOSS_TOL`` / ``GRAD_TOL`` (the zero-gradient biases: see
    ``F64_MODES``)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    if cfg.mode not in F64_MODES:
        compare_train_step(cfg, batch, dev)
        return
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = define_net(cfg, device).to(dtype)
        step = make_train_step(model, cfg, make_optimizer(
            cfg, model.parameters()))
        x = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch_to_tensors(batch, device).items()}
        m = step(x)
        out.append((m["loss"].item(), {
            n: p.grad.double().cpu() for n, p in model.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu), (l_64, g_64) = out

    def rel(got, want):
        return ((got - want).norm() / max(want.norm().item(), 1e-30)).item()

    e_loss = (abs(l_card - l_64) / abs(l_64), abs(l_cpu - l_64) / abs(l_64))
    e_grad = {n: (rel(g_card[n], w), rel(g_cpu[n], w))
              for n, w in g_64.items() if not n.endswith(ZERO_GRAD_BIASES)}
    bad = [n for n, (c, h) in e_grad.items()
           if c > max(NYSTROM_F64_FACTOR * h, GRAD_TOL)]
    for n in g_64:
        if n.endswith(ZERO_GRAD_BIASES):
            scale = g_64[n[:-4] + "weight"].abs().max().item()
            card, cpu = (g[n].abs().max().item() / scale
                         for g in (g_card, g_cpu))
            print(f"[f32 step] {n}: 0 in exact arithmetic; card {card:.2e}, "
                  f"CPU f32 {cpu:.2e} of its weight's gradient (tol "
                  f"{ZERO_GRAD_FLOOR_1D} or {NYSTROM_F64_FACTOR} x the CPU's)")
            if card > max(ZERO_GRAD_FLOOR_1D, NYSTROM_F64_FACTOR * cpu):
                bad.append(n)
    worst = sorted(e_grad.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"[f32 step] {baseline_setting(cfg)} against float64 on the CPU: "
          f"loss card {e_loss[0]:.2e}, CPU f32 {e_loss[1]:.2e} rel (tol "
          f"{NYSTROM_F64_FACTOR} x the CPU's or {TASK_LOSS_TOL}); "
          f"{len(e_grad)} gradients, worst rel-L2 (card, CPU f32) {worst} "
          f"(tol {NYSTROM_F64_FACTOR} x the CPU's or {GRAD_TOL}) "
          f"| {card_line()}")
    if bad or e_loss[0] > max(NYSTROM_F64_FACTOR * e_loss[1], TASK_LOSS_TOL):
        raise RuntimeError(f"the f32 {cfg.mode} step on the card disagrees "
                           f"with float64: {bad}")


def nystrom_core_ms(shapes, dev, train: bool) -> float:
    """Device-busy ms (profiler) of the Nystrom cores of one forward (with
    ``train``, forward and backward): ``shapes`` lists ``(calls, B, H, N,
    D, landmarks)``, each core run on random q, k, v of that shape."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.ops.nystrom import (
        nystrom_attention)

    gen = torch.Generator(device=dev).manual_seed(0)
    total = 0.0
    for calls, B, H, N, D, m in shapes:
        q, k, v = (torch.randn(B, H, N, D, device=dev, generator=gen,
                               requires_grad=train) for _ in range(3))
        g = torch.randn(B, H, N, D, device=dev, generator=gen)

        def core():
            out = nystrom_attention(q * D ** -0.5, k, v, m)
            if train:
                torch.autograd.grad(out, (q, k, v), g)

        with torch.inference_mode(not train):
            busy, _ = profile(f"Nystrom core [{B}, {H}, {N}, {D}], m {m}, "
                              f"train {train}", core, rows=8)
        total += calls * busy
    return total


def time_baselines(preset, train_preset, batch, dev, card: str) -> None:
    """Phase 6j: per baseline at the preset's widths, the eval forward (50
    calls) and the train step (30 steps, dropout on), bags/s median and
    p80 (CUDA events, the batch resident on the card), and the profiler's
    device-busy share of each; for TransMIL and CMTA the share of that
    device time in their Nystrom cores (the cores timed alone at the
    model's shapes, ``nystrom_core_ms``)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)

    x = batch_to_tensors(batch, dev)
    B, N = batch.x_path10.shape[:2]
    n_tok = math.ceil(math.sqrt(N)) ** 2 + 1  # square-padded, the cls token
    core_shapes = {"transmil": [(2, B, 8, n_tok, 64, 256)],
                   "cmta": [(4, B, 8, n_tok, 32, 128), (4, B, 8, 5, 32, 128)]}
    for mode, kw in BASELINES:
        cfg = preset.replace(mode=mode, **kw)
        model = define_net(cfg, dev)
        with torch.inference_mode():
            xi = model_inputs(batch, dev, mode)
            ms = ms_samples(lambda: model(**xi), 50)
            busy_e, wall_e = profile(f"eval forward ({baseline_setting(cfg)})",
                                     lambda: model(**xi), rows=10)
        del model
        tcfg = train_preset.replace(mode=mode, **kw)
        model = define_net(tcfg, dev)
        opt = make_optimizer(tcfg, model.parameters())
        step = make_train_step(model, tcfg, opt,
                               make_scheduler(tcfg, opt, 1000))
        ms_t = ms_samples(lambda: step(x), 30)
        busy_t, wall_t = profile(f"train step ({baseline_setting(tcfg)})",
                                 lambda: step(x), n=3, rows=10)
        del model, opt, step
        med, p80 = median(ms), ms[int(0.8 * len(ms))]
        med_t, p80_t = median(ms_t), ms_t[int(0.8 * len(ms_t))]
        line = (f"[time] {baseline_setting(cfg)} fixdim {N}: eval forward "
                f"median {med:.3f} ms = {1000 * B / med:.1f} bags/s, p80 "
                f"{p80:.3f} ms = {1000 * B / p80:.1f} bags/s, device busy "
                f"{busy_e:.3f} of {wall_e:.3f} ms ({busy_e / wall_e:.1%}); "
                f"train step median {med_t:.3f} ms = {1000 * B / med_t:.1f} "
                f"train bags/s, p80 {p80_t:.3f} ms = {1000 * B / p80_t:.1f}, "
                f"device busy {busy_t:.3f} of {wall_t:.3f} ms "
                f"({busy_t / wall_t:.1%})")
        if mode in core_shapes:
            core_e = nystrom_core_ms(core_shapes[mode], dev, train=False)
            core_t = nystrom_core_ms(core_shapes[mode], dev, train=True)
            line += (f"; Nystrom cores {core_e:.3f} ms = "
                     f"{core_e / busy_e:.1%} of the forward's device time, "
                     f"{core_t:.3f} ms = {core_t / busy_t:.1%} of the "
                     f"step's")
        print(line + f" | {card}")
        torch.cuda.empty_cache()


def k7_bounds(BH: int, N: int, K: int, D: int) -> tuple:
    """``(forward, backward)`` bounds of K7: the forward reads q, k, v,
    grid_q, grid_kv and the weights and writes out and attn, and does K2's
    MLP flops at every (query, kv) point on the CUDA cores and the sim and
    PV products on the tensor cores, 3 TF32 passes of 2 flops a
    multiply-add each; the backward also reads attn and both
    cotangents and writes dq, dk, dv, dgrid_kv and the weight cotangents,
    and does K2-bwd's flops on the CUDA cores and the four products (dp,
    dv, dq, dk) on the tensor cores, 3 TF32 passes each."""
    points = BH * N * K
    macs = BH * N * K * D
    qkv = 4 * (BH * N * D + 2 * BH * K * D)
    small = 4 * (2 * N + 2 * BH * K + 2 * cpb_param_count(1))
    fwd = bound(qkv + small + 4 * (BH * N * D + points),
                k2_fwd_flops(points, 1), 3 * 4 * macs)
    bwd = bound(2 * qkv + small + 4 * (BH * N * D + 2 * points),
                k2_bwd_flops(points, 1), 3 * 8 * macs)
    return fwd, bwd


def cpb_param_count(o: int, hid: int = 32) -> int:
    return hid * (2 + 1 + hid + 1) + (hid + 1) * o


AUX_EVAL_TAGS = ("tea10", "tea20", "teas")
# phase 5k: IG and SHAP on the card against the CPU, rel-L2 (f32 both:
# cuBLAS and the CPU sum in other orders, each step a forward and a
# backward); IG's completeness gap at 256 steps, relative to |f(x) - f(0)|
IMPORTANCE_TOL = 1e-4
COMPLETENESS_TOL = 1e-2
# a ReLU input within this share of its call's largest |input| of 0 in
# float64 is a tie f32 rounding may break either way (2^-20, ~8 ulps):
# MCAT's IG from 0 met one at step 3 of 32, an omic transformer's FFN
# input at -3.5e-8 in float64 (scale 4.0) and +1.5e-7 on the card, whose
# gradient there is then 4.6e-3 off (H100 run)
RELU_TIE = 2.0 ** -20
# completeness is held on pathomic only: MCAT's seeded biases are 0, so
# at x_omic = 0 its signature tokens are exactly 0, and their LayerNorm (eps
# 1e-6) jumps to unit scale between alpha 0 and ~1e-4, inside the first
# midpoint's interval (CPU, fixdim 64: f(1e-6 x) - f(0) is 0.18 on a logit
# of 0.12), so sum(IG) misses that jump; its gap is printed
COMPLETENESS_MODES = ("pathomic",)
# phase 6k: the StepTimer's per-step time against the CUDA-events median
STEP_TIMER_TOL = 0.10


def _png_size(path: str) -> tuple:
    """A PNG's (width, height, bit depth, colour type) from its IHDR."""
    import struct

    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise RuntimeError(f"{path} is not a PNG")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, colour


def _jsonl_lines(log_dir: str) -> list:
    """Every line of the run files in ``log_dir``, in order, without their
    time."""
    import glob

    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for path in sorted(glob.glob(f"{log_dir}/run_*.jsonl"))
            for line in open(path).read().splitlines()]


def _leaf_values(payload) -> list:
    if isinstance(payload, dict):
        return [x for v in payload.values() for x in _leaf_values(v)]
    return [payload]


def _keys(payload):
    """A payload's nested key structure (its leaves None)."""
    if isinstance(payload, dict):
        return {k: _keys(v) for k, v in payload.items()}
    return None


def run_logging_entries(train_preset, dev, card: str, tmp: str) -> None:
    """Phase 3k: the training entry at the preset with its logging on
    (``debug`` off, ``log_dir`` under ``tmp``): 2 steps, a cadence
    evaluation after the second (``eval_every_iters`` 2) and the final
    one, K1-fwd 4 a step and an eval batch, K1-bwd 4 a step; its JSONL
    line read back with JAX's keys (``training``: loss, taskloss,
    batchloss; ``test``: per metric the three tags' values), every value
    finite.  The serving entry restores the fold's checkpoint with
    ``save4visualization`` (K1-fwd 4 for the metrics and 4 for the maps
    of its one batch) and logs ``{"inference": ...}``;
    ``utils/heatmap.render_export`` turns its npz into one 400 x 400 RGB
    PNG per (slide, map) and ``summary.csv``.  Then both entries under
    ``debug`` write no file."""
    import glob

    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.utils.heatmap import (
        render_export)

    log_dir, ckpt_dir = f"{tmp}/logs", f"{tmp}/ckpt"
    cfg = train_preset.replace(debug=False, log_dir=log_dir,
                               synthetic_train_size=2 * 4,
                               eval_every_iters=2, checkpoints=ckpt_dir)
    reset_counts()
    t0 = time.perf_counter()
    train_main.main(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_train = counts()
    want = _sum_counts(2, dict(k1_fwd=4, k1_bwd=4), 2, dict(k1_fwd=4))
    ckpt, = glob.glob(f"{ckpt_dir}/teacher_fold_1_epoch_1_*.pt")
    serve = cfg.replace(checkpoints_teacher=ckpt, save4visualization=True)
    reset_counts()
    inference.main(serve, device=dev)
    torch.cuda.synchronize()
    n_serve = counts()
    lines = _jsonl_lines(log_dir)
    metric_keys = {n: {f"{n}_{t}": None for t in AUX_EVAL_TAGS}
                   for n in ("acc", "f1", "auc", "bac", "sens", "spec",
                             "prec")}
    want_keys = [{"training": dict.fromkeys(("loss", "taskloss",
                                             "batchloss")),
                  "test": metric_keys},
                 {"inference": dict.fromkeys(metric_keys)}]
    values = [x for line in lines for x in _leaf_values(line)]
    print(f"[logging] training entry, 2 steps + 2 eval batches in "
          f"{wall:.2f} s: launches {n_train} (want {want}); serving with the "
          f"maps: launches {n_serve}; {len(lines)} JSONL lines in "
          f"{log_dir}: {lines} | {card}")
    if (n_train != want or n_serve != expect(k1_fwd=8)
            or [_keys(line) for line in lines] != want_keys
            or not all(isinstance(x, float) and math.isfinite(x)
                       for x in values)):
        raise RuntimeError("the entries' logs or launches are not what the "
                           "run implies")
    npz = f"{ckpt_dir}/attention_fold0.npz"
    t0 = time.perf_counter()
    files = render_export(npz, f"{tmp}/heatmaps")
    render_s = time.perf_counter() - t0
    pngs = [f for f in files if f.endswith(".png")]
    sizes = {_png_size(f) for f in pngs}
    summary = open(f"{tmp}/heatmaps/summary.csv").read().splitlines()
    print(f"[heatmap] {npz}: {len(pngs)} PNGs {sorted(sizes)} (width, "
          f"height, bit depth, colour type) and summary.csv of "
          f"{len(summary) - 1} rows in {render_s:.3f} s; header "
          f"{summary[0]}")
    side = math.isqrt(cfg.fixdim) * 8  # the grid, 8 pixels a patch
    if (len(pngs) != 4 * 4 or sizes != {(side, side, 8, 2)}
            or len(summary) != 1 + 4):
        raise RuntimeError("the heatmaps are not one 400 x 400 RGB PNG per "
                           "slide and map")
    quiet = cfg.replace(debug=True, log_dir=f"{tmp}/quiet",
                        synthetic_train_size=4, checkpoints="#")
    train_main.main(quiet, device=dev)
    inference.main(quiet, device=dev)
    print(f"[logging] under debug: {tmp}/quiet exists: "
          f"{os.path.exists(f'{tmp}/quiet')}")
    if os.path.exists(f"{tmp}/quiet"):
        raise RuntimeError("a debug run wrote a log")


def check_coverage_gaps(f32, batch, dev, card: str) -> None:
    """Phase 3l: the uniteacher's eval forward (K1-fwd 4) and one
    ``deterministic_training`` step (K1-fwd 4, K1-bwd 4) on the card
    against the CPU, and one teacher step on the ``grade`` and the
    ``subtype`` task (3 classes each) against the CPU, each with its
    counts (f32, the tolerances of phases 5 and 5b)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)

    uni = f32.replace(mode="uniteacher")
    reset_counts()
    with torch.inference_mode():
        card_out = define_net(uni, dev)(
            **model_inputs(batch, dev, "uniteacher"))[2]
        torch.cuda.synchronize()
        n_fwd = counts()
        cpu_out = define_net(uni, "cpu")(
            **model_inputs(batch, "cpu", "uniteacher"))[2]
    errs = {k: (card_out[k].cpu() - cpu_out[k]).abs().max().item()
            for k in cpu_out}
    print(f"[coverage] uniteacher f32 eval forward: launches {n_fwd}; card "
          f"vs CPU logits max_abs_err {max(errs.values()):.3e} (tol "
          f"{LOGITS_TOL}); per output {errs} | {card}")
    if n_fwd != expect(k1_fwd=4) or not max(errs.values()) <= LOGITS_TOL:
        raise RuntimeError("the uniteacher's forward on the card disagrees "
                           "with the CPU")
    for cfg in (uni, f32.replace(task_type="grade").validate(),
                f32.replace(task_type="subtype").validate()):
        reset_counts()
        compare_train_step(cfg.replace(deterministic_training=True), batch,
                           dev)
        n = counts()
        print(f"[coverage] {cfg.mode} on {cfg.task_type} ({cfg.label_dim} "
              f"classes): the card step's launches {n}")
        if n != expect(k1_fwd=4, k1_bwd=4):
            raise RuntimeError(f"{cfg.mode} on {cfg.task_type}: launches {n}")


def _importance_case(cfg, device, dtype, batches):
    """The model of ``cfg`` (seeded) on ``device`` in ``dtype``, the
    true-class logit function of ``batches[0]`` and its omic input, and the
    background rows of every batch, in ``dtype``."""
    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.utils import importance

    model = define_net(cfg, device).to(dtype).eval()
    b = batches[0]
    if dtype == torch.float64:  # the batch's float inputs in float64
        b = type(b)(**{k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                           and v.dtype == np.float32 else v)
                       for k, v in vars(b).items()})
    logit_fn = importance.true_class_logit_fn(model, cfg, b)
    x = torch.as_tensor(b.x_omic, device=device)
    background = np.concatenate([c.x_omic for c in batches]).astype(
        b.x_omic.dtype)
    return logit_fn, x, background


def _point_gradient(fn, x, x0, alpha: float):
    """The gradient of ``fn``'s summed logits at ``x0 + alpha (x - x0)``
    (float64 on the host) and the input of every ReLU the forward applied
    there (float64 on the host; a torch function mode records them)."""
    import torch

    class ReluInputs(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.inputs = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.nn.functional.relu:
                self.inputs.append(args[0].detach().double().cpu())
            return func(*args, **(kwargs or {}))

    xi = (x0 + alpha * (x - x0)).requires_grad_()
    with ReluInputs() as rec:
        g, = torch.autograd.grad(fn(xi).sum(), xi)
    return g.double().cpu(), rec.inputs


def _is_relu_tie(card_inputs, ref_inputs) -> bool:
    """Some ReLU input takes the other sign on the card than in the
    reference, and every such input of the reference lies within
    ``RELU_TIE`` of its call's largest |input| (f32 rounding): the card
    took the other branch of a tie."""
    flipped = False
    for zc, zr in zip(card_inputs, ref_inputs, strict=True):
        flip = (zc > 0) != (zr > 0)
        if flip.any():
            if not (zr[flip].abs() <= RELU_TIE * zr.abs().max()).all():
                return False
            flipped = True
    return flipped


def _attribution_without_ties(card_case, ref_case, baselines, steps: int):
    """An attribution (the mean over ``baselines`` of IG at ``steps``
    midpoints) recomputed point by point on the card and in the reference,
    leaving out on both sides the points where the card took the other
    branch of a ReLU tie (``_is_relu_tie``): ``(rel-L2 of the rest, [(
    baseline, step, that point's gradient rel-L2)])``."""
    import numpy as np
    import torch

    (fn_c, x_c), (fn_r, x_r) = card_case, ref_case
    sums, ties = [0.0, 0.0], []
    for j, base in enumerate(baselines):
        b_c = torch.as_tensor(np.ascontiguousarray(base), dtype=x_c.dtype,
                              device=x_c.device).expand_as(x_c)
        b_r = torch.as_tensor(np.ascontiguousarray(base), dtype=x_r.dtype,
                              device=x_r.device).expand_as(x_r)
        keep = [torch.zeros(x_r.shape, dtype=torch.float64)] * 2
        for i in range(steps):
            alpha = (i + 0.5) / steps
            g_c, z_c = _point_gradient(fn_c, x_c, b_c, alpha)
            g_r, z_r = _point_gradient(fn_r, x_r, b_r, alpha)
            if _is_relu_tie(z_c, z_r):
                ties.append((j, i, ((g_c - g_r).norm()
                                    / g_r.norm()).item()))
            else:
                keep = [keep[0] + g_c, keep[1] + g_r]
        sums[0] = sums[0] + (x_c - b_c).double().cpu() * keep[0]
        sums[1] = sums[1] + (x_r - b_r).double().cpu() * keep[1]
    err = ((sums[0] - sums[1]).norm() / sums[1].norm()).item()
    return err, ties


def compare_importance(f32, dev, card: str) -> None:
    """Phase 5k: integrated gradients (32 steps) and expected-gradients SHAP
    (8 baselines drawn from the 8 bags of two batches, 16 steps) of the
    true-class logit of a batch of 4 bags, ``pathomic`` and ``mcat`` at
    the preset's widths (431 genes), on the card and on the CPU from the
    same seeded weights: within ``IMPORTANCE_TOL`` rel-L2; MCAT (its path
    pooling's gradients cancel) against float64 on the CPU, the card
    within ``NYSTROM_F64_FACTOR`` times the CPU f32's error or
    ``IMPORTANCE_TOL``.  An attribution off by more is recomputed point by
    point on both sides: the points where the card took the other branch
    of a ReLU tie (``_is_relu_tie``) are named and left out of both, and
    the rest is held to ``IMPORTANCE_TOL``.  IG's completeness on the card:
    at 256 steps each bag's attributions sum to f(x) - f(0) within
    ``COMPLETENESS_TOL`` of the largest such difference (held for
    ``COMPLETENESS_MODES``, printed for MCAT).  Baseline modes: no kernel
    launches."""
    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch.utils import importance

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    for mode in ("pathomic", "mcat"):
        cfg = f32.replace(mode=mode, synthetic_test_size=8)
        batches = list(inference.build_fold0_test_loader(cfg))
        runs, cases = {}, {}
        kinds = [(dev, torch.float32), ("cpu", torch.float32)]
        if mode in F64_MODES:
            kinds.append(("cpu", torch.float64))
        reset_counts()
        for device, dtype in kinds:
            fn, x, bg = _importance_case(cfg, device, dtype, batches)
            t0 = time.perf_counter()
            ig = importance.integrated_gradients(fn, x, steps=32)
            if device == dev:
                torch.cuda.synchronize()
            t_ig = time.perf_counter() - t0
            t0 = time.perf_counter()
            shap = importance.expected_gradients_shap(
                fn, x, bg, n_baselines=8, steps=16, seed=0)
            t_shap = time.perf_counter() - t0
            runs[(str(device), dtype)] = (ig, shap)
            cases[(str(device), dtype)] = (fn, x, bg)
            print(f"[importance] {mode} on {device} {dtype}: IG 32 steps "
                  f"{t_ig:.3f} s, SHAP 8 x 16 {t_shap:.3f} s for 4 bags "
                  f"| {card}")
            if device == dev:
                with torch.inference_mode():
                    gap = (fn(x) - fn(torch.zeros_like(x))).double().cpu()
                ig256 = importance.integrated_gradients(fn, x, steps=256)
                completeness = (np.abs(ig256.sum(axis=1) - gap.numpy()).max()
                                / gap.abs().max().item())
                completeness32 = (np.abs(ig.sum(axis=1) - gap.numpy()).max()
                                  / gap.abs().max().item())
        n = counts()
        ref_kind = (("cpu", torch.float64) if mode in F64_MODES
                    else ("cpu", torch.float32))
        card_f32 = runs[(str(dev), torch.float32)]
        cpu_f32 = runs[("cpu", torch.float32)]
        ref = runs[ref_kind]
        errs = [rel(a, b) for a, b in zip(card_f32, ref)]
        line = (f"[importance] {mode}: card vs CPU "
                f"{'float64' if mode in F64_MODES else 'f32'} rel-L2 IG "
                f"{errs[0]:.3e}, SHAP {errs[1]:.3e}")
        bounds = [IMPORTANCE_TOL] * 2
        if mode in F64_MODES:
            own = [rel(a, b) for a, b in zip(cpu_f32, ref)]
            line += (f"; CPU f32 vs float64 IG {own[0]:.3e}, SHAP "
                     f"{own[1]:.3e} (tol {NYSTROM_F64_FACTOR} x the CPU's "
                     f"or {IMPORTANCE_TOL})")
            bounds = [max(NYSTROM_F64_FACTOR * o, IMPORTANCE_TOL)
                      for o in own]
        else:
            line += f" (tol {IMPORTANCE_TOL})"
        ok = True
        fn_c, x_c, _ = cases[(str(dev), torch.float32)]
        fn_r, x_r, bg = cases[ref_kind]
        # SHAP's baselines: expected_gradients_shap's draw at seed 0
        rows = np.random.default_rng(0).choice(len(bg), size=8,
                                               replace=False)
        for k, (name, bases, steps) in enumerate((
                ("IG", [np.zeros(x_r.shape[1:])], 32),
                ("SHAP", bg[rows], 16))):
            if errs[k] <= bounds[k]:
                continue
            rest, ties = _attribution_without_ties(
                (fn_c, x_c), (fn_r, x_r), bases, steps)
            print(f"[importance] {mode} {name}: {errs[k]:.3e} over its bound "
                  f"{bounds[k]:.1e}; the card took the other branch of a "
                  f"ReLU tie (within {RELU_TIE:.1e} of the call's largest "
                  f"input) at (baseline, step, that point's gradient "
                  f"rel-L2) {ties}; without those points on either side "
                  f"{rest:.3e} (tol {IMPORTANCE_TOL}) | {card}")
            ok &= bool(ties) and rest <= IMPORTANCE_TOL
        del cases, fn_c, x_c, fn_r, x_r
        held = mode in COMPLETENESS_MODES
        print(line + f"; completeness on the card: |sum(IG) - (f(x) - "
              f"f(0))| / max|f(x) - f(0)| {completeness32:.3e} at 32 steps, "
              f"{completeness:.3e} at 256 (tol {COMPLETENESS_TOL}"
              f"{'' if held else ', not held: f jumps at x_omic = 0'}); "
              f"launches {n} | {card}")
        if (not ok or (held and not completeness <= COMPLETENESS_TOL)
                or n != expect() or not np.abs(card_f32[0]).max() > 0):
            raise RuntimeError(f"{mode}: importance on the card disagrees "
                               "with the CPU")


def time_aux(train_preset, f32, batch, dev, card: str) -> None:
    """Phase 6k: ``utils/profiling.trace`` around 5 teacher train steps at
    the preset: its Chrome trace names K1-fwd's kernel and K1-bwd's tile
    kernel 4 x 5 times each (and the wrappers count 20 each); the
    ``StepTimer``'s per-step time over 30 steps against the CUDA-events
    median of the same steps, within ``STEP_TIMER_TOL``; then ablation and
    permutation importance (``n_trials`` 1) of ``pathomic`` over 8 eval
    bags (431 genes), timed."""
    import numpy as np
    import torch

    from disentangled_multimodal_learning_tpu_torch import inference
    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors, make_train_step)
    from disentangled_multimodal_learning_tpu_torch.utils import importance
    from disentangled_multimodal_learning_tpu_torch.utils.profiling import (
        StepTimer, trace)

    x = batch_to_tensors(batch, dev)
    model = define_net(train_preset, dev)
    opt = make_optimizer(train_preset, model.parameters())
    step = make_train_step(model, train_preset, opt,
                           make_scheduler(train_preset, opt, 1000))
    for _ in range(3):
        step(x)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        reset_counts()
        with trace(tmp) as path:
            for _ in range(5):
                m = step(x)
            torch.cuda.synchronize()
        n = counts()
        events = json.load(open(path))["traceEvents"]
        size = os.path.getsize(path)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1_fwd = sum("cpb_table_interp_fwd_kernel" in k for k in kernels)
    k1_bwd = sum("table_bwd_tile_kernel" in k for k in kernels)
    print(f"[trace] 5 teacher train steps: {size} B Chrome trace, "
          f"{len(kernels)} kernel events, K1-fwd {k1_fwd}, K1-bwd (tile "
          f"kernel) {k1_bwd}; wrapper counts {n} | {card}")
    if k1_fwd != 20 or k1_bwd != 20 or n != expect(k1_fwd=20, k1_bwd=20):
        raise RuntimeError("the trace does not name K1-fwd and K1-bwd 20 "
                           "times each")
    timer = StepTimer()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(30)]
    timer.calibrate(x)
    timer.start()
    for start, end in ev:
        start.record()
        m = step(x)
        end.record()
        timer.count()
    per_step = timer.stop(m) * 1e3
    ms = sorted(s.elapsed_time(e) for s, e in ev)
    off = abs(per_step - median(ms)) / median(ms)
    print(f"[timer] teacher train step B=4 at the preset: StepTimer "
          f"{per_step:.3f} ms a step (fence roundtrip "
          f"{timer.roundtrip * 1e3:.4f} ms), CUDA events median "
          f"{median(ms):.3f} ms, mean {sum(ms) / len(ms):.3f} ms (30 steps);"
          f" {off:.1%} apart (tol {STEP_TIMER_TOL:.0%}) | {card}")
    if not off <= STEP_TIMER_TOL:
        raise RuntimeError("the StepTimer disagrees with CUDA events")
    del model, opt, step
    torch.cuda.empty_cache()
    cfg = f32.replace(mode="pathomic", synthetic_test_size=8)
    batches = list(inference.build_fold0_test_loader(cfg))
    model = define_net(cfg, dev)
    score = importance.make_omic_score_fn(model, cfg, batches)
    xo = np.concatenate([b.x_omic for b in batches])
    score(xo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    abl = importance.ablation_feature_importance(score, xo)
    t_abl = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = importance.permutation_feature_importance(score, xo, n_trials=1)
    t_perm = time.perf_counter() - t0
    print(f"[importance] pathomic, 8 bags x {xo.shape[1]} genes: ablation "
          f"{t_abl:.3f} s ({xo.shape[1] + 1} scores of 2 eval batches), "
          f"permutation (1 trial) {t_perm:.3f} s; {np.count_nonzero(abl)} "
          f"and {np.count_nonzero(perm)} genes move the accuracy | {card}")
    if not (np.isfinite(abl).all() and np.isfinite(perm).all()):
        raise RuntimeError("ablation or permutation importance not finite")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save_batch(batch, path: str) -> None:
    import numpy as np

    np.savez(path, **{k: getattr(batch, k) for k in (
        "x_path10", "x_path20", "x_omic", "x_omic_tumor", "x_omic_immune",
        "label")})


def _load_batch(path: str):
    import numpy as np

    from disentangled_multimodal_learning_tpu_torch.data.contract import Batch

    z = np.load(path)
    return Batch(**{k: z[k] for k in z.files})


def _run_ranks(spec: dict, tmp: str, env: dict | None = None,
               timeout: float = 600) -> list:
    """``chip_smoke.py --rank`` for each rank of ``spec`` (its output
    printed, indented); returns the ranks' results."""
    path = os.path.join(tmp, f"{spec['phase']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", path, str(r)],
        env={**os.environ, **(env or {}), "DMLT_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(spec["world"])]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print("\n".join(f"  [rank {r}] {line}" for line in log.splitlines()
                        if line.startswith("[")))
        if p.returncode != 0:
            raise RuntimeError(f"{spec['phase']}: rank {r} failed:\n"
                               + log[-4000:])
    import torch

    return [torch.load(os.path.join(tmp, f"{spec['phase']}.rank{r}.pt"))
            for r in range(spec["world"])]


def _step_outputs(cfg, weights, batch, dev, layout=None) -> dict:
    """One train step of ``cfg`` from the state_dicts ``weights`` (the
    model's, and distillation's teacher's) on ``batch``: its metrics, every
    gradient (float64, CPU), the launches of the step, and the updated
    model's eval logits of the batch (``{}`` where ``layout`` makes this a
    rank other than 0)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        model_inputs)
    from disentangled_multimodal_learning_tpu_torch.train.optim import (
        make_optimizer, make_scheduler)
    from disentangled_multimodal_learning_tpu_torch.train.steps import (
        batch_to_tensors)
    from disentangled_multimodal_learning_tpu_torch.train.trainers import (
        make_step)

    model, teacher = define_net(cfg, dev), None
    if cfg.mode == "distillation":
        model, teacher = model
        teacher.load_state_dict(weights["teacher"])
    model.load_state_dict(weights["model"])
    opt = make_optimizer(cfg, model.parameters())
    step, _ = make_step(cfg, model, opt, make_scheduler(cfg, opt, 1),
                        teacher, layout)
    tensors = batch_to_tensors(batch, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    reset_counts()
    metrics = step(tensors)
    sync()
    n = counts()
    logits = {}
    if layout is None or layout.rank == 0:
        model.eval()
        with torch.inference_mode():
            out = model(**model_inputs(batch, dev, "student"
                                       if cfg.mode == "distillation"
                                       else cfg.mode))
        logits = out[2] if isinstance(out[2], dict) else {"logits": out[1]}
        logits = {k: v.float().cpu() for k, v in logits.items()}
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()},
            "params": {k: v.cpu() for k, v in model.state_dict().items()},
            "launches": n, "logits": logits}


def parallel_worker(spec_path: str, rank: int) -> int:
    """A rank of phase 3m (the training entry in a group of one rank under
    NCCL, then a preset step in such a group against the plain step) or of
    phase 5m (two gloo ranks on the one card, each layout's step from the
    spec's weights on its batch)."""
    import torch
    import torch.distributed as dist

    from disentangled_multimodal_learning_tpu_torch import main as train_main
    from disentangled_multimodal_learning_tpu_torch.config import Config
    from disentangled_multimodal_learning_tpu_torch.parallel import mesh

    with open(spec_path) as f:
        spec = json.load(f)
    tmp = os.path.dirname(spec_path)
    batch = _load_batch(spec["batch"])
    dev = torch.device(spec["device"], 0)
    out = {}
    if spec["phase"] == "3m":
        cfg = Config(**spec["cfg"])
        # the training entry: it joins the DMLT_* group (NCCL on the card)
        # and leaves it
        reset_counts()
        results = train_main.main(cfg.replace(deterministic_training=False),
                                  device=dev)
        out["entry"] = {"launches": counts(),
                        "losses": results[0]["train_losses"]}
        weights = {"model": torch.load(spec["weights"]["model"])}
        out["plain"] = [_step_outputs(cfg, weights, batch, dev)
                        for _ in range(3)]
        os.environ["DMLT_COORDINATOR"] = spec["second_coordinator"]
        dev = mesh.init_process_group(1, dev)
        layout = mesh.choose_layout(cfg)
        out["group"] = _step_outputs(cfg, weights, batch, dev, layout)
        out["backend"] = dist.get_backend()
        mesh.leave_process_group()
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method="file://" + spec["store"],
                                rank=rank, world_size=spec["world"])
        for name, cfg_dict in spec["cases"].items():
            cfg = Config(**cfg_dict)
            weights = {k: torch.load(v)
                       for k, v in spec["weights"][name].items()}
            layout = mesh.choose_layout(cfg, has_teacher="teacher" in weights)
            out[name] = _step_outputs(cfg, weights, batch, dev, layout)
            out[name]["layout"] = (layout.kind, layout.dp, layout.inner)
            print(f"[5m] {name}: {layout.kind} layout, data {layout.dp} x "
                  f"{layout.inner}; rank {rank} launches "
                  f"{ {k: v for k, v in out[name]['launches'].items() if v} }")
            torch.cuda.empty_cache()
        mesh.leave_process_group()
    torch.save(out, os.path.join(tmp, f"{spec['phase']}.rank{rank}.pt"))
    return 0


def _grad_errors(got: dict, want: dict, layout_1d: bool = False) -> tuple:
    """``(rel-L2 per gradient, whether the zero-gradient biases are below
    their floor)`` as ``compare_train_step`` holds them."""
    errs, ok = {}, True
    for name, w in want.items():
        g = got[name]
        if name.endswith(ZERO_GRAD_BIASES):
            floor = (ZERO_GRAD_FLOOR_1D if ".attn1d." in name or layout_1d
                     or name.endswith(POOLING_BIASES) else ZERO_GRAD_FLOOR)
            scale = want[name[:-4] + "weight"].abs().max().item()
            ok &= max(g.abs().max().item(), w.abs().max().item()) <= (
                floor * scale)
            continue
        errs[name] = ((g - w).norm() / max(w.norm().item(), 1e-30)).item()
    return errs, ok


def check_group_of_one(train_preset, batch, dev, tmp: str, card: str) -> None:
    """Phase 3m: the training entry at the preset in a process group of
    one rank under NCCL (a subprocess with the ``DMLT_*`` rendezvous; 3
    steps and an eval batch, K1-fwd 4 and K1-bwd 4 a step, the eval K1-fwd
    4); then in that subprocess one ``deterministic_training`` preset step
    in a group of one rank (its only collective the gradient's all-reduce)
    against the same step without a group, run three times: the metrics
    (the forward) bitwise; the gradients and parameters bitwise, or, since
    the plain step does not repeat bitwise on the card (``F.grid_sample``'s
    backward adds with atomics), the group's step within
    ``REPEAT_FACTOR`` times the plain runs' largest spread of each other
    (from its closest plain run; the spread is a few ulps of the largest
    gradient entries and varies from run to run, hence the factor)."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)

    cfg = train_preset.replace(deterministic_training=True)
    weights = os.path.join(tmp, "3m.model.pt")
    torch.save(define_net(cfg, "cpu").state_dict(), weights)
    _save_batch(batch, os.path.join(tmp, "3m.batch.npz"))
    spec = {"phase": "3m", "world": 1, "device": torch.device(dev).type,
            "cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
            "weights": {"model": weights},
            "batch": os.path.join(tmp, "3m.batch.npz"),
            "second_coordinator": f"127.0.0.1:{_free_port()}"}
    t0 = time.perf_counter()
    (res,) = _run_ranks(spec, tmp, env={
        "DMLT_COORDINATOR": f"127.0.0.1:{_free_port()}",
        "DMLT_NUM_PROCESSES": "1"})
    wall = time.perf_counter() - t0
    steps = train_preset.synthetic_train_size // train_preset.batch_size
    want = _sum_counts(steps, dict(k1_fwd=4, k1_bwd=4), 1, dict(k1_fwd=4))
    n = res["entry"]["launches"]
    print(f"[3m] training entry in a group of one rank ({res['backend']}): "
          f"{steps} steps, losses {res['entry']['losses']}, launches {n} "
          f"(the subprocess's whole phase {wall:.1f} s) | {card}")
    if n != want or not all(map(math.isfinite, res["entry"]["losses"])):
        raise RuntimeError(f"3m: launches {n}, want {want}")
    plain, b = res["plain"], res["group"]
    if b["launches"] != expect(k1_fwd=4, k1_bwd=4) or any(
            b["metrics"] != a["metrics"] for a in plain):
        raise RuntimeError(f"3m: the group's step {b['metrics']} "
                           f"{b['launches']} vs the plain "
                           f"{[a['metrics'] for a in plain]}")

    def diff(x, y):
        return max((x["grads"][k] - y["grads"][k]).abs().max().item()
                   for k in x["grads"])

    spread = max(diff(x, y) for i, x in enumerate(plain)
                 for y in plain[i + 1:])
    d_group = min(diff(b, a) for a in plain)
    bitwise = d_group == 0 and any(
        all(torch.equal(b["params"][k], v) for k, v in a["params"].items())
        for a in plain)
    print(f"[3m] one deterministic_training preset step in the group vs "
          f"without (3 runs): metrics bitwise equal {b['metrics']}; "
          f"gradients and parameters bitwise equal to a plain run: "
          f"{bitwise} (the group's step to its closest plain run "
          f"{d_group:.3e}, the plain runs' largest spread {spread:.3e}, tol "
          f"{REPEAT_FACTOR} x the spread) | {card}")
    if not (bitwise or d_group <= REPEAT_FACTOR * spread):
        raise RuntimeError("3m: the step in a group of one rank differs "
                           "from the step without a group")


# phase 5m: each layout as changes to phase 5's f32 preset (two gloo ranks
# on the one card), and each rank's launches in its step (pipe: stage 0 the
# teacher's forward of 2 microbatches, stage 1 the student's)
PARALLEL_LAYOUTS = {
    "dp": (dict(), dict(k1_fwd=4, k1_bwd=4)),
    "seq": (dict(mode="transmil", seq_shard_devices=2), dict()),
    "tp": (dict(tp_devices=2), dict(k1_fwd=4, k1_bwd=4)),
    "tp_divisor0": (dict(tp_devices=2, cpb_table_divisor=0),
                    dict(k2_fwd=4, k2_bwd=4)),
    "branch": (dict(mode="multiscale", branch_devices=2),
               dict(k1_fwd=3, k1_bwd=3, k3_knn=1, k3_parent=1)),
    "pipe": (dict(mode="distillation", pipe_devices=2, pipe_microbatches=2,
                  distill_teacher_cache=False),
             (dict(k1_fwd=8), dict(k1_fwd=4, k1_bwd=4, k3_knn=4,
                                   k3_parent=4))),
}


def check_parallel_layouts(f32, batch, dev, tmp: str, card: str) -> None:
    """Phase 5m: two ranks on the one card under gloo (the kernels built
    before, so neither rebuilds them), the preset's batch of 4 bags in f32
    under ``deterministic_training``: data parallelism on the teacher,
    TransMIL's token axis over 2 ranks (2,501 tokens padded to 2,560, 256
    landmarks: 1,280 tokens, 128 whole segments a rank), tensor parallelism
    on the teacher at divisor 1 and 0 (4 heads a rank), the scale branches
    on multiscale, and distillation as a pipeline of 2 microbatches.  Each
    step against the single-process step on the card from the same weights
    (``compare_train_step``'s tolerances on the losses and the gradients,
    the updated model's eval logits within ``LOGITS_TOL``), every rank's
    launches exact; the ranks' parameters bitwise equal.  No time is
    printed: two ranks sharing one card measure no scaling."""
    import torch

    from disentangled_multimodal_learning_tpu_torch.models.factory import (
        define_net)

    base = f32.replace(deterministic_training=True, nodes=2)
    spec = {"phase": "5m", "world": 2, "store": os.path.join(tmp, "store"),
            "device": torch.device(dev).type,
            "batch": os.path.join(tmp, "5m.batch.npz"), "cases": {},
            "weights": {}}
    _save_batch(batch, spec["batch"])
    for name, (changes, _) in PARALLEL_LAYOUTS.items():
        cfg = base.replace(**changes)
        spec["cases"][name] = {f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__}
        nets = define_net(cfg, "cpu")
        nets = dict(zip(("model", "teacher"), nets if isinstance(nets, tuple)
                        else (nets,)))
        spec["weights"][name] = {}
        for role, net in nets.items():
            path = os.path.join(tmp, f"5m.{name}.{role}.pt")
            torch.save(net.state_dict(), path)
            spec["weights"][name][role] = path
    t0 = time.perf_counter()
    ranks = _run_ranks(spec, tmp)
    wall = time.perf_counter() - t0
    for name, (changes, per_rank) in PARALLEL_LAYOUTS.items():
        cfg = base.replace(**changes)
        weights = {k: torch.load(v) for k, v in spec["weights"][name].items()}
        want = _step_outputs(cfg, weights, batch, dev)
        got = [r[name] for r in ranks]
        wants = per_rank if isinstance(per_rank, tuple) else (per_rank,) * 2
        launches = [g["launches"] for g in got]
        skip = ("batchloss",) if name == "pipe" else ()
        metrics = {k: v for k, v in want["metrics"].items() if k not in skip}
        task = "taskloss"
        loss_err = abs(got[0]["metrics"]["loss"] - metrics["loss"]) / abs(
            metrics["loss"])
        task_err = abs(got[0]["metrics"][task] - metrics[task]) / abs(
            metrics[task])
        errs, bias_ok = _grad_errors(got[0]["grads"], want["grads"])
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:2]
        logit_err = max((got[0]["logits"][k] - v).abs().max().item()
                        for k, v in want["logits"].items())
        same = all(torch.equal(got[1]["params"][k], v)
                   for k, v in got[0]["params"].items())
        print(f"[5m] {name} ({got[0]['layout'][0]} layout, 2 gloo ranks on "
              f"one card): task loss rel {task_err:.2e} (tol "
              f"{TASK_LOSS_TOL}), loss rel {loss_err:.2e} (tol "
              f"{STEP_LOSS_TOL}), {len(errs)} gradients, worst rel-L2 "
              f"{worst} (tol {GRAD_TOL}), zero-gradient biases below their "
              f"floor: {bias_ok}; updated model's logits max_abs_err "
              f"{logit_err:.3e} (tol {LOGITS_TOL}); ranks' parameters "
              f"bitwise equal: {same}; launches per rank "
              f"{[{k: v for k, v in n.items() if v} for n in launches]} | "
              f"{card}")
        if (set(got[0]["metrics"]) != set(metrics)
                or not task_err <= TASK_LOSS_TOL
                or not loss_err <= STEP_LOSS_TOL or not bias_ok
                or not all(e <= GRAD_TOL for e in errs.values())
                or not logit_err <= LOGITS_TOL or not same
                or launches != [expect(**w) for w in wants]):
            raise RuntimeError(f"5m: the {name} layout's step disagrees with "
                               "the single-process step")
    print(f"[5m] six layouts' steps on 2 ranks in {wall:.1f} s (the ranks' "
          f"start, set-up and first calls included; no speed figure) | "
          f"{card}")


def profile(label: str, fn, n: int = 5, rows: int = 30) -> tuple:
    """torch.profiler over ``n`` calls of ``fn`` after 3 warm-up calls:
    the kernel table (``rows`` rows) and the device's busy and idle share;
    returns ``(busy ms, wall ms)`` per call."""
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
    print(avg.table(sort_by="self_device_time_total", row_limit=rows))
    # device rows only (the op rows repeat their kernels' time)
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / n
    print(f"[profile] per {label} (profiler on): device busy {busy:.3f} ms "
          f"of {wall:.3f} ms wall = {busy / wall:.1%} busy, "
          f"{1 - busy / wall:.1%} idle")
    return busy, wall


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # a rank of phase 3m or 5m
        sys.exit(parallel_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())

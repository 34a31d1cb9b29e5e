#!/usr/bin/env python3
"""Kernels of the PyTorch port against an earlier version of their
sources, on one NVIDIA GPU: the exact-CPB kernels K2 (``--kernel k2``, the
default), the fused table attention K6 with K7-bwd (``--kernel k6``), the
table CPB's backward K1-bwd and K5-bwd (``--kernel table``), the streamed
DPC-KNN passes K3-knn and K3-parent (``--kernel k3``), the 1-D table CPB's
backward K4-bwd (``--kernel k4``), the divisor-1 table CPB's forward
K1-fwd (``--kernel k1``), the table CPB's forward at divisor >= 2 K5-fwd
(``--kernel k5``), or the fused exact-CPB attention's forward K7-fwd
(``--kernel k7``).

    mkdir -p build/k2_parent && git archive <commit> \\
        disentangled_multimodal_learning_tpu_torch/csrc | tar -x -C build/k2_parent
    python3 tools/torch_k2_compare.py --parent build/k2_parent \\
        [--kernel k6 | --kernel table [--groups 32 64]
         | --kernel k3 [--blocks 200 528] | --kernel k4 [--groups 53 209]
         | --kernel k1 | --kernel k5 | --kernel k7]

``--parent`` is a directory holding an earlier
``disentangled_multimodal_learning_tpu_torch/csrc`` (``build/`` is ignored
by git).  The script builds the port's kernels as the package does and the
earlier sources of the chosen kernels into a library of their own, all
under ``build/k2_compare/``.  It prints the card's name and power limit
first and the ptxas lines of every build.  It checks no result against a
plain version: that is ``chip_smoke.py``'s job.

``k2``: the earlier ``cpb_exact.cu`` and ``cpb_exact_bwd.cu``, and, for
both versions of K2-bwd, two copies patched at compile time: one without
the weight-gradient sums, one with only them (the other phases skipped).
Then, at the teacher's shape (32 x 144 x 2500, O = 1) and the 1-D
attention's (16 x 625 x 2501, O = 2), on the inputs ``chip_smoke.py``
builds for its phases 2 and 2f:

- whether the two K2-fwd give bitwise-equal biases, in both layouts;
- K2-fwd and K2-bwd of both versions, in both layouts, timed with CUDA
  events in the order earlier, current, current, earlier;
- the split of both K2-bwd: whole, without the weight-gradient sums, only
  them;

and, per K2 kernel of the current library, its FFMA count beside its
spill stores (and the stack slots they write) and spill loads in the SASS.

``table``: the earlier and the current ``cpb_table_bwd.cu`` and
``cpb_table_strided_bwd.cu`` (with their headers), each design (the
partial tables per block, or the table tiles of ``table_bwd_tiles.cuh``)
with its compile-time phase splits (``PARTIALS_SPLIT``, ``TILES_SPLIT``:
each skips one phase, or changes the rows a warp has in flight).  Then, by
raw C calls on the inputs of ``chip_smoke.py`` (phase 2b's K1-bwd case,
phase 2e's at divisors 1 with a bf16 cotangent, 2 and 4, and phase 2e's
K6 taps with a stand-in ``ds``): each version's errors against float64
(dtable, dfracs, and dfy and dfx apart) and whether it is bitwise equal
over two calls, the earlier K1-bwd with d/dfx as a blend of table
differences, both versions timed with CUDA events (earlier, current,
current, earlier), each split twice, and the current design at the row
group counts of ``--groups``; and each build's ptxas lines.

``k6``: the earlier ``fused_table.cu``, ``fused_table_bwd.cu`` and
``fused_exact_bwd.cu`` (with the earlier headers), and a copy of the
current K6 sources per entry of ``K6_SPLIT``, patched at compile time to
skip one phase (or two of the three TF32 passes).  Then, on the inputs
of ``chip_smoke.py``'s phase 2e (BH 32, K 144, N 2500, D 64) at dropout 0
and 0.1, each timed with CUDA events in the order earlier, current,
current, earlier: K6-fwd, K6-bwd whole, K6-bwd's attention part alone,
the K1-bwd scatter of its ``ds`` alone (one build: K1-bwd did not
change), and K7-bwd in "nk" (its attention part and K2-bwd's kernels on
its ``ds``); then each patched copy twice; whether the earlier and
current K6 agree (max abs difference); and, per K6 kernel of both
libraries, its HMMA count beside its FFMA count and spills in the SASS.

``k3``: the earlier and the current ``dpc_knn.cu``, each with its
compile-time phase splits (``K3_STREAM_SPLIT`` for the earlier design, a
block per token tile, ``K3_SPLITS_SPLIT`` for the design whose blocks
split the neighbour axis): without the selection epilogue, the loads
alone, without loading the neighbour tiles, and for the split design
without the finishing kernel, with fewer operand loads, and variants of
its ring.  Then, by raw C calls on the inputs of
``chip_smoke.py``'s phase 2c (B=4, N=2500, C=128, k=5, LayerNormed
tokens, seed 2): each version against the plain version (max abs) and
whether two calls are bitwise equal, both timed with CUDA events
(earlier, current, current, earlier), each split twice, the split design
at the block counts of ``--blocks``, and f32 ``torch.bmm(x, x^T)`` with
TF32 off as a yardstick for the dots alone (not the function); and each
build's ptxas lines and its HMMA and FFMA counts in the SASS.

``k4``: the earlier and the current ``cpb_table_1d_bwd.cu``, each with its
compile-time phase splits (``K4_PARTIALS_SPLIT`` for the design with a
partial table per block: without the shift sums, without the partial
tables, the loads alone with and without the barrier between rows;
``K4_TILES_SPLIT`` for the tile design: without the shift sums, without
the finishing kernel, without reading the cotangent, without the rows,
and variants of its rows in flight, strips and warps).  Then, by raw C
calls on ``chip_smoke.py``'s phase-2d inputs (R = 10,000, O = 2, n_q =
2501): each version's errors against float64 and whether two calls are
bitwise equal, both timed with CUDA events (earlier, current, current,
earlier), each split twice, the current design at the row-group counts of
``--groups``; and each build's ptxas lines.

``k1``: the earlier and the current ``cpb_table.cu``, each with its
compile-time splits (``K1_ROWS_SPLIT`` for the block-per-row design:
stores alone with scalar and with vector stores, no window staging;
``K1_WAVE_SPLIT`` for the one-wave design: stores alone, scalar stores,
the table through L1, the blends alone, and variants of block size).  Then, with the f32 and the bf16 store, by raw C calls on
``chip_smoke.py``'s phase-2e divisor-1 inputs (R = 4608, side 50): each
version bitwise against the plain version, both timed (earlier, current,
current, earlier), each split twice; each build's ptxas lines and the
current build's SASS op counts.  Times are taken with the calls queued
behind a spin of the card (``chip_smoke.py hold_queue``), so they are the
card's and not the host's.

``k5``: the earlier and the current ``cpb_table_strided.cu``, each with its
compile-time splits (``K5_ROWS_SPLIT`` for the block-per-row design on the
table as it is: stores alone with scalar and with vector stores, the taps
alone, the taps at unit stride; ``K5_PAIRS_SPLIT`` for the design on
x-phase pair planes: stores alone, the taps alone, without or only its
first kernel, variants of block size, unrolling and source).  Then, with
the f32 and the bf16 store, by raw C calls on ``chip_smoke.py``'s
phase-2e inputs at divisors 2 and 4 (R = 4608, side 50, clipped rows):
each version bitwise against the plain version, both timed (earlier,
current, current, earlier, queued behind a spin), each split twice; each
build's ptxas lines and SASS op counts.

``k7``: the earlier and the current ``fused_exact.cu`` (with the headers
of each), each with its compile-time splits (``K7_FMA_SPLIT`` for the
design with f32 FMA products and a point a thread in the bias, each phase
alone; ``K7_MMA_SPLIT`` for the design with 3xTF32 products and the
four-point bias: each phase dropped, the bias alone, one TF32 pass, and
variants).  Then, by raw C calls on inputs of ``chip_smoke.py``'s
phase-2f shapes (the teacher's 32 x 2500 x 144, D 64, at rate 0 and 0.1;
the 1-D attention's 16 x 2501 x 625, D 16, in kv chunks, at rate 0.1), in
both layouts: the current version's out and map against the earlier
one's (max abs), "nk" against "kn" transposed and two calls (bitwise),
both timed (earlier, current, current, earlier, queued behind a spin),
each split twice at the teacher's shape; each build's ptxas lines, HMMA
/ FFMA counts and an opcode histogram.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k2_compare"
SUB = Path("disentangled_multimodal_learning_tpu_torch") / "csrc"
P, I = ctypes.c_void_p, ctypes.c_int
FWD_ARGS = [P] * 9 + [I] * 5 + [P]
BWD_ARGS = [P] * 11 + [I] * 6 + [P]
# compile-time patches (SPLIT 1: no weight-gradient sums, SPLIT 2: only
# them) of the earlier, point-per-thread K2-bwd ...
EARLIER_SPLIT = [
    ("      if (n < N) {\n        const float px",
     "      if (SPLIT != 2 && n < N) {\n        const float px"),
    ("      const int np = min(kThreads, N - n0);",
     "      const int np = (SPLIT == 1) ? 0 : min(kThreads, N - n0);")]
# ... and of the tiled one
CURRENT_SPLIT = [
    ("      {\n        float z[4][8];",
     "      if (SPLIT != 2) {\n        float z[4][8];"),
    ("      {\n        float d1[4][8];",
     "      if (SPLIT != 2) {\n        float d1[4][8];"),
    ("      if (live) {\n        px = grid_q",
     "      if (SPLIT != 2 && live) {\n        px = grid_q"),
    ("      if (live) {\n        float dfx",
     "      if (SPLIT != 2 && live) {\n        float dfx"),
    ("const int p1 = min(N - n0", "const int p1 = SPLIT == 1 ? 0 : min(N - n0")]
 
# compile-time patches of the current K6 kernels (SPLIT k): each skips one
# phase, for the time it takes (5 runs one TF32 pass instead of three);
# the results are wrong, only the times count
K6_SPLIT = {
    1: ("K6-fwd without the bias", [
        ("        if (in0) {\n          acc[i][2 * h] = __fadd_rn(",
         "        if (SPLIT != 1 && in0) {\n          acc[i][2 * h] = __fadd_rn("),
        ("        if (in1) {\n          acc[i][2 * h + 1] = __fadd_rn(",
         "        if (SPLIT != 1 && in1) {\n          acc[i][2 * h + 1] = "
         "__fadd_rn(")]),
    2: ("K6-fwd without the sim products", [
        ("          mma_3xtf32(acc[i], accs[i], a, b);",
         "          if (SPLIT != 2) mma_3xtf32(acc[i], accs[i], a, b);")]),
    3: ("K6-fwd without PV", [
        ("        mma_3xtf32(big, small, a, b);\n      };",
         "        if (SPLIT != 3) mma_3xtf32(big, small, a, b);\n      };")]),
    4: ("K6-fwd without the attn store", [
        ("          if (even && n < N) {\n            *reinterpret_cast<float2*>"
         "(attn",
         "          if (SPLIT == 4) {\n          } else if (even && n < N) {\n"
         "            *reinterpret_cast<float2*>(attn")]),
    5: ("one TF32 pass", [
        ("  mma_tf32(small, a.lo, b.hi);\n  mma_tf32(small, a.hi, b.lo);",
         "  if (SPLIT != 5) {\n  mma_tf32(small, a.lo, b.hi);\n  "
         "mma_tf32(small, a.hi, b.lo);\n  }")]),
    6: ("the attention backward without the dp products", [
        ("        if (mt < nmt) {\n          const float* vr",
         "        if (SPLIT != 6 && mt < nmt) {\n          const float* vr")]),
    7: ("the attention backward without dv and dk", [
        ("    for (int n8 = 0; n8 < kBTQ; n8 += 8) {",
         "    for (int n8 = 0; SPLIT != 7 && n8 < kBTQ; n8 += 8) {")]),
    8: ("the attention backward without dq", [
        ("          mma_3xtf32(o[j], os[j], a, b);\n        }\n      }\n"
         "      float* po = s_dqp",
         "          if (SPLIT != 8) mma_3xtf32(o[j], os[j], a, b);\n        }\n"
         "      }\n      float* po = s_dqp")]),
    9: ("the attention backward without loading the map", [
        ("        p[i][e] = in ? attn[idx] : 0.0f;",
         "        p[i][e] = (in && SPLIT != 9) ? attn[idx] : 0.0f;")]),
    10: ("the attention backward without loading the map's cotangent", [
        ("          if (gattn != nullptr) {\n            dp = gattn[",
         "          if (SPLIT != 10 && gattn != nullptr) {\n            dp = "
         "gattn[")]),
    11: ("the attention backward without storing ds", [
        ("          if (even && n < N) {\n            *reinterpret_cast<float2*>"
         "(ds + idx)",
         "          if (SPLIT == 11) {\n          } else if (even && n < N) {\n"
         "            *reinterpret_cast<float2*>(ds + idx)")]),
}


def nvcc_build(name: str, csrc: Path, sources, patches=(), defines=()):
    """Compile ``sources`` of ``csrc`` (patched) into one library."""
    from disentangled_multimodal_learning_tpu_torch.ops import build

    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    texts = {f.name: f.read_text() for f in [*csrc.glob("*.cuh"),
                                             *(csrc / s for s in sources)]}
    for a, b in patches:
        if not any(a in text for text in texts.values()):
            raise RuntimeError(f"{name}: no source holds the patch point "
                               f"{a.strip()!r}")
        texts = {f: text.replace(a, b) for f, text in texts.items()}
    for f, text in texts.items():
        (work / f).write_text(text)
    objs, log = [], []
    for src in sources:
        obj = work / f"{src}.o"
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-c",
                            "-o", str(obj), str(work / src)],
                           capture_output=True, text=True)
        log.append(r.stdout + r.stderr)
        if r.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-1]}")
        objs.append(str(obj))
    lib = work / "lib.so"
    subprocess.run([build._nvcc(), "-shared", "-o", str(lib), *objs],
                   check=True)
    return name, "".join(log)


def ptxas_lines(log: str):
    for line in log.splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            yield line.strip()


def sass_spills(lib: Path):
    """Per K2 kernel in ``lib``: its FFMA count, and its spill stores and
    loads with the stack slots they touch (from ``cuobjdump -sass``)."""
    import re

    from disentangled_multimodal_learning_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    name, found = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "cpb_exact" in m.group(1) else None
            if name:
                found[name] = {"FFMA": 0, "STL": [], "LDL": []}
        elif name:
            op = re.search(r"\b(FFMA|STL|LDL)\S*\s+(.*?);", line)
            if op and op.group(1) == "FFMA":
                found[name]["FFMA"] += 1
            elif op:
                slot = re.search(r"\[R1(\+0x[0-9a-f]+)?\]", op.group(2))
                found[name][op.group(1)].append(slot.group(0) if slot else "?")
    for name, f in found.items():
        short = re.search(r"(cpb_exact_(?:fwd|bwd_partial)_kernel(?:I\w*?EE)?"
                          r"|sum_partials_kernel)", name)
        short = short.group(1) if short else name
        print(f"  {short}: {f['FFMA']} FFMA, {len(f['STL'])} spill stores to "
              f"{len(set(f['STL']))} stack slots, {len(f['LDL'])} spill loads")


def sass_ops(lib: Path, key: str, ops=("LDS", "LD", "LDG", "STG", "STS",
                                        "FMUL", "FADD", "FFMA", "SHFL",
                                        "BAR", "LDGSTS")):
    """Per instance of the kernels whose names hold ``key`` in ``lib``: the
    count of each of ``ops`` in its SASS (from ``cuobjdump -sass``)."""
    import re

    from disentangled_multimodal_learning_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    found = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            found.append([m.group(1) if key in m.group(1) else None,
                          dict.fromkeys(ops, 0)])
        elif found and found[-1][0]:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if op and op.group(1) in found[-1][1]:
                found[-1][1][op.group(1)] += 1
    return [f"{name[-60:]}: " + ", ".join(f"{n} {op}" for op, n in c.items())
            for name, c in found if name]


def sass_histogram(lib: Path, key: str, top: int = 24):
    """Per instance of the kernels whose names hold ``key`` in ``lib``: its
    instruction count and its ``top`` most frequent opcodes (from
    ``cuobjdump -sass``)."""
    import re
    from collections import Counter

    from disentangled_multimodal_learning_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    found = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            found.append([m.group(1) if key in m.group(1) else None,
                          Counter()])
        elif found and found[-1][0]:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", line)
            if op:
                found[-1][1][op.group(1)] += 1
    return [f"{name[-40:]}: {sum(c.values())} instructions; " + ", ".join(
        f"{op} {n}" for op, n in c.most_common(top))
        for name, c in found if name]


def load(name: str):
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    if hasattr(lib, "dmlt_cpb_exact_fwd"):
        lib.dmlt_cpb_exact_fwd.argtypes = FWD_ARGS
    lib.dmlt_cpb_exact_bwd.argtypes = BWD_ARGS
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--kernel", choices=("k2", "k6", "table", "k3", "k4",
                                         "k1", "k5", "k7"), default="k2")
    ap.add_argument("--groups", type=int, nargs="*", default=(),
                    help="table and k4: also time the current design at "
                    "these row-group counts")
    ap.add_argument("--blocks", type=int, nargs="*", default=(),
                    help="k3: also time the current design at these "
                    "block counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_compare: no CUDA device", file=sys.stderr)
        return 2
    parent = args.parent.resolve() / SUB
    print(cs.card_line())
    t0 = time.perf_counter()
    build.kernels()
    print(f"the port's build: {time.perf_counter() - t0:.1f} s")
    if args.kernel == "table":
        return compare_table(parent, args.groups)
    if args.kernel == "k3":
        return compare_k3(parent, args.blocks)
    if args.kernel == "k4":
        return compare_k4(parent, args.groups)
    if args.kernel == "k1":
        return compare_k1(parent)
    if args.kernel == "k5":
        return compare_k5(parent)
    if args.kernel == "k7":
        return compare_k7(parent)
    return (compare_k6 if args.kernel == "k6" else compare_k2)(parent)


def compare_k2(parent: Path) -> int:
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import build, cpb

    current = ROOT / SUB
    print("current:\n  " + "\n  ".join(
        ln for ln in ptxas_lines(build.build_log()) if "cpb_exact" in ln
        or "spill" in ln or "Used" in ln))
    jobs = [("earlier", parent, ("cpb_exact.cu", "cpb_exact_bwd.cu"), (), ())]
    jobs += [(f"earlier_split{k}", parent, ("cpb_exact_bwd.cu",),
              EARLIER_SPLIT, (f"-DSPLIT={k}",)) for k in (1, 2)]
    jobs += [(f"current_split{k}", current, ("cpb_exact_bwd.cu",),
              CURRENT_SPLIT, (f"-DSPLIT={k}",)) for k in (1, 2)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        print(f"{name}:\n  " + "\n  ".join(ptxas_lines(log)))
    print("spills in the SASS of the current library:")
    sass_spills(build.library_dir() / build.LIB_NAME)
    libs = {name: load(name) for name, _ in built}

    dev = torch.device("cuda")
    g0 = torch.Generator().manual_seed(0)  # chip_smoke.py phase 2
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    w_2d = cs.mlp_weights(1, g0, dev)
    torch.rand(32, 144, 2, generator=g0)
    gkv_2d = ((torch.rand(32, 144, 2, generator=g0) * 2 - 1)
              * kv_bound).to(dev)
    g8 = torch.Generator().manual_seed(8)  # chip_smoke.py phase 2f
    w_1d = list(cs.mlp_weights(2, g8, dev))
    w_1d[0][1].zero_()
    torch.rand(32, 144, 2, generator=g8)
    cs.mlp_weights(1, g8, dev)
    n_q = 2501
    gq_1d = torch.stack([torch.linspace(-1, 1, n_q, device=dev),
                         torch.zeros(n_q, device=dev)], dim=-1)
    gkv_1d = torch.stack([(torch.rand(16, 625, generator=g8) * 2 - 1)
                          .to(dev), torch.zeros(16, 625, device=dev)], dim=-1)
    cases = {"32x144x2500 O=1": (cs.normalized_grid_flat(50, dev), gkv_2d,
                                 w_2d),
             "16x625x2501 O=2": (gq_1d, gkv_1d, w_1d)}
    gen = torch.Generator().manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (gq, gkv, w) in cases.items():
        BH, K, N, O = gkv.shape[0], gkv.shape[1], gq.shape[0], w[4].shape[1]
        rows = BH * K
        for nk in (False, True):
            shape = cpb._exact_shape(BH, K, N, O, nk)
            with torch.inference_mode():
                new = (cpb.cpb_bias_nk if nk else cpb.cpb_bias_transposed)(
                    gq, gkv, *w)
            old = torch.empty_like(new)

            def old_fwd():
                return libs["earlier"].dmlt_cpb_exact_fwd(
                    *(t.data_ptr() for t in (gq, gkv, *w, old)), rows, K, N,
                    O, int(nk), stream)

            assert old_fwd() == 0
            torch.cuda.synchronize()
            same = torch.equal(new, old)
            new_fwd = (cpb.cpb_bias_nk if nk else cpb.cpb_bias_transposed)
            with torch.inference_mode():
                t_fwd = [cs.cuda_ms(old_fwd, 10),
                         cs.cuda_ms(lambda: new_fwd(gq, gkv, *w), 10),
                         cs.cuda_ms(lambda: new_fwd(gq, gkv, *w), 10),
                         cs.cuda_ms(old_fwd, 10)]
            del new, old
            dbias = torch.randn(shape, generator=gen).to(dev)
            n_params = cpb.HID * (cpb.HID + 4) + (cpb.HID + 1) * O
            dg = torch.empty(rows, 2, device=dev)
            grads = torch.empty(n_params, device=dev)

            def raw_bwd(name, nparts):
                part = torch.empty(nparts, n_params, device=dev)
                return lambda: libs[name].dmlt_cpb_exact_bwd(
                    *(t.data_ptr() for t in (gq, gkv, *w[:5], dbias, dg,
                                             grads, part)),
                    rows, K, N, O, nparts, int(nk), stream)

            old_parts = min(rows, 256)  # the earlier EXACT_BWD_PARTS
            new_parts = cpb.exact_bwd_parts(rows)
            new_bwd = (cpb.cpb_bias_nk_backward if nk
                       else cpb.cpb_bias_transposed_backward)
            t_bwd = [cs.cuda_ms(raw_bwd("earlier", old_parts), 5),
                     cs.cuda_ms(lambda: new_bwd(gq, gkv, *w, dbias), 5),
                     cs.cuda_ms(lambda: new_bwd(gq, gkv, *w, dbias), 5),
                     cs.cuda_ms(raw_bwd("earlier", old_parts), 5)]
            layout = "nk" if nk else "kn"
            print(f"[{label} {layout}] K2-fwd bitwise equal to the earlier "
                  f"one: {same}; K2-fwd ms earlier {t_fwd[0]:.4f} / "
                  f"{t_fwd[3]:.4f}, current {t_fwd[1]:.4f} / {t_fwd[2]:.4f};"
                  f" K2-bwd ms earlier {t_bwd[0]:.4f} / {t_bwd[3]:.4f}, "
                  f"current {t_bwd[1]:.4f} / {t_bwd[2]:.4f}")
            if not nk:
                split = {}
                for ver, parts in (("earlier", old_parts),
                                   ("current", new_parts)):
                    split[ver] = [cs.cuda_ms(raw_bwd(f"{ver}_split{k}",
                                                     parts), 5)
                                  for k in (1, 2)]
                print(f"[{label} kn] K2-bwd split, ms without the weight-"
                      "gradient sums / with only them: earlier "
                      f"{split['earlier'][0]:.4f} / {split['earlier'][1]:.4f}"
                      f", current {split['current'][0]:.4f} / "
                      f"{split['current'][1]:.4f}")
            del dbias
            torch.cuda.empty_cache()
    return 0



K6_SOURCES = ("fused_table.cu", "fused_table_bwd.cu", "fused_exact_bwd.cu")
K6_ENTRIES = ("dmlt_fused_table_fwd", "dmlt_fused_table_bwd",
              "dmlt_fused_exact_bwd")


# K6's entries take the dropout seed at this argument: a pointer to one
# int64 on the card in the current sources, an int in sources before that
K6_SEED_ARG = 15


def k6_seed_by_pointer(csrc: Path) -> bool:
    """Whether the K6 sources in ``csrc`` read the seed from the card."""
    return "const void* seed" in (csrc / "fused_table.cu").read_text()


def load_k6(name: str, seed_by_pointer: bool):
    from disentangled_multimodal_learning_tpu_torch.ops import build

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for entry in K6_ENTRIES:
        if hasattr(lib, entry):
            argtypes = list(build.SIGNATURES[entry])
            if entry != "dmlt_fused_exact_bwd" and not seed_by_pointer:
                argtypes[K6_SEED_ARG] = ctypes.c_int
            getattr(lib, entry).argtypes = argtypes
    return lib


def compare_k6(parent: Path) -> int:
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import (
        build, cpb, fused_exact, fused_table)

    current = ROOT / SUB
    print("current:\n  " + "\n  ".join(
        cs.kernel_ptxas(build.build_log(), cs.K6_KERNELS)))
    jobs = [("k6_earlier", parent, K6_SOURCES, (), ())]
    jobs += [(f"k6_split{n}", current, ("fused_table.cu", "fused_table_bwd.cu"),
              patches, (f"-DSPLIT={n}",)) for n, (_, patches) in K6_SPLIT.items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        print(f"{name}:\n  " + "\n  ".join(
            cs.kernel_ptxas(log, cs.K6_KERNELS)))
    for name, lib in (("current", build.library_dir() / build.LIB_NAME),
                      ("k6_earlier", OUT / "k6_earlier" / "lib.so")):
        print(f"SASS of {name}:")
        for line in cs.sass_counts(lib, cs.K6_KERNELS):
            print(f"  {line}")
    libs = {name: load_k6(name, name != "k6_earlier"
                          or k6_seed_by_pointer(parent))
            for name, _ in built}
    cur = build.kernels()

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)  # chip_smoke.py phase 2e
    c = cs.fused_case(dev, gen)
    q, k, v, table, side = (c[n] for n in ("q", "k", "v", "table", "side"))
    g_out, g_attn = c["g_out"], c["g_attn"]
    taps, fracs = cpb.table_taps(c["shifts"], side=side, tn=table.shape[0])
    BH, N, D = q.shape
    K = k.shape[1]
    # K7 in "nk" on the same q, k, v and cotangents, with the teacher's grid
    # and a CPB MLP from the same generator
    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    cpb_args = (cs.normalized_grid_flat(side, dev),
                ((torch.rand(BH, K, 2, generator=gen) * 2 - 1)
                 * kv_bound).to(dev), *cs.mlp_weights(1, gen, dev))
    g_attn_nk = g_attn.transpose(1, 2).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    splits = max(1, min(fused_table.BWD_BLOCKS // BH, -(-N // 64)))

    def ptr(*ts):
        return [t.data_ptr() for t in ts]

    def buffers():
        return dict(out=torch.empty_like(q),
                    attn=torch.empty(BH, K, N, device=dev),
                    dq=torch.empty_like(q),
                    dkv=torch.empty(2, BH, K, D, device=dev),
                    ds=torch.empty(BH * K, side, side, device=dev),
                    part=torch.empty(splits, 2, BH, K, D, device=dev))

    dtable, dfracs = torch.empty_like(table), torch.empty_like(fracs)
    seed_t = torch.full((), 99, dtype=torch.int64, device=dev)
    for rate in (0.0, 0.1):
        seed = 99
        thr, scale = fused_table._dropout_args(rate)
        bufs = {"earlier": buffers(), "current": buffers()}
        lib_of = {"earlier": libs["k6_earlier"], "current": cur}
        split_bufs = buffers()
        for n in K6_SPLIT:
            bufs[f"split{n}"] = split_bufs
            lib_of[f"split{n}"] = libs[f"k6_split{n}"]

        def k6_seed(ver):
            by_pointer = ver != "earlier" or k6_seed_by_pointer(parent)
            return seed_t.data_ptr() if by_pointer else seed

        def fwd(ver):
            b, lib = bufs[ver], lib_of[ver]
            return lambda: lib.dmlt_fused_table_fwd(
                *ptr(q, k, v, table), table.shape[0], table.shape[1],
                *ptr(taps, fracs, b["out"], b["attn"]), BH, K, N, D, side,
                k6_seed(ver), thr, scale, stream)

        def attn_bwd(ver):
            b, lib = bufs[ver], lib_of[ver]
            return lambda: lib.dmlt_fused_table_bwd(
                *ptr(q, k, v, bufs["current"]["attn"], g_out, g_attn, b["dq"],
                     b["dkv"], b["ds"], b["part"]), BH, K, N, D, splits,
                k6_seed(ver), thr, scale, stream)

        def scatter(ver):
            return lambda: cpb.table_scatter_launch(
                table, taps, fracs, bufs[ver]["ds"], side, dtable, dfracs)

        def bwd(ver):
            a, s = attn_bwd(ver), scatter(ver)
            return lambda: (a(), s())

        def k7_attn(ver):
            b, lib = bufs[ver], lib_of[ver]
            a_nk = bufs["current"]["attn"].transpose(1, 2).contiguous()
            return lambda: lib.dmlt_fused_exact_bwd(
                *ptr(q, k, v, a_nk, g_out, g_attn_nk, b["dq"], b["dkv"],
                     b["ds"], b["part"]), BH, K, N, D, splits, 1, seed, thr,
                scale, stream)

        def k7(ver):
            a = k7_attn(ver)
            ds = bufs[ver]["ds"].view(BH, K, N)
            return lambda: (a(), fused_exact._exact_backward(
                "fused_exact_attention_backward", cpb_args, ds, False))

        for ver in ("earlier", "current"):
            assert fwd(ver)() == 0
        for ver in ("earlier", "current"):  # both on the current map
            assert attn_bwd(ver)() == 0
        torch.cuda.synchronize()

        def diff(ver, name):
            return (bufs[ver][name] - bufs["earlier"][name]).abs().max().item()

        print(f"[K6 rate {rate}] against the earlier kernels, max abs: out "
              f"{diff('current', 'out'):.3e}, attn "
              f"{diff('current', 'attn'):.3e}; dq {diff('current', 'dq'):.3e},"
              f" dk and dv {diff('current', 'dkv'):.3e}")

        def timed(name, make, iters):
            ms = {}
            for ver in ("earlier", "current", "current", "earlier"):
                ms.setdefault(ver, []).append(cs.cuda_ms(make(ver), iters))
            print(f"[K6 rate {rate}] {name} ms: " + ", ".join(
                f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
                for ver, ts in ms.items()))

        with torch.inference_mode():
            timed("K6-fwd", fwd, 10)
            timed("K6-bwd whole", bwd, 10)
            timed("K6-bwd attention part", attn_bwd, 10)
            timed("K1-bwd scatter of ds", scatter, 10)
            timed("K7-bwd nk attention part", k7_attn, 10)
            timed("K7-bwd nk whole", k7, 3)
            for n, (what, _) in K6_SPLIT.items():
                make = fwd if n <= 5 else attn_bwd
                split = [cs.cuda_ms(make(f"split{n}"), 10) for _ in range(2)]
                print(f"[K6 rate {rate}] split {n}, {what}: "
                      f"{'K6-fwd' if n <= 5 else 'attention part'} ms "
                      + " / ".join(f"{t:.4f}" for t in split))
                if n == 5:
                    split = [cs.cuda_ms(attn_bwd("split5"), 10)
                             for _ in range(2)]
                    print(f"[K6 rate {rate}] split 5, {what}: attention part "
                          "ms " + " / ".join(f"{t:.4f}" for t in split))
        del bufs
        torch.cuda.empty_cache()
    return 0


TABLE_SOURCES = ("cpb_table_bwd.cu", "cpb_table_strided_bwd.cu")
TABLE_KERNELS = ("cpb_table_bwd_partial_kernel", "strided_dshift_kernel",
                 "strided_dtable_kernel", "sum_partials_kernel")
# compile-time patches (SPLIT k) of the partial-table design of K1-bwd and
# K5-bwd: each skips one phase, for the time it takes, and the last one
# takes K1-bwd's d/dfx as a y-blend of table differences, for its error
# against float64
PARTIALS_SPLIT = {
    1: ("K1-bwd without its row loop (zeroing, writing and summing the "
        "partial tables)", [("  for (int r = r0; r < r1; ++r) {",
                             "  for (int r = r0; SPLIT != 1 && r < r1; ++r) {")]),
    2: ("K1-bwd without sum_partials", [
        ("  return sum_partials(partial, nparts, tn_rows * tn_cols, dtable, s);",
         "  return SPLIT == 2 ? 0 : sum_partials(partial, nparts, "
         "tn_rows * tn_cols, dtable, s);")]),
    3: ("K5-bwd without the dshift kernel", [
        ("  strided_dshift_kernel<<<rows", "  if (SPLIT != 3) "
         "strided_dshift_kernel<<<rows")]),
    4: ("K5-bwd without the dtable kernel", [
        ("  strided_dtable_kernel<<<grid", "  if (SPLIT != 4) "
         "strided_dtable_kernel<<<grid")]),
    5: ("K5-bwd's dtable kernel without its row loop (tap staging and "
        "compaction only), no dshift kernel", [
            ("    for (int h = 0; h < n; ++h) {",
             "    for (int h = 0; SPLIT != 5 && h < n; ++h) {"),
            ("  strided_dshift_kernel<<<rows", "  if (SPLIT != 5) "
             "strided_dshift_kernel<<<rows")]),
    6: ("K5-bwd without the group sum", [
        ("      sum_partials(partial, groups, tn_rows * tn_cols, dtable, s));",
         "      SPLIT == 6 ? 0 : sum_partials(partial, groups, "
         "tn_rows * tn_cols, dtable, s));")]),
    7: ("K1-bwd with d/dfx as a y-blend of table differences", [
        ("        const float a0 = t[0] * gy + t[w] * fy;\n"
         "        const float a1 = t[1] * gy + t[w + 1] * fy;\n"
         "        sx += d0 * (a1 - a0);",
         "        sx += d0 * ((t[1] - t[0]) * gy + (t[w + 1] - t[w]) * fy);")]),
}
# the same for the tile design (table_bwd_tiles.cuh), and variants of its
# rows in flight and blocks an SM (each timed in the case it concerns)
TILES_SPLIT = {
    1: ("without the shift sums", [
        ("      const float sum = warp_pair_sum(sy, sx);\n      if (holds",
         "      const float sum = SPLIT == 1 ? 0.0f : "
         "warp_pair_sum(sy, sx);\n      if (holds")]),
    2: ("without the finishing kernel", [
        ("  return finish(", "  if (SPLIT == 2) return 0;\n  return finish(")]),
    3: ("without reading the window cotangent", [
        ("  return load(dw + i);", "  return SPLIT == 3 ? 0.0f : load(dw + i);")]),
    4: ("without the rows (listing them, the table's differences, the "
        "partial tables and the finishing kernel)", [
            ("    unsigned todo = __ballot_sync(0xffffffffu, active);",
             "    unsigned todo = SPLIT == 4 ? 0u : "
             "__ballot_sync(0xffffffffu, active);")]),
    5: ("variant: 6 rows in flight at divisor 1", [
        ("constexpr int kRowsD1 = 4;", "constexpr int kRowsD1 = 6;")]),
    6: ("variant: 8 rows in flight at divisor 1, 3 blocks an SM", [
        ("constexpr int kRowsD1 = 4;", "constexpr int kRowsD1 = 8;"),
        ("kD1 ? 4 : 2)", "kD1 ? 3 : 2)")]),
    7: ("variant: 1 row in flight at d >= 2", [
        ("constexpr int kRowsStrided = 2;", "constexpr int kRowsStrided = 1;")]),
    8: ("variant: 4 rows in flight at d >= 2 (it spills)", [
        ("constexpr int kRowsStrided = 2;", "constexpr int kRowsStrided = 4;")]),
    9: ("variant: reads at d >= 2 only in the tap w00's phase (for the "
        "time of unreplicated reads; wrong results)", [
            ("    const bool jin = valid && static_cast<unsigned>(j) <",
             "    const bool jin = valid && (kD1 || q.code == 3) && "
             "static_cast<unsigned>(j) <")]),
}
# the partial-table design's C signatures and row-group constants
PARTIALS_ARGS = {
    "dmlt_cpb_table_interp_bwd": [P, I, I, P, P, P, I, P, P, P, I, I, I, P],
    "dmlt_cpb_table_strided_bwd": [P, I, I, P, P, P, I, P, P, P, I, I, I, I,
                                   P]}


def table_design(csrc: Path) -> str:
    """``"tiles"`` for the tile design of the table backward (its shared
    header present), else ``"partials"``."""
    return "tiles" if (csrc / "table_bwd_tiles.cuh").exists() else "partials"


class TableBwd:
    """Raw C calls of one build of K1-bwd and K5-bwd, with its own scratch,
    on the arguments of one case."""

    def __init__(self, lib_name: str, design: str):
        from disentangled_multimodal_learning_tpu_torch.ops import build

        self.lib = ctypes.CDLL(str(OUT / lib_name / "lib.so"))
        for entry in PARTIALS_ARGS:
            getattr(self.lib, entry).argtypes = (
                PARTIALS_ARGS[entry] if design == "partials"
                else list(build.SIGNATURES[entry]))
        self.design = design

    def call(self, c: dict, divisor: int, groups: int | None = None):
        """A function that runs the backward once on case ``c`` (table,
        taps, fracs, dout) into ``c``'s dtable and dfracs."""
        import torch

        from disentangled_multimodal_learning_tpu_torch.ops import cpb

        table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                                   "dout"))
        R, side = taps.shape[0], dout.shape[-1]
        stream = torch.cuda.current_stream().cuda_stream
        head = (table.data_ptr(), *table.shape, taps.data_ptr(),
                fracs.data_ptr(), dout.data_ptr(),
                int(dout.dtype == torch.bfloat16), c["dtable"].data_ptr(),
                c["dfracs"].data_ptr())
        if self.design == "tiles":
            plan = cpb.table_bwd_plan(*table.shape, R, side, divisor)
            if groups:
                plan = plan._replace(groups=groups,
                                     rows_per_group=-(-R // groups))
            partial, dpart = cpb.table_bwd_scratch(plan, R, table)
            entry = (self.lib.dmlt_cpb_table_interp_bwd if divisor == 1
                     else self.lib.dmlt_cpb_table_strided_bwd)
            args = (*head, partial.data_ptr(), dpart.data_ptr(), R, side,
                    divisor, plan.strip, plan.warps_per_phase, plan.phases,
                    plan.groups, stream)
            c.setdefault("scratch", []).append((partial, dpart))
            return lambda: entry(*args)
        if divisor == 1:
            nparts = min(R, 264)  # TABLE_BWD_PARTS of the partial design
            partial = torch.empty(nparts, table.numel(), device=table.device)
            args = (*head, partial.data_ptr(), R, side, nparts, stream)
            entry = self.lib.dmlt_cpb_table_interp_bwd
        else:
            rn_rows, rn_cols = (-(-n // divisor) for n in table.shape)
            tiles = divisor * divisor * -(-rn_rows // 16) * -(-rn_cols // 32)
            groups = max(1, min(8, R, -(-1056 // tiles)))
            partial = torch.empty(groups, table.numel(), device=table.device)
            args = (*head, partial.data_ptr(), R, side, divisor, groups,
                    stream)
            entry = self.lib.dmlt_cpb_table_strided_bwd
        c.setdefault("scratch", []).append(partial)
        return lambda: entry(*args)


def table_cases(dev) -> dict:
    """The inputs of ``chip_smoke.py``: phase 2b's K1-bwd case (f32
    cotangent), phase 2e's at divisors 1 (bf16 cotangent), 2 and 4, and
    the table, taps and fractions of phase 2e's K6 case with its map
    cotangent standing for K6-bwd's ds (the same shape; the scatter's work
    does not depend on the values)."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    gen = torch.Generator().manual_seed(1)
    k1 = cs.table_backward_case(cpb, dev, gen, cs.mlp_weights(1, gen, dev))
    opt = cs.opt_in_table_cases(cpb, dev)
    c6 = cs.fused_case(dev, torch.Generator().manual_seed(7))
    taps6, fracs6 = cpb.table_taps(c6["shifts"], side=c6["side"],
                                   tn=c6["table"].shape[0])
    cases = {
        "K1-bwd f32": (1, dict(k1)),
        "K1-bwd bf16": (1, dict(opt[1], dout=opt[1]["dout"].to(
            torch.bfloat16))),
        "K6-bwd scatter of ds": (1, dict(
            table=c6["table"], taps=taps6, fracs=fracs6,
            dout=c6["g_attn"].reshape(-1, c6["side"], c6["side"]))),
        "K5-bwd divisor 2": (2, dict(opt[2])),
        "K5-bwd divisor 4": (4, dict(opt[4])),
    }
    for _, c in cases.values():
        c["dtable"] = torch.empty_like(c["table"])
        c["dfracs"] = torch.empty_like(c["fracs"])
    return cases


def compare_table(parent: Path, group_counts=()) -> int:
    """K1-bwd (f32 and bf16 cotangents), K6-bwd's scatter of ds and K5-bwd
    (divisors 2 and 4): earlier against current sources, raw C calls timed
    with CUDA events (earlier, current, current, earlier), each version's
    compile-time splits, its ptxas lines, and the errors of its shift
    cotangents against float64 (dfy and dfx apart)."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    current = ROOT / SUB
    designs = {"earlier": table_design(parent), "current": table_design(current)}
    print(f"designs: {designs}")
    splits = {"partials": PARTIALS_SPLIT, "tiles": TILES_SPLIT}
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"table_{ver}", csrc, TABLE_SOURCES, (), ()))
        jobs += [(f"table_{ver}_split{k}", csrc, TABLE_SOURCES, patches,
                  (f"-DSPLIT={k}",))
                 for k, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        if "split" in name:
            continue
        lines = (cs.kernel_ptxas(log, TABLE_KERNELS)
                 if designs[name.split("_")[1]] == "partials"
                 else [f"{k}: {ln}" for k, ln in cs.table_bwd_ptxas(log)])
        print(f"{name} ptxas:\n  " + "\n  ".join(lines))
    libs = {name: TableBwd(name, designs[name.split("_")[1]])
            for name, _ in built}

    dev = torch.device("cuda")
    cases = table_cases(dev)
    for label, (d, c) in cases.items():
        R, side = c["taps"].shape[0], c["dout"].shape[-1]
        print(f"[{label}] R={R} side={side} tn={c['table'].shape[0]} "
              f"{str(c['dout'].dtype)[6:]} cotangent")
        want = cpb.table_interp_backward_reference(
            c["table"].double(), c["taps"], c["fracs"].double(),
            c["dout"].double(), side, d)
        plain = cpb.table_interp_backward_reference(
            c["table"], c["taps"], c["fracs"], c["dout"], side, d)
        outs = {}
        for ver in ("earlier", "current"):
            run = libs[f"table_{ver}"].call(c, d)
            assert run() == 0
            again = (c["dtable"].clone(), c["dfracs"].clone())
            assert run() == 0
            torch.cuda.synchronize()
            det = all(torch.equal(a, b) for a, b in
                      zip(again, (c["dtable"], c["dfracs"])))
            outs[ver] = again
            errs = cs.table_backward_errors(again, plain, want)
            print(f"[{label}] {ver}: deterministic {det}; rel err vs f64, "
                  "kernel / f32 plain: " + ", ".join(
                      f"{n} {e:.3e} / {pe:.3e}" for n, (e, pe) in errs.items()))
        print(f"[{label}] current against earlier, max abs: dtable "
              f"{(outs['current'][0] - outs['earlier'][0]).abs().max():.3e}, "
              f"dfracs "
              f"{(outs['current'][1] - outs['earlier'][1]).abs().max():.3e}")
        if d == 1 and designs["earlier"] == "partials":
            run = libs["table_earlier_split7"].call(c, d)
            assert run() == 0
            torch.cuda.synchronize()
            errs = cs.table_backward_errors((c["dtable"], c["dfracs"]),
                                            plain, want)
            print(f"[{label}] earlier, {PARTIALS_SPLIT[7][0]}: rel err vs "
                  "f64: " + ", ".join(f"{n} {e:.3e}"
                                      for n, (e, _) in errs.items()))
        del want, plain
        ms = {}
        for ver in ("earlier", "current", "current", "earlier"):
            ms.setdefault(ver, []).append(
                cs.cuda_ms(libs[f"table_{ver}"].call(c, d), 20))
        print(f"[{label}] ms: " + ", ".join(
            f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
            for ver, ts in ms.items()) + f" | {cs.card_line()}")
        for ver in ("earlier", "current"):
            for k, (what, _) in splits[designs[ver]].items():
                if designs[ver] == "partials" and (
                        (d == 1) != what.startswith("K1") or k == 7):
                    continue
                if what.startswith("variant") and (
                        ("divisor 1" in what and d != 1)
                        or ("d >= 2" in what and d == 1)):
                    continue
                t = [cs.cuda_ms(libs[f"table_{ver}_split{k}"].call(c, d), 20)
                     for _ in range(2)]
                print(f"[{label}] {ver} split {k}, {what}: ms "
                      + " / ".join(f"{x:.4f}" for x in t))
        if designs["current"] == "tiles":
            for g in group_counts:
                t = [cs.cuda_ms(libs["table_current"].call(c, d, g), 20)
                     for _ in range(2)]
                print(f"[{label}] current at {g} row groups: ms "
                      + " / ".join(f"{x:.4f}" for x in t))
        c.pop("scratch", None)
        torch.cuda.empty_cache()
    return 0


K3_KERNELS = ("dpc_stream_kernel", "dpc_split_kernel", "dpc_finish_kernel")
# compile-time patches (SPLIT k) of the earlier design, a block per token
# tile with a 1 x 32 register tile; each skips one phase, for the
# time it takes (1 keeps the dots alive through a test that never holds)
K3_STREAM_SPLIT = {
    1: ("without the selection epilogue", [
        ("    if (!live) continue;",
         "    if (SPLIT == 1 || SPLIT == 2) {\n      float s = 0.f;\n"
         "#pragma unroll\n      for (int j = 0; j < kNbr; ++j) s += acc[j];\n"
         "      if (s == 1.25e-30f) { best[0] = s; row_max = s; pmin = s; }\n"
         "      continue;\n    }\n    if (!live) continue;")]),
    2: ("the loads alone (no dots, no selection)", [
        ("    if (!live) continue;",
         "    if (SPLIT == 1 || SPLIT == 2) {\n      float s = 0.f;\n"
         "#pragma unroll\n      for (int j = 0; j < kNbr; ++j) s += acc[j];\n"
         "      if (s == 1.25e-30f) { best[0] = s; row_max = s; pmin = s; }\n"
         "      continue;\n    }\n    if (!live) continue;"),
        ("    for (int q = 0; q < c4n; ++q) {",
         "    for (int q = 0; SPLIT != 2 && q < c4n; ++q) {")]),
    3: ("without loading the neighbour tiles", [
        ("      sxj[e] = e < nj * c4n ? src[e]",
         "      if (SPLIT != 3) sxj[e] = e < nj * c4n ? src[e]")]),
}
# ... and of the design that splits the neighbour axis
K3_SPLITS_SPLIT = {
    1: ("without the selection epilogue (d2 values, selection, partials)", [
        ("    if (at.ch != nch - 1) {\n",
         "    if (SPLIT == 1 || SPLIT == 2) {\n      if (at.ch == nch - 1) {\n"
         "        float s = 0.f;\n#pragma unroll\n"
         "        for (int r = 0; r < kRM; ++r)\n#pragma unroll\n"
         "          for (int q = 0; q < kRN; ++q) s += acc[r][q];\n"
         "        if (s == 1.25e-30f) part[tid] = s;\n      }\n"
         "      at.next(nch, work);\n      continue;\n    }\n"
         "    if (at.ch != nch - 1) {\n")]),
    2: ("the loads alone (no dots, no selection)", [
        ("    if (at.ch != nch - 1) {\n",
         "    if (SPLIT == 1 || SPLIT == 2) {\n      if (at.ch == nch - 1) {\n"
         "        float s = 0.f;\n#pragma unroll\n"
         "        for (int r = 0; r < kRM; ++r)\n#pragma unroll\n"
         "          for (int q = 0; q < kRN; ++q) s += acc[r][q];\n"
         "        if (s == 1.25e-30f) part[tid] = s;\n      }\n"
         "      at.next(nch, work);\n      continue;\n    }\n"
         "    if (at.ch != nch - 1) {\n"),
        ("    for (int kk = 0; kk < kKC; kk += 4) {",
         "    for (int kk = 0; SPLIT != 2 && kk < kKC; kk += 4) {")]),
    3: ("without loading the neighbour slices", [
        ("      cp_async16(dst + r * kLdb,",
         "      if (SPLIT != 3) cp_async16(dst + r * kLdb,")]),
    4: ("without the finishing kernel", [
        ("  dpc_finish_kernel<kParent, K><<<",
         "  if (SPLIT != 4) dpc_finish_kernel<kParent, K><<<")]),
    5: ("variant: a two-stage ring", [
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    6: ("variant: 16-channel slices, a four-stage ring", [
        ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        ("constexpr int kKC = 32;", "constexpr int kKC = 16;")]),
    7: ("the products reading one token float4 a slice (not 8)", [
        ("            a + (warp + kWarps * r) * la + kk);",
         "            a + (warp + kWarps * r) * la + "
         "(SPLIT == 7 ? 0 : kk));")]),
    8: ("the products reading one neighbour float4 a slice (not 8)", [
        ("bs + (lane + 32 * q) * kLdb +\n" + " " * 49 + "kk);",
         "bs + (lane + 32 * q) * kLdb +\n (SPLIT == 8 ? 0 : kk));")]),
}


def k3_design(csrc: Path) -> str:
    """``"splits"`` for the design whose blocks split the neighbour axis
    (a finishing kernel merges them), else ``"stream"``."""
    text = (csrc / "dpc_knn.cu").read_text()
    return "splits" if "dpc_finish_kernel" in text else "stream"


class K3Lib:
    """Raw C calls of one build of K3-knn and K3-parent, with its own
    outputs and scratch."""

    def __init__(self, lib_name: str, design: str):
        from disentangled_multimodal_learning_tpu_torch.ops import build

        self.lib = ctypes.CDLL(str(OUT / lib_name / "lib.so"))
        stream_args = {"dmlt_dpc_knn": [P, P, I, I, I, I, P, P, P],
                       "dmlt_dpc_parent": [P, P, P, I, I, I, P, P]}
        for entry in stream_args:
            getattr(self.lib, entry).argtypes = (
                stream_args[entry] if design == "stream"
                else list(build.SIGNATURES[entry]))
        self.design = design

    def calls(self, x, x2, density, k: int, blocks: int | None = None):
        """``(knn, parent, outputs)``: two functions that run K3-knn and
        K3-parent once on ``x``, and their outputs ``(knn2, rmax2,
        parent2)``; ``blocks`` overrides the plan of the split design."""
        import torch

        B, N, C = x.shape
        dev = x.device
        stream = torch.cuda.current_stream().cuda_stream
        knn2 = torch.empty(B, N, k, device=dev)
        rmax2, parent2 = torch.empty(B, N, device=dev), torch.empty(
            B, N, device=dev)
        outs = (knn2, rmax2, parent2)
        if self.design == "stream":
            return (lambda: self.lib.dmlt_dpc_knn(
                x.data_ptr(), x2.data_ptr(), B, N, C, k, knn2.data_ptr(),
                rmax2.data_ptr(), stream),
                lambda: self.lib.dmlt_dpc_parent(
                    x.data_ptr(), x2.data_ptr(), density.data_ptr(), B, N, C,
                    parent2.data_ptr(), stream), outs)
        from disentangled_multimodal_learning_tpu_torch.ops import dpc_knn

        plan = dpc_knn.dpc_plan(B, N)
        if blocks:
            plan = plan._replace(blocks=blocks)
        part_k = dpc_knn.dpc_scratch(plan, x, k)
        part_p = dpc_knn.dpc_scratch(plan, x, None)
        return (lambda: self.lib.dmlt_dpc_knn(
            x.data_ptr(), x2.data_ptr(), B, N, C, k, plan.blocks,
            part_k.data_ptr(), knn2.data_ptr(), rmax2.data_ptr(), stream),
            lambda: self.lib.dmlt_dpc_parent(
                x.data_ptr(), x2.data_ptr(), density.data_ptr(), B, N, C,
                plan.blocks, part_p.data_ptr(), parent2.data_ptr(), stream),
            outs)


def compare_k3(parent: Path, block_counts=()) -> int:
    """K3-knn and K3-parent: earlier against current sources on phase 2c's
    inputs, raw C calls timed with CUDA events (earlier, current, current,
    earlier), each version's compile-time splits, its ptxas lines and
    SASS counts, and the f32 ``torch.bmm`` of the same tokens."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import dpc_knn

    current = ROOT / SUB
    designs = {"earlier": k3_design(parent), "current": k3_design(current)}
    print(f"designs: {designs}")
    splits = {"stream": K3_STREAM_SPLIT, "splits": K3_SPLITS_SPLIT}
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"k3_{ver}", csrc, ("dpc_knn.cu",), (), ()))
        jobs += [(f"k3_{ver}_split{n}", csrc, ("dpc_knn.cu",), patches,
                  (f"-DSPLIT={n}",))
                 for n, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        if "split" not in name:
            print(f"{name} ptxas:\n  " + "\n  ".join(
                cs.kernel_ptxas(log, K3_KERNELS, cs.k3_instance)))
            print(f"{name} SASS:\n  " + "\n  ".join(
                cs.sass_counts(OUT / name / "lib.so", K3_KERNELS,
                               cs.k3_instance)))
    libs = {name: K3Lib(name, designs[name.split("_")[1]])
            for name, _ in built}

    dev = torch.device("cuda")
    B, N, C, k = 4, 2500, 128, 5  # chip_smoke.py phase 2c, random bags
    gen = torch.Generator().manual_seed(2)
    x = torch.nn.functional.layer_norm(torch.randn(B, N, C, generator=gen),
                                       (C,)).to(dev)
    x2 = (x * x).sum(-1)
    knn_p, rmax_p = dpc_knn.knn_stream_reference(x, x2, k)
    density = torch.exp(-knn_p.clamp_min(1e-12).mean(-1) / C) + torch.rand(
        B, N, generator=gen).to(dev) * 1e-6
    plain = (knn_p, rmax_p, dpc_knn.parent_stream_reference(x, x2, density))
    print(f"[K3] B={B} N={N} C={C} k={k} | {cs.card_line()}")
    runs = {}
    for ver in ("earlier", "current"):
        knn, par, outs = libs[f"k3_{ver}"].calls(x, x2, density, k)
        assert knn() == 0 and par() == 0
        first = [o.clone() for o in outs]
        assert knn() == 0 and par() == 0
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, outs))
        errs = [(o - p).abs().max().item() for o, p in zip(outs, plain)]
        print(f"[K3] {ver} ({designs[ver]}): bitwise over two calls {same}; "
              "max abs against the plain version: knn2 {:.3e}, rowmax2 "
              "{:.3e}, parent2 {:.3e}".format(*errs))
        runs[ver] = (knn, par, outs)
    for i, name in enumerate(("knn2", "rowmax2", "parent2")):
        d = (runs["current"][2][i] - runs["earlier"][2][i]).abs().max().item()
        print(f"[K3] current against earlier, {name} max abs {d:.3e}")

    def timed(label, make_pair):
        for which, idx in (("K3-knn", 0), ("K3-parent", 1)):
            ms = {}
            for ver in ("earlier", "current", "current", "earlier"):
                ms.setdefault(ver, []).append(cs.cuda_ms(make_pair(ver)[idx],
                                                         20))
            print(f"[K3] {which}{label} ms: " + ", ".join(
                f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
                for ver, ts in ms.items()) + f" | {cs.card_line()}")

    timed("", lambda ver: runs[ver])
    for ver in ("earlier", "current"):
        for n, (what, _) in splits[designs[ver]].items():
            knn, par, _ = libs[f"k3_{ver}_split{n}"].calls(x, x2, density, k)
            assert knn() == 0 and par() == 0
            for which, fn in (("K3-knn", knn), ("K3-parent", par)):
                t = [cs.cuda_ms(fn, 20) for _ in range(2)]
                print(f"[K3] {ver} split {n}, {what}: {which} ms "
                      + " / ".join(f"{v:.4f}" for v in t))
    if designs["current"] == "splits":
        for blocks in block_counts:
            knn, par, _ = libs["k3_current"].calls(x, x2, density, k, blocks)
            assert knn() == 0 and par() == 0
            t = [cs.cuda_ms(fn, 20) for fn in (knn, knn, par, par)]
            print(f"[K3] current at {blocks} blocks: K3-knn ms "
                  f"{t[0]:.4f} / {t[1]:.4f}, K3-parent ms {t[2]:.4f} / "
                  f"{t[3]:.4f}")
    xt = x.transpose(1, 2).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.empty(B, N, N, device=dev)
        t = [cs.cuda_ms(lambda: torch.bmm(x, xt, out=out), 20)
             for _ in range(2)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flops = 2 * B * N * N * C
    print(f"[K3] yardstick, the dots alone, not the function: f32 "
          f"torch.bmm(x, x^T) with TF32 off ms {t[0]:.4f} / {t[1]:.4f} "
          f"({flops / min(t) / 1e9:.1f} TFLOP/s) | {cs.card_line()}")
    return 0


# ---------------------------------------------------------------- K4-bwd

K4_PARTIALS_KERNELS = ("cpb_table_1d_bwd_partial_kernel",
                       "sum_partials_kernel")
# compile-time patches (SPLIT k) of the earlier K4-bwd, a block per run of
# rows keeping the table and a partial table in shared memory: each skips
# one phase, for the time it takes (the results are wrong)
K4_PARTIALS_SPLIT = {
    1: ("without the shift sums (each row's terms and block sum)", [
        ("        if (n < n_q) sd += d0 * (t[n + 1] - t[n]);",
         "        if (SPLIT != 1 && n < n_q) sd += d0 * (t[n + 1] - t[n]);"),
        ("    block_sum<kThreads>(s, s_red);",
         "    if (SPLIT != 1) block_sum<kThreads>(s, s_red);")]),
    2: ("without writing and summing the partial tables", [
        ("  for (int i = threadIdx.x; i < tsize; i += blockDim.x) out[i] = "
         "s_dtab[i];",
         "  for (int i = threadIdx.x; SPLIT != 2 && i < tsize; "
         "i += blockDim.x) out[i] = s_dtab[i];"),
        ("  return sum_partials(partial, nparts, tsize, dtable, s);",
         "  return SPLIT == 2 ? 0 : sum_partials(partial, nparts, tsize, "
         "dtable, s);")]),
    3: ("the loads alone (the row loop with its barrier reading d, no "
        "scatter, no shift sum, no partial tables)", [
            ("        dt[n] += d0 * g + d1 * f;\n"
             "        if (n < n_q) sd += d0 * (t[n + 1] - t[n]);",
             "        sd += d0 + d1;"),
            ("    block_sum<kThreads>(s, s_red);\n"
             "    if (threadIdx.x == 0) dshifts[r] = s[0];",
             "    if (s[0] == 1234.5f) dshifts[r] = s[0];"),
            ("  for (int i = threadIdx.x; i < tsize; i += blockDim.x) out[i] = "
             "s_dtab[i];", ""),
            ("  return sum_partials(partial, nparts, tsize, dtable, s);",
             "  return 0;")]),
    4: ("the loads alone, and no barrier between rows", [
        ("    __syncthreads();  // the previous row's scatter (and s_red) "
         "are done", ""),
        ("        dt[n] += d0 * g + d1 * f;\n"
         "        if (n < n_q) sd += d0 * (t[n + 1] - t[n]);",
         "        sd += d0 + d1;"),
        ("    block_sum<kThreads>(s, s_red);\n"
         "    if (threadIdx.x == 0) dshifts[r] = s[0];",
         "    if (s[0] == 1234.5f) dshifts[r] = s[0];"),
        ("  for (int i = threadIdx.x; i < tsize; i += blockDim.x) out[i] = "
         "s_dtab[i];", ""),
        ("  return sum_partials(partial, nparts, tsize, dtable, s);",
         "  return 0;")]),
}
# the same for the tile design, and variants of its rows in flight, strips
# and warps (each a compile-time constant)
K4_TILES_SPLIT = {
    1: ("without the shift sums", [
        ("      const float sum = warp_sum_rows<kRows>(sd, lane);",
         "      const float sum = SPLIT == 1 ? 0.0f : "
         "warp_sum_rows<kRows>(sd, lane);")]),
    2: ("without the finishing kernel", [
        ("  const int table_blocks = (n_out * tn + 31) / 32;",
         "  if (SPLIT == 2) return 0;\n"
         "  const int table_blocks = (n_out * tn + 31) / 32;")]),
    3: ("without reading the cotangent", [
        ("? __ldg(d + e) : 0.0f;", "? (SPLIT == 3 ? 0.0f : __ldg(d + e)) : "
         "0.0f;"),
        ("? __ldg(d + wb - 1) : 0.0f;",
         "? (SPLIT == 3 ? 0.0f : __ldg(d + wb - 1)) : 0.0f;")]),
    4: ("without the rows (listing them, the differences, the partial "
        "tables and the finishing kernel)", [
            ("    unsigned todo = __ballot_sync(0xffffffffu, active);",
             "    unsigned todo = SPLIT == 4 ? 0u : "
             "__ballot_sync(0xffffffffu, active);")]),
    5: ("variant: 2 rows in flight", [
        ("constexpr int kRows = 4;", "constexpr int kRows = 2;")]),
    6: ("variant: 8 rows in flight", [
        ("constexpr int kRows = 4;", "constexpr int kRows = 8;")]),
    7: ("variant: strips of 8 (tiles of 2048)", [
        ("constexpr int kStrip = 4;", "constexpr int kStrip = 8;")]),
    8: ("variant: 4 warps a block (tiles of 512)", [
        ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
        ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 8)")]),
    9: ("variant: strips of 8 (tiles of 2048), 3 blocks an SM", [
        ("constexpr int kStrip = 4;", "constexpr int kStrip = 8;"),
        ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")]),
}
K4_PARTIALS_ARGS = [P, I, I, P, P, P, P, P, P, I, I, I, I, P]


def k4_design(csrc: Path) -> str:
    """``"tiles"`` for the owner-computes tile design of K4-bwd, else
    ``"partials"`` (a partial table per block)."""
    text = (csrc / "cpb_table_1d_bwd.cu").read_text()
    return "tiles" if "table1d_bwd_tile_kernel" in text else "partials"


class Table1dBwd:
    """Raw C calls of one build of K4-bwd, with its own scratch, on the
    arguments of one case."""

    def __init__(self, lib_name: str, design: str):
        from disentangled_multimodal_learning_tpu_torch.ops import build

        self.lib = ctypes.CDLL(str(OUT / lib_name / "lib.so"))
        self.lib.dmlt_cpb_table_1d_bwd.argtypes = (
            K4_PARTIALS_ARGS if design == "partials"
            else list(build.SIGNATURES["dmlt_cpb_table_1d_bwd"]))
        self.design = design

    def call(self, c: dict, groups: int | None = None):
        """A function that runs the backward once on case ``c`` into its
        dtable and dshifts."""
        import torch

        from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

        table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                                   "dout"))
        O, tn = table.shape
        R = taps.shape[0]
        head = (table.data_ptr(), O, tn, taps.data_ptr(), fracs.data_ptr(),
                dout.data_ptr(), c["dtable"].data_ptr(),
                c["dshifts"].data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if self.design == "tiles":
            plan = cpb1d.table1d_bwd_plan(O, tn, R, groups)
            partial = torch.empty(plan.groups, table.numel(),
                                  device=table.device)
            # room for the (row, tile) sums of tiles down to 256 entries
            dpart = torch.empty(R, O * -(-tn // 256), device=table.device)
            args = (*head, partial.data_ptr(), dpart.data_ptr(), R, c["kv"],
                    c["n_q"], plan.groups, stream)
            scratch = (partial, dpart)
        else:
            nparts = min(R, 264)  # TABLE_BWD_PARTS of the partial design
            partial = torch.empty(nparts, table.numel(), device=table.device)
            args = (*head, partial.data_ptr(), R, c["kv"], c["n_q"], nparts,
                    stream)
            scratch = (partial,)
        c.setdefault("scratch", []).append(scratch)
        fn = self.lib.dmlt_cpb_table_1d_bwd
        return lambda: fn(*args)


def compare_k4(parent: Path, group_counts=()) -> int:
    """K4-bwd: earlier against current sources on phase 2d's inputs, raw C
    calls timed with CUDA events (earlier, current, current, earlier), each
    version's errors against float64 and its bitwise repeatability, its
    compile-time splits, its ptxas lines, and the current design at the
    row-group counts of ``--groups``."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import cpb1d

    current = ROOT / SUB
    designs = {"earlier": k4_design(parent), "current": k4_design(current)}
    print(f"designs: {designs}")
    splits = {"partials": K4_PARTIALS_SPLIT, "tiles": K4_TILES_SPLIT}
    kernels = {"partials": K4_PARTIALS_KERNELS, "tiles": cs.K4_BWD_KERNELS}
    src = ("cpb_table_1d_bwd.cu",)
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"k4_{ver}", csrc, src, (), ()))
        jobs += [(f"k4_{ver}_split{n}", csrc, src, patches, (f"-DSPLIT={n}",))
                 for n, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        design = designs[name.split("_")[1]]
        keys = kernels[design]
        if "split" in name:  # the variants' registers and spills
            n = int(name.split("split")[1])
            if splits[design][n][0].startswith("variant"):
                print(f"{name} ptxas: " + " | ".join(cs.kernel_ptxas(log,
                                                                     keys,
                                                                     {})))
            continue
        print(f"{name} ptxas:\n  " + "\n  ".join(cs.kernel_ptxas(log, keys,
                                                                  {})))
    libs = {name: Table1dBwd(name, designs[name.split("_")[1]])
            for name, _ in built}

    dev = torch.device("cuda")
    c = cs.table1d_case(dev)
    c["dtable"] = torch.empty_like(c["table"])
    c["dshifts"] = torch.empty_like(c["fracs"])
    table, taps, fracs, dout = (c[n] for n in ("table", "taps", "fracs",
                                               "dout"))
    n_q, kv = c["n_q"], c["kv"]
    R = taps.shape[0]
    (bms, by) = cs.table1d_bounds(dict(c, out_numel=dout.numel()))[1]
    plan = cpb1d.table1d_bwd_plan(*table.shape, R)
    print(f"[K4-bwd] R={R} O={table.shape[0]} n_q={n_q} tn={table.shape[1]}:"
          f" bound {bms:.4f} ms by {by}; the current plan {plan.groups} row "
          f"groups of {plan.rows_per_group}, {plan.tiles} tiles | "
          f"{cs.card_line()}")
    want = cpb1d.table1d_interp_backward_reference(
        table.double(), taps, fracs.double(), dout.double(), n_q, kv)
    plain = cpb1d.table1d_interp_backward_reference(table, taps, fracs, dout,
                                                    n_q, kv)
    outs = {}
    for ver in ("earlier", "current"):
        run = libs[f"k4_{ver}"].call(c)
        assert run() == 0
        first = (c["dtable"].clone(), c["dshifts"].clone())
        assert run() == 0
        torch.cuda.synchronize()
        det = all(torch.equal(a, b)
                  for a, b in zip(first, (c["dtable"], c["dshifts"])))
        outs[ver] = first
        errs = [(cs.rel_err(g, w), cs.rel_err(p, w))
                for g, p, w in zip(first, plain, want)]
        print(f"[K4-bwd] {ver} ({designs[ver]}): deterministic {det}; rel "
              "err vs f64, kernel / f32 plain: " + ", ".join(
                  f"{n} {e:.3e} / {pe:.3e}"
                  for n, (e, pe) in zip(("dtable", "dshifts"), errs)))
    print("[K4-bwd] current against earlier, max abs: " + ", ".join(
        f"{n} {(a - b).abs().max().item():.3e}" for n, a, b in
        zip(("dtable", "dshifts"), outs["current"], outs["earlier"])))
    del want, plain
    ms = {}
    for ver in ("earlier", "current", "current", "earlier"):
        ms.setdefault(ver, []).append(cs.cuda_ms(libs[f"k4_{ver}"].call(c),
                                                 20))
    print("[K4-bwd] ms: " + ", ".join(
        f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
        for ver, ts in ms.items()) + f" | {cs.card_line()}")
    for ver in ("earlier", "current"):
        for n, (what, _) in splits[designs[ver]].items():
            t = [cs.cuda_ms(libs[f"k4_{ver}_split{n}"].call(c), 20)
                 for _ in range(2)]
            print(f"[K4-bwd] {ver} split {n}, {what}: ms "
                  + " / ".join(f"{x:.4f}" for x in t))
    if designs["current"] == "tiles":
        for g in group_counts:
            t = [cs.cuda_ms(libs["k4_current"].call(c, g), 20)
                 for _ in range(2)]
            p = cpb1d.table1d_bwd_plan(*table.shape, R, g)
            print(f"[K4-bwd] current at {p.groups} row groups of "
                  f"{p.rows_per_group}: ms " + " / ".join(f"{x:.4f}"
                                                          for x in t))
    return 0


# ---------------------------------------------------------------- K1-fwd

# compile-time patches (SPLIT k) of the earlier K1-fwd, a block per row:
# each run drops the window staging, and stores a constant with scalar or
# vector stores, or reads its taps straight from the table in L2
_K1_ROWS_NO_STAGING = (
    "  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {",
    "  for (int i = threadIdx.x; SPLIT == 0 && i < w * w; i += blockDim.x) {")
K1_ROWS_SPLIT = {
    1: ("stores only: a constant, scalar stores", [
        _K1_ROWS_NO_STAGING,
        ("    store(o + i, __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));",
         "    store(o + i, SPLIT == 1 ? 1.0f : "
         "__fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));")]),
    2: ("stores only: a constant, 4-output vector stores (16 B f32, 8 B "
        "bf16)", [
            _K1_ROWS_NO_STAGING,
            ("  Out* o = out + static_cast<size_t>(r) * side * side;\n",
             "  Out* o = out + static_cast<size_t>(r) * side * side;\n"
             "  if (SPLIT == 2) {\n"
             "    for (int j = threadIdx.x; j < side * side / 4; "
             "j += blockDim.x) {\n"
             "      if constexpr (sizeof(Out) == 4) {\n"
             "        reinterpret_cast<float4*>(o)[j] = "
             "make_float4(1.0f, 1.0f, 1.0f, 1.0f);\n"
             "      } else {\n"
             "        reinterpret_cast<uint2*>(o)[j] = "
             "make_uint2(0x3f803f80u, 0x3f803f80u);\n"
             "      }\n"
             "    }\n"
             "    return;\n"
             "  }\n")]),
    3: ("no window staging: each output reads its four taps from the table "
        "(L2)", [
            _K1_ROWS_NO_STAGING,
            ("    const float* t = win + y * w + x;\n"
             "    const float a = __fadd_rn(__fmul_rn(t[0], gy), "
             "__fmul_rn(t[w], fy));\n"
             "    const float b = __fadd_rn(__fmul_rn(t[1], gy), "
             "__fmul_rn(t[w + 1], fy));",
             "    const int ws = tn_cols;\n"
             "    const float* t = table + static_cast<size_t>(y0 + y) * "
             "tn_cols + x0 + x;\n"
             "    const float a = __fadd_rn(__fmul_rn(t[0], gy), "
             "__fmul_rn(t[ws], fy));\n"
             "    const float b = __fadd_rn(__fmul_rn(t[1], gy), "
             "__fmul_rn(t[ws + 1], fy));")]),
}
# the same for the one-wave design (the table kept in shared memory), and
# variants of its table source and block size
K1_WAVE_SPLIT = {
    1: ("stores only: a constant, vector stores", [
        ("    store_vec(o + head + kVec * j, v);",
         "    if (SPLIT == 1) for (float& e : v) e = 1.0f;\n"
         "    store_vec(o + head + kVec * j, v);")]),
    2: ("scalar stores instead of vector stores", [
        ("  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], "
         "v[3]);",
         "  if (SPLIT == 2) {\n    p[0] = v[0]; p[1] = v[1]; p[2] = v[2]; "
         "p[3] = v[3];\n    return;\n  }\n"
         "  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], "
         "v[3]);"),
        ("  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);",
         "  if (SPLIT == 2) {\n    for (int k = 0; k < kVec; ++k) p[k] = "
         "__float2bfloat16_rn(v[k]);\n    return;\n  }\n"
         "  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);")]),
    3: ("the table read from global memory through L1 (not kept in shared "
        "memory)", [
            ("  return static_cast<long long>(tn_rows) * tn_cols * 4 <= "
             "kSharedTableMax;", "  return false;")]),
    4: ("the blends alone (no stores but one the compiler cannot drop)", [
        ("    store_vec(o + head + kVec * j, v);",
         "    if (v[0] + v[1] + v[2] + v[3] == 1234.5f) "
         "store_vec(o + head + kVec * j, v);")]),
    5: ("stores only, no table staging", [
        ("    store_vec(o + head + kVec * j, v);",
         "    if (SPLIT == 5) for (float& e : v) e = 1.0f;\n"
         "    store_vec(o + head + kVec * j, v);"),
        ("        cp_async16(s_table + i, table + i);", ""),
        ("      cp_async4(s_table + i, table + i);", "")]),
    6: ("variant: 128 threads a block", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    7: ("variant: 512 threads a block", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
}


def k1_design(csrc: Path) -> str:
    """``"wave"`` for the one-wave row pipeline of K1-fwd, else ``"rows"``
    (a block per row)."""
    text = (csrc / "cpb_table.cu").read_text()
    return "wave" if "cp.async" in text else "rows"


def compare_k1(parent: Path) -> int:
    """K1-fwd, f32 and bf16 store: earlier against current sources on
    phase 2e's divisor-1 inputs (R = 4608, side 50, clipped rows), raw C
    calls timed with CUDA events (earlier, current, current, earlier), each
    version bitwise against the plain version, its compile-time splits and
    its ptxas lines."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import build, cpb

    current = ROOT / SUB
    designs = {"earlier": k1_design(parent), "current": k1_design(current)}
    print(f"designs: {designs}")
    splits = {"rows": K1_ROWS_SPLIT, "wave": K1_WAVE_SPLIT}
    src = ("cpb_table.cu",)
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"k1_{ver}", csrc, src, (), ()))
        jobs += [(f"k1_{ver}_split{n}", csrc, src, patches, (f"-DSPLIT={n}",))
                 for n, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        lines = cs.kernel_ptxas(log, cs.K1_FWD_KERNELS, cs.k1_instance)
        if "split" not in name:
            print(f"{name} ptxas:\n  " + "\n  ".join(lines))
            print(f"{name} SASS:\n  " + "\n  ".join(
                sass_ops(OUT / name / "lib.so", "cpb_table_interp_fwd")))
        elif splits[designs[name.split("_")[1]]][int(
                name.split("split")[1])][0].startswith("variant"):
            print(f"{name} ptxas: " + " | ".join(lines))
    libs = {}
    for name, _ in built:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.dmlt_cpb_table_interp_fwd.argtypes = list(
            build.SIGNATURES["dmlt_cpb_table_interp_fwd"])
        libs[name] = lib

    dev = torch.device("cuda")
    c = cs.opt_in_table_cases(cpb, dev)[1]
    table, taps, fracs = c["table"], c["taps"], c["fracs"]
    R, side = taps.shape[0], 50
    stream = torch.cuda.current_stream().cuda_stream
    for dt in (torch.float32, torch.bfloat16):
        store = str(dt)[6:]
        out = torch.empty(R, side, side, dtype=dt, device=dev)
        want = cpb.table_interp_reference(table, taps, fracs, side,
                                          out_dtype=dt)
        bms, by = cs.table_bounds(table, taps, side, out.element_size())[0]
        print(f"[K1-fwd {store} store] R={R} side={side} "
              f"tn={table.shape[0]}: bound {bms:.4f} ms by {by} | "
              f"{cs.card_line()}")

        def run(name):
            fn = libs[name].dmlt_cpb_table_interp_fwd
            args = (table.data_ptr(), *table.shape, taps.data_ptr(),
                    fracs.data_ptr(), out.data_ptr(),
                    int(dt == torch.bfloat16), R, side, stream)
            return lambda: fn(*args)

        for ver in ("earlier", "current"):
            out.zero_()
            assert run(f"k1_{ver}")() == 0
            torch.cuda.synchronize()
            print(f"[K1-fwd {store} store] {ver} ({designs[ver]}): bitwise "
                  f"equal to the plain version {torch.equal(out, want)}")
        ms = {}
        for ver in ("earlier", "current", "current", "earlier"):
            ms.setdefault(ver, []).append(cs.cuda_ms(run(f"k1_{ver}"), 50))
        print(f"[K1-fwd {store} store] ms: " + ", ".join(
            f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
            for ver, ts in ms.items()) + f" | {cs.card_line()}")
        for ver in ("earlier", "current"):
            for n, (what, _) in splits[designs[ver]].items():
                t = [cs.cuda_ms(run(f"k1_{ver}_split{n}"), 50)
                     for _ in range(2)]
                print(f"[K1-fwd {store} store] {ver} split {n}, {what}: ms "
                      + " / ".join(f"{x:.4f}" for x in t))
    return 0


# compile-time splits (SPLIT k) of K5-fwd's block-per-row design (PR 5)
_K5_ROWS_OUT = ("    store(o + i, __fadd_rn(__fmul_rn(a, gx), "
                "__fmul_rn(b, fx)));")
K5_ROWS_SPLIT = {
    1: ("stores only: a constant, scalar stores", [
        (_K5_ROWS_OUT, "    store(o + i, SPLIT == 1 ? 1.0f : "
         "__fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));")]),
    2: ("stores only: a constant, 4-output vector stores (16 B f32, 8 B "
        "bf16)", [
            ("  Out* o = out + static_cast<size_t>(r) * side * side;\n",
             "  Out* o = out + static_cast<size_t>(r) * side * side;\n"
             "  if (SPLIT == 2) {\n"
             "    for (int j = threadIdx.x; j < side * side / 4; "
             "j += blockDim.x) {\n"
             "      if constexpr (sizeof(Out) == 4) {\n"
             "        reinterpret_cast<float4*>(o)[j] = "
             "make_float4(1.0f, 1.0f, 1.0f, 1.0f);\n"
             "      } else {\n"
             "        reinterpret_cast<uint2*>(o)[j] = "
             "make_uint2(0x3f803f80u, 0x3f803f80u);\n"
             "      }\n"
             "    }\n"
             "    return;\n"
             "  }\n")]),
    3: ("the taps alone (no stores but one the compiler cannot drop)", [
        (_K5_ROWS_OUT, "    const float val = __fadd_rn(__fmul_rn(a, gx), "
         "__fmul_rn(b, fx));\n    if (val == 1234.5f) store(o + i, val);")]),
    4: ("the taps at unit stride (as at divisor 1: every fetched sector "
        "useful)", [
            ("    const float* t = table + static_cast<size_t>(y0 + d * y) * "
             "tn_cols +\n                     x0 + d * x;",
             "    const float* t = table + static_cast<size_t>(y0 + y) * "
             "tn_cols +\n                     x0 + x;")]),
}
# compile-time splits of K5-fwd's design on x-phase pair planes (PR 12),
# and its variants
_K5_PAIRS_LAUNCH = (
    "    strided_pairs_kernel<<<blocks, kPairThreads, 0, s>>>(\n"
    "        table, tn_rows, tn_cols, d, static_cast<float2*>(scratch));")
_K5_ROW_LAUNCH = "  strided_row_kernel<Out, kPairs><<<rows, kThreads, 0, s>>>("
_K5_STORE = "    if (i0 + t < n) store(o + i0 + t, w.at(y, x));"
_K5_DISPATCH = (
    "template <typename Out>\n"
    "int launch(const float* table, int tn_rows, int tn_cols, const int* taps,\n"
    "           const float* fracs, Out* out, int rows, int side, int d,\n"
    "           void* scratch, cudaStream_t s) {")
K5_PAIRS_SPLIT = {
    1: ("stores only: a constant (the first kernel still runs)", [
        (_K5_STORE, "    if (i0 + t < n) store(o + i0 + t, "
                    "SPLIT == 1 ? 1.0f : w.at(y, x));")]),
    2: ("the taps alone (no stores but one the compiler cannot drop)", [
        (_K5_STORE, "    const float v = i0 + t < n ? w.at(y, x) : 0.0f;\n"
                    "    if (v == 1234.5f) store(o + i0 + t, v);")]),
    3: ("without the first kernel (the pair planes of an earlier call on "
        "the same scratch)", [
            (_K5_PAIRS_LAUNCH,
             "    static void* last = nullptr;\n"
             "    if (!(SPLIT == 3 && scratch == last))\n" + _K5_PAIRS_LAUNCH
             + "\n    last = scratch;")]),
    4: ("the first kernel alone (no main kernel)", [
        (_K5_ROW_LAUNCH, "  if (SPLIT != 4) " + _K5_ROW_LAUNCH.strip())]),
    5: ("variant: 256 threads a row", [
        ("constexpr int kThreads = 128; ", "constexpr int kThreads = 256; ")]),
    6: ("variant: the output loop not unrolled", [
        ("#pragma unroll 4\n  for (int i0 = 0;",
         "#pragma unroll 1\n  for (int i0 = 0;")]),
    7: ("variant: the table as it is at every divisor (no pair planes)", [
        ("inline bool uses_pairs(int d) { return d >= 3; }",
         "inline bool uses_pairs(int d) { return false; }")]),
    8: ("variant: the pair planes at d = 2 too", [
        ("inline bool uses_pairs(int d) { return d >= 3; }",
         "inline bool uses_pairs(int d) { return d >= 2; }")]),
    9: ("variant: a class's band of plane rows staged in shared memory "
        "(tools/k5_band_stage.cuh)", [
            (_K5_DISPATCH,
             f'#include "{ROOT / "tools" / "k5_band_stage.cuh"}"\n\n'
             + _K5_DISPATCH + "\n  if (const int e = band_launch(table, "
             "tn_rows, tn_cols, taps, fracs, out, rows, side, d, s); "
             "e >= 0) {\n    return e;\n  }")]),
}


def k5_design(csrc: Path) -> str:
    """``"pairs"`` for the design on x-phase pair planes (PR 12), else
    ``"rows"`` (a block per row on the table as it is, PR 5)."""
    text = (csrc / "cpb_table_strided.cu").read_text()
    return "pairs" if "strided_pairs_kernel" in text else "rows"


def compare_k5(parent: Path) -> int:
    """K5-fwd, f32 and bf16 store, at divisors 2 and 4: earlier against
    current sources on phase 2e's inputs, raw C calls timed with CUDA
    events (earlier, current, current, earlier), each version bitwise
    against the plain version, its compile-time splits, its ptxas lines
    and SASS op counts."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    current = ROOT / SUB
    designs = {"earlier": k5_design(parent), "current": k5_design(current)}
    print(f"designs: {designs}")
    splits = {"rows": K5_ROWS_SPLIT, "pairs": K5_PAIRS_SPLIT}
    src = ("cpb_table_strided.cu",)
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"k5_{ver}", csrc, src, (), ()))
        jobs += [(f"k5_{ver}_split{n}", csrc, src, patches, (f"-DSPLIT={n}",))
                 for n, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        lines = list(ptxas_lines(log))
        if "split" not in name:
            print(f"{name} ptxas:\n  " + "\n  ".join(lines))
            print(f"{name} SASS:\n  " + "\n  ".join(
                sass_ops(OUT / name / "lib.so", "strided")))
        elif splits[designs[name.split("_")[1]]][int(
                name.split("split")[1])][0].startswith("variant"):
            print(f"{name} ptxas: " + " | ".join(lines))
    libs = {}
    for name, _ in built:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        # PR 12's entry takes a scratch pointer before the stream
        scratch_arg = hasattr(lib, "dmlt_cpb_table_strided_fwd_scratch")
        lib.dmlt_cpb_table_strided_fwd.argtypes = (
            [P, I, I, P, P, P, I, I, I, I] + [P] * (1 + scratch_arg))
        if scratch_arg:
            lib.dmlt_cpb_table_strided_fwd_scratch.argtypes = [I, I, I]
        libs[name] = (lib, scratch_arg)

    dev = torch.device("cuda")
    cases = cs.opt_in_table_cases(cpb, dev)
    side = 50
    stream = torch.cuda.current_stream().cuda_stream
    for d in (2, 4):
        table, taps, fracs = (cases[d][n] for n in ("table", "taps", "fracs"))
        R = taps.shape[0]
        for dt in (torch.float32, torch.bfloat16):
            label = f"[K5-fwd divisor {d} {str(dt)[6:]} store]"
            out = torch.empty(R, side, side, dtype=dt, device=dev)
            want = cpb.table_interp_reference(table, taps, fracs, side, d,
                                              out_dtype=dt)
            bms, by = cs.table_bounds(table, taps, side,
                                      out.element_size())[0]
            print(f"{label} R={R} side={side} tn={table.shape[0]}: bound "
                  f"{bms:.4f} ms by {by} | {cs.card_line()}")

            # one scratch for every library that takes one, as large as
            # the largest asks (split 3 reuses what an earlier call left)
            scratch = torch.empty(max([
                lib.dmlt_cpb_table_strided_fwd_scratch(*table.shape, d)
                for lib, scratch_arg in libs.values() if scratch_arg] + [0]),
                dtype=torch.uint8, device=dev)

            def run(name):
                lib, scratch_arg = libs[name]
                fn = lib.dmlt_cpb_table_strided_fwd
                args = [table.data_ptr(), *table.shape, taps.data_ptr(),
                        fracs.data_ptr(), out.data_ptr(),
                        int(dt == torch.bfloat16), R, side, d]
                if scratch_arg:
                    args.append(scratch.data_ptr())
                args.append(stream)
                return lambda: fn(*args)

            for ver in ("earlier", "current"):
                out.zero_()
                assert run(f"k5_{ver}")() == 0
                torch.cuda.synchronize()
                print(f"{label} {ver} ({designs[ver]}): bitwise equal to the "
                      f"plain version {torch.equal(out, want)}")
            ms = {}
            for ver in ("earlier", "current", "current", "earlier"):
                ms.setdefault(ver, []).append(cs.cuda_ms(run(f"k5_{ver}"), 50))
            print(f"{label} ms: " + ", ".join(
                f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
                for ver, ts in ms.items()) + f" | {cs.card_line()}")
            for ver in ("earlier", "current"):
                for n, (what, _) in splits[designs[ver]].items():
                    t = [cs.cuda_ms(run(f"k5_{ver}_split{n}"), 50)
                         for _ in range(2)]
                    print(f"{label} {ver} split {n}, {what}: ms "
                          + " / ".join(f"{x:.4f}" for x in t))
        torch.cuda.empty_cache()
    return 0


# compile-time splits (SPLIT k) of K7-fwd's design with f32 FMA products
# and a point a thread in the bias (PR 6): every split build guards the
# four phases, and phase k runs only in split k (the staging and the out
# store stay)
_K7_FMA_GUARDS = [
    ("    for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {\n"
     "      const int kk = i / kQT;\n      const int cc = i - kk * kQT;\n"
     "      const float fx",
     "    for (int i = threadIdx.x; SPLIT == 1 && i < nrows * kQT; "
     "i += kThreads) {\n      const int kk = i / kQT;\n"
     "      const int cc = i - kk * kQT;\n      const float fx"),
    ("    // sim = k q^T + bias, a 10 x 4 tile per thread\n    {",
     "    // sim = k q^T + bias, a 10 x 4 tile per thread\n"
     "    if (SPLIT == 2) {"),
    ("    for (int kk = part; kk < nrows; kk += 4) mx = ",
     "    for (int kk = part; SPLIT == 3 && kk < nrows; kk += 4) mx = "),
    ("    for (int kk = part; kk < nrows; kk += 4) {\n"
     "      const float e = expf(",
     "    for (int kk = part; SPLIT == 3 && kk < nrows; kk += 4) {\n"
     "      const float e = expf("),
    ("      for (int kk = part; kk < nrows; kk += 4) s_p[kk * kLdp + c] "
     "/= row_sum;",
     "      for (int kk = part; SPLIT == 3 && kk < nrows; kk += 4) "
     "s_p[kk * kLdp + c] /= row_sum;"),
    ("    for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {\n"
     "      const int kk = nk ? i % nrows : i / kQT;\n"
     "      const int cc = nk ? i / nrows : i % kQT;\n"
     "      const int n = n0 + cc;",
     "    for (int i = threadIdx.x; SPLIT == 3 && i < nrows * kQT; "
     "i += kThreads) {\n      const int kk = nk ? i % nrows : i / kQT;\n"
     "      const int cc = nk ? i / nrows : i % kQT;\n"
     "      const int n = n0 + cc;"),
    ("    if (dg * 4 < D) {\n      for (int kk = 0; kk < nrows; ++kk) {",
     "    if (SPLIT == 4 && dg * 4 < D) {\n"
     "      for (int kk = 0; kk < nrows; ++kk) {")]
K7_FMA_SPLIT = {
    1: ("the bias pass alone", _K7_FMA_GUARDS),
    2: ("sim (k q^T) alone", _K7_FMA_GUARDS),
    3: ("the softmax and the map store alone", _K7_FMA_GUARDS),
    4: ("PV alone", _K7_FMA_GUARDS),
    5: ("the staging and the out store alone", _K7_FMA_GUARDS),
}
# compile-time splits of K7-fwd's design with 3xTF32 products and the
# four-point bias (PR 12), at one kv chunk: every split build guards the
# phases; split k drops phase k, split 5 keeps the bias MLP alone
_K7_MMA_GUARDS = [
    ("  for (int f = 0; f < NT * nmt; ++f) {",
     "  for (int f = 0; SPLIT != 1 && f < NT * nmt; ++f) {"),
    ("        for (int nt = 0; nt < NT; ++nt) mma_3xtf32(P[nt][mt], A, b[nt]);",
     "        for (int nt = 0; nt < NT; ++nt) {\n"
     "          if (SPLIT == 7) mma_tf32(P[nt][mt], A.hi, b[nt].hi);\n"
     "          else if (SPLIT != 2 && SPLIT != 5) "
     "mma_3xtf32(P[nt][mt], A, b[nt]);\n        }"),
    ("          if (mt * 16 < K) {",
     "          if (SPLIT != 3 && SPLIT != 5 && mt * 16 < K) {"),
    ("      store_map_and_drop(P, attn, nk, bh, 0, K, n0, K, N, seed_mix, "
     "inner0,",
     "      if (SPLIT != 3 && SPLIT != 5) "
     "store_map_and_drop(P, attn, nk, bh, 0, K, n0, K, N, seed_mix, inner0,"),
    ("      chunk_pv(P, s_v, ldv, ndt, K, o, os);",
     "      if (SPLIT != 4 && SPLIT != 5) chunk_pv(P, s_v, ldv, ndt, K, o, os);"),
    ("              mma_3xtf32(o[nt][dt], os[nt][dt], A, b[nt]);",
     "              if (SPLIT == 6) mma_tf32(o[nt][dt], A.hi, b[nt].hi);\n"
     "              else mma_3xtf32(o[nt][dt], os[nt][dt], A, b[nt]);"),
    ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
     "#if SPLIT == 8\n  uint32_t r;\n"
     "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
     "  return r;\n#else\n"
     "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n#endif"),
    ("          b[nt].set(0, odd ? o0 : e0);\n"
     "          b[nt].set(1, odd ? o1 : e1);",
     "          b[nt].set(0, SPLIT == 9 ? P[nt][mt][2 * h] : odd ? o0 : e0);\n"
     "          b[nt].set(1, SPLIT == 9 ? P[nt][mt][2 * h + 1] "
     ": odd ? o1 : e1);"),
    ("        if (threshold != 0u) {",
     "        if (SPLIT != 10 && threshold != 0u) {")]
K7_MMA_SPLIT = {
    1: ("without the bias MLP", _K7_MMA_GUARDS),
    2: ("without the sim products", _K7_MMA_GUARDS),
    3: ("without the softmax, the map store and the dropout", _K7_MMA_GUARDS),
    4: ("without PV", _K7_MMA_GUARDS),
    5: ("the bias MLP alone (no products, softmax or PV)", _K7_MMA_GUARDS),
    6: ("PV in one TF32 pass (timing only)", _K7_MMA_GUARDS),
    7: ("sim in one TF32 pass (timing only)", _K7_MMA_GUARDS),
    8: ("variant: operands split by cvt.rna.tf32.f32",
        _K7_MMA_GUARDS),
    9: ("PV's B fragments without the shuffles (timing only)",
        _K7_MMA_GUARDS),
    10: ("without the dropout hash", _K7_MMA_GUARDS),
    11: ("variant: PV's small terms added into the large ones' registers",
         _K7_MMA_GUARDS + [(
             "              else mma_3xtf32(o[nt][dt], os[nt][dt], A, b[nt]);",
             "              else mma_3xtf32(o[nt][dt], A, b[nt]);")]),
}


def k7_design(csrc: Path) -> str:
    """``"mma"`` for the design with 3xTF32 tensor-core products, else
    ``"fma"``."""
    text = (csrc / "fused_exact.cu").read_text()
    return "mma" if "mma_3xtf32" in text else "fma"


def k7_cases(dev) -> dict:
    """Inputs at phase 2f's two K7 shapes, drawn from seed 12: the
    teacher's (q [32, 2500, 64] pre-scaled, k, v [32, 144, 64], the 50 x 50
    query grid, kv points within the 12 x 12 grid's bound) and the 1-D
    attention's (q [16, 2501, 16], k, v [16, 625, 16], coordinates with a
    zero y and a zero y row of w1)."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import cpb

    gen = torch.Generator().manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    kv_bound = cpb.kv_bound_2d(4.0, 12, 12)
    n_q = 2501
    w1d = list(cs.mlp_weights(1, gen, dev))
    w1d[0][1].zero_()
    return {
        "2-D": (rnd(32, 2500, 64, scale=64 ** -0.5), rnd(32, 144, 64),
                rnd(32, 144, 64), cs.normalized_grid_flat(50, dev),
                ((torch.rand(32, 144, 2, generator=gen) * 2 - 1)
                 * kv_bound).to(dev), *cs.mlp_weights(1, gen, dev)),
        "1-D": (rnd(16, n_q, 16, scale=0.25), rnd(16, 625, 16),
                rnd(16, 625, 16),
                torch.stack([torch.linspace(-1, 1, n_q, device=dev),
                             torch.zeros(n_q, device=dev)], dim=-1),
                torch.stack([(torch.rand(16, 625, generator=gen) * 2 - 1)
                             .to(dev), torch.zeros(16, 625, device=dev)],
                            dim=-1), *w1d)}


def compare_k7(parent: Path) -> int:
    """K7-fwd in both layouts: earlier against current sources at phase
    2f's shapes, raw C calls timed with CUDA events (earlier, current,
    current, earlier), out and map of the two versions against each other,
    "nk" against "kn" transposed and two calls bitwise, the compile-time
    splits at the teacher's shape, ptxas lines and HMMA / FFMA counts."""
    import torch

    import chip_smoke as cs
    from disentangled_multimodal_learning_tpu_torch.ops import build
    from disentangled_multimodal_learning_tpu_torch.ops.fused_table import (
        _dropout_args)

    current = ROOT / SUB
    designs = {"earlier": k7_design(parent), "current": k7_design(current)}
    print(f"designs: {designs}")
    splits = {"fma": K7_FMA_SPLIT, "mma": K7_MMA_SPLIT}
    src = ("fused_exact.cu",)
    jobs = []
    for ver, csrc in (("earlier", parent), ("current", current)):
        jobs.append((f"k7_{ver}", csrc, src, (), ()))
        jobs += [(f"k7_{ver}_split{n}", csrc, src, patches, (f"-DSPLIT={n}",))
                 for n, (_, patches) in splits[designs[ver]].items()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: nvcc_build(*j), jobs))
    for name, log in built:
        lines = list(ptxas_lines(log))
        if "split" not in name:
            print(f"{name} ptxas:\n  " + "\n  ".join(lines))
            print(f"{name} SASS:\n  " + "\n  ".join(cs.sass_counts(
                OUT / name / "lib.so", ("fused_exact_fwd",),
                cs.RESIDENT)))
            print(f"{name} SASS opcodes (most frequent first):\n  "
                  + "\n  ".join(sass_histogram(OUT / name / "lib.so",
                                                "fused_exact_fwd")))
        elif splits[designs[name.split("_")[1]]][int(
                name.split("split")[1])][0].startswith("variant"):
            print(f"{name} ptxas: " + " | ".join(lines))
    libs = {}
    for name, _ in built:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("dmlt_fused_exact_fwd", "dmlt_fused_exact_fwd_smem"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
        libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, args in k7_cases(dev).items():
        BH, N, D = args[0].shape
        K = args[1].shape[1]
        for rate in ((0.0, 0.1) if label == "2-D" else (0.1,)):
            threshold, scale = _dropout_args(rate)
            bms, by = cs.k7_bounds(BH, N, K, D)[0]
            tag = f"[K7-fwd {label} BH={BH} N={N} K={K} D={D} rate {rate}]"
            print(f"{tag} bound {bms:.4f} ms by {by} | {cs.card_line()}")
            res = {}
            for nk in (1, 0):
                lay = "nk" if nk else "kn"
                out = torch.empty_like(args[0])
                attn = torch.empty((BH, N, K) if nk else (BH, K, N),
                                   device=dev)

                def run(name, out=out, attn=attn, nk=nk):
                    fn = libs[name].dmlt_fused_exact_fwd
                    a = ([t.data_ptr() for t in args] + [out.data_ptr(),
                         attn.data_ptr(), BH, K, N, D, nk, 4321, threshold,
                         scale, stream])
                    return lambda: fn(*a)

                for ver in ("earlier", "current"):
                    assert run(f"k7_{ver}")() == 0
                    torch.cuda.synchronize()
                    res[(ver, lay)] = (out.clone(), attn.clone())
                assert run("k7_current")() == 0
                torch.cuda.synchronize()
                same2 = (torch.equal(out, res[("current", lay)][0])
                         and torch.equal(attn, res[("current", lay)][1]))
                e = [(a - b).abs().max().item() for a, b in
                     zip(res[("current", lay)], res[("earlier", lay)])]
                print(f"{tag} {lay}: current vs earlier max abs out "
                      f"{e[0]:.3e}, attn {e[1]:.3e}; two calls bitwise "
                      f"{same2}")
                ms = {}
                iters = 10 if label == "2-D" else 5
                for ver in ("earlier", "current", "current", "earlier"):
                    ms.setdefault(ver, []).append(
                        cs.cuda_ms(run(f"k7_{ver}"), iters))
                print(f"{tag} {lay} ms: " + ", ".join(
                    f"{ver} " + " / ".join(f"{t:.4f}" for t in ts)
                    for ver, ts in ms.items()) + f" | {cs.card_line()}")
                if label == "2-D" and rate > 0:
                    for ver in ("earlier", "current"):
                        for n, (what, _) in splits[designs[ver]].items():
                            t = [cs.cuda_ms(run(f"k7_{ver}_split{n}"), iters)
                                 for _ in range(2)]
                            print(f"{tag} {lay} {ver} split {n}, {what}: ms "
                                  + " / ".join(f"{x:.4f}" for x in t))
                del out, attn
            for ver in ("earlier", "current"):
                (o1, a1), (o2, a2) = res[(ver, "nk")], res[(ver, "kn")]
                print(f"{tag} {ver}: nk and kn bitwise equal (out, attn "
                      f"transposed) {torch.equal(o1, o2) and torch.equal(a1, a2.transpose(1, 2))}")
            del res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

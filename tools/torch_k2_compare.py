#!/usr/bin/env python3
"""Kernels of the PyTorch port against an earlier version of their
sources, on one NVIDIA GPU: the exact-CPB kernels K2 (``--kernel k2``, the
default) or the fused table attention K6 with K7-bwd (``--kernel k6``).

    mkdir -p build/k2_parent && git archive <commit> \\
        disentangled_multimodal_learning_tpu_torch/csrc | tar -x -C build/k2_parent
    python3 tools/torch_k2_compare.py --parent build/k2_parent [--kernel k6]

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
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
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
    ap.add_argument("--kernel", choices=("k2", "k6"), default="k2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_compare: no CUDA device", file=sys.stderr)
        return 2
    parent = args.parent.resolve() / SUB
    print(cs.card_line())
    build.kernels()
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


def load_k6(name: str):
    from disentangled_multimodal_learning_tpu_torch.ops import build

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for entry in K6_ENTRIES:
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = list(build.SIGNATURES[entry])
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
    libs = {name: load_k6(name) for name, _ in built}
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
    for rate in (0.0, 0.1):
        seed = 99
        thr, scale = fused_table._dropout_args(rate)
        bufs = {"earlier": buffers(), "current": buffers()}
        lib_of = {"earlier": libs["k6_earlier"], "current": cur}
        split_bufs = buffers()
        for n in K6_SPLIT:
            bufs[f"split{n}"] = split_bufs
            lib_of[f"split{n}"] = libs[f"k6_split{n}"]

        def fwd(ver):
            b, lib = bufs[ver], lib_of[ver]
            return lambda: lib.dmlt_fused_table_fwd(
                *ptr(q, k, v, table), table.shape[0], table.shape[1],
                *ptr(taps, fracs, b["out"], b["attn"]), BH, K, N, D, side,
                seed, thr, scale, stream)

        def attn_bwd(ver):
            b, lib = bufs[ver], lib_of[ver]
            return lambda: lib.dmlt_fused_table_bwd(
                *ptr(q, k, v, bufs["current"]["attn"], g_out, g_attn, b["dq"],
                     b["dkv"], b["ds"], b["part"]), BH, K, N, D, splits,
                seed, thr, scale, stream)

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


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The exact-CPB kernels K2-fwd and K2-bwd of the PyTorch port against an
earlier version of their sources, on one NVIDIA GPU.

    mkdir -p build/k2_parent && git archive <commit> \\
        disentangled_multimodal_learning_tpu_torch/csrc | tar -x -C build/k2_parent
    python3 tools/torch_k2_compare.py --parent build/k2_parent

``--parent`` is a directory holding an earlier
``disentangled_multimodal_learning_tpu_torch/csrc`` (``build/`` is ignored
by git).  The script builds the port's kernels as the package does, the
earlier ``cpb_exact.cu`` and ``cpb_exact_bwd.cu`` into a library of their
own, and, for both versions of K2-bwd, two copies patched at compile time:
one without the weight-gradient sums, one with only them (the other phases
skipped), all under ``build/k2_compare/``.  Then, at the teacher's shape
(32 x 144 x 2500, O = 1) and the 1-D attention's (16 x 625 x 2501, O = 2),
on the inputs ``chip_smoke.py`` builds for its phases 2 and 2f:

- whether the two K2-fwd give bitwise-equal biases, in both layouts;
- K2-fwd and K2-bwd of both versions, in both layouts, timed with CUDA
  events in the order earlier, current, current, earlier;
- the split of both K2-bwd: whole, without the weight-gradient sums, only
  them.

It prints the card's name and power limit first, the ptxas lines of every
build, and, per K2 kernel of the current library, its FFMA count beside
its spill stores (and the stack slots they write) and spill loads in the
SASS.  It checks no result against a plain version: that is
``chip_smoke.py``'s job.
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


def nvcc_build(name: str, csrc: Path, sources, patches=(), defines=()):
    """Compile ``sources`` of ``csrc`` (patched) into one library."""
    from disentangled_multimodal_learning_tpu_torch.ops import build

    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    objs, log = [], []
    for src in sources:
        text = (csrc / src).read_text()
        for a, b in patches:
            if a not in text:
                raise RuntimeError(f"{name}: {src} lacks the patch point "
                                   f"{a.strip()!r}")
            text = text.replace(a, b)
        (work / src).write_text(text)
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
    from disentangled_multimodal_learning_tpu_torch.ops import build, cpb

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_compare: no CUDA device", file=sys.stderr)
        return 2
    parent = args.parent.resolve() / SUB
    current = ROOT / SUB
    print(cs.card_line())
    build.kernels()
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


if __name__ == "__main__":
    sys.exit(main())

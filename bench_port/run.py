"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m bench_port.run ...``) from the root of a checkout that
holds the port (``disentangled_multimodal_learning_tpu_torch``) and one
NVIDIA card.  The last line of standard output is the result's JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error and the line's last key.  Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run exits with another
code than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every compile cache at a fixed path inside the checkout (the port's
    # kernels build into build/torch_kernels/ there by themselves)
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" /
                                             "torch_extensions")

    from bench_port import harness

    manifest = harness.load_manifest(REPO)
    cell = harness.load_cell(args.workload, manifest)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(cell, manifest, args.seed, args.seconds,
                            bool(args.trace), "cuda")
    found = harness.forbidden_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return 3
    # peak memory and launch counts on lines of their own, not metrics
    print(f"memory_peak_bytes {line['device']['memory_peak_bytes']}")
    if "launches" in line:
        print(f"launches {json.dumps(line['launches'], sort_keys=True)}")
    sys.stdout.flush()
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

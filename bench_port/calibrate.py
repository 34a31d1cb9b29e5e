"""Readings that the limits of ``workloads/<cell>.json`` are set from, at
the cell's own size on the card: for each seed, the program's compared
numbers (as a run's set-up and a window of ``--window`` seconds leave
them), the control's (the reference in the program's place with float32
products in TF32, the nearest precision below the configuration's) and,
for a training cell, a planted fault's (half of each batch left out).
One JSON line a seed.  The benchmark's own runs never run this.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--window 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def readings(cell, seed: int, window: float, device="cuda") -> dict:
    from bench_port import harness

    t0 = time.perf_counter()
    session = cell.driver.start(cell, seed, device)
    harness.timed_window(session, window)
    session.release()
    out = {"seed": seed, "program": session.check()}
    if hasattr(session, "program_details"):
        out["program_details"] = session.program_details()
    out.update(control=session.control(), faults=session.faults())
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--window", type=float, default=2.0)
    args = p.parse_args(argv)
    from bench_port import harness

    manifest = harness.load_manifest(REPO)
    cell = harness.load_cell(args.workload, manifest)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **readings(cell, seed, args.window)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

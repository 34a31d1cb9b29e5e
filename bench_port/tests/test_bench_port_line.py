"""A whole run on the CPU at a small width (the look for a card skipped):
the result line's keys, in the contract's shape."""

import json
import subprocess
import sys
import time

import pytest

from bench_port import harness

from conftest import SMALL


@pytest.mark.parametrize("name,trace", [("teacher_train_k4", False),
                                        ("student_eval_b16", True)])
def test_result_line(manifest, name, trace):
    cell = harness.load_cell(name, manifest, SMALL)
    t0 = time.perf_counter()
    line = harness.run_cell(cell, manifest, 2 ** 32 + 3, 1.0, trace, "cpu",
                            setup_clock=lambda: time.perf_counter() - t0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in harness.metrics_of(name, manifest, trace)}
    got = set(line["metrics"])
    if trace:  # the device metrics have nothing to read on the CPU
        assert got <= want and {"host_ms_per_batch", "eval_mfu"} <= got
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert got == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "run.py"), "--workload",
         "teacher_train_k4", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout == ""

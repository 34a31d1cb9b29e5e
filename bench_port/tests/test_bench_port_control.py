"""The control, on the card: the reference in the program's place with
float32 products in TF32, the nearest precision below the
configuration's, comes out not correct against each cell's limits.  At
the cell's own size and window (a training cell compares the window's
last chunk), one seed (``calibrate.py`` reads a dozen)."""

import math

import pytest

from bench_port import calibrate, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teacher_train_k4", "student_eval_b16",
                                  "student_train_k4", "teacher_eval_b16"])
def test_control_fails_a_limit(manifest, card, name):
    cell = harness.load_cell(name, manifest)
    r = calibrate.readings(cell, 2 ** 31 + 99, manifest["run_seconds"], card)
    limits = cell.traffic["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(not math.isfinite(v) or v > limits[k]
               for k, v in r["control"].items()), r

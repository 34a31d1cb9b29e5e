"""Inputs and weights come from the seed alone."""

import numpy as np
import pytest
import torch

from bench_port import harness, inputs

from conftest import SMALL


@pytest.fixture(scope="module")
def settings(manifest):
    return harness.load_cell("teacher_train_k4", manifest, SMALL).settings


def _same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
               ("x_path10", "x_path20", "x_omic", "x_omic_tumor",
                "x_omic_immune", "label"))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3 * 2 ** 40 + 1, -7])
def test_pool_repeats(settings, seed):
    a = inputs.make_pool(settings, 3, 2, seed, "cpu")
    b = inputs.make_pool(settings, 3, 2, seed, "cpu")
    assert all(_same(x, y) for x, y in zip(a, b))
    c = inputs.make_pool(settings, 3, 2, seed + 1, "cpu")
    assert not _same(a[0], c[0])


def test_pool_shapes_and_batches_differ(settings):
    pool = inputs.make_pool(settings, 3, 4, 11, "cpu")
    b = pool[0]
    n, d = settings["fixdim"], settings["input_path_dim"]
    assert b.x_path10.shape == (4, n, d) and b.x_path10.dtype == np.float32
    assert b.x_path10.flags.c_contiguous and b.x_path20.flags.c_contiguous
    assert b.x_omic_tumor.shape == (4, settings["input_size_omic_tumor"])
    assert b.x_omic_immune.shape == (4, settings["input_size_omic_immune"])
    assert b.label.shape == (4, 12) and b.label.dtype == np.int32
    assert set(b.label[:, 5]) <= set(range(settings["label_dim"]))
    assert not np.array_equal(pool[0].x_path10, pool[1].x_path10)
    assert not np.array_equal(b.x_path10, b.x_path20)


def test_weights_repeat_and_load(manifest):
    cell = harness.load_cell("student_train_k4", manifest, SMALL)
    model = cell.reference.build(cell.settings, "cpu")
    a = inputs.make_state(model, 5, "cpu")
    b = inputs.make_state(model, 5, "cpu")
    c = inputs.make_state(model, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    model.load_state_dict(a, strict=True)
    ln = model.student10_net.encoder.norm.weight.detach()
    assert float((ln - 1).abs().max()) <= 0.1


def test_streams_are_distinct():
    s = inputs.streams(2 ** 31 + 1)
    assert len(set(s.values())) == 4
    assert all(0 <= v < 2 ** 63 for v in s.values())

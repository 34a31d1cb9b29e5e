"""Model flops and kernel rooflines against hand counts at the preset."""

import json

import pytest

from bench_port import harness
from bench_port.counts import kernels, model_flops, shapes


@pytest.fixture(scope="module")
def teacher():
    return json.loads((harness.ROOT / "configs" /
                       "teacher_diag2021.json").read_text())["settings"]


@pytest.fixture(scope="module")
def student():
    return json.loads((harness.ROOT / "configs" /
                       "student_diag2021.json").read_text())["settings"]


def test_attention_shapes(teacher):
    a = shapes.attn_shape(teacher)
    # a 50 x 50 grid, the 6 x 6 stride-4 offset conv -> 12 x 12 = 144 kv
    # points; the divisor-1 lattice of 139 points a side (PERF.md's K1)
    assert (a.n, a.side, a.grid, a.k, a.tn) == (2500, 50, 12, 144, 139)
    assert shapes.clusters(teacher) == 2


def test_attention_flops_by_hand(teacher):
    n, k, per_bag = 2500, 144, 0
    per_bag += 2 * n * 16 * 512          # to_q: 8 groups of 16 -> 64
    per_bag += 2 * 8 * 64 * k * 36       # the depthwise 6 x 6 offsets
    per_bag += 2 * 8 * k * 64 * 2        # the 1 x 1 offsets
    per_bag += 2 * 2 * k * 16 * 512      # to_k, to_v
    per_bag += 2 * 2 * 8 * k * n * 64    # sim and PV, 8 heads of 64
    per_bag += 2 * n * 512 * 128         # to_out
    table = 139 * 139 * 2 * (2 * 32 + 32 * 32 + 32)
    assert model_flops.attention(teacher, 4) == 4 * per_bag + table


def test_student_flops_by_hand(student):
    bags, n, d = 4, 2500, 128
    attn = model_flops.attention(student, bags)
    per_scale = (bags * 2 * n * 1024 * d + attn + bags * 2 * n * d
                 + bags * 2 * n * 2 * d + bags * 2 * 2 * d * 4)
    grams = 2 * 8 * bags * bags * 144 * n
    # one N x N distance matrix a bag and scale (the reference's single
    # bmm), plus the distances to the 2 centres
    dpc = bags * (2 * n * n * d + 2 * 2 * n * d)
    grad = 2 * (per_scale + grams)
    assert model_flops.forward(student, bags) == grad + 2 * dpc
    assert model_flops.train(student, bags) == 3 * grad + 2 * dpc


def test_student_forward_total_by_hand(student):
    # 16 bags at the preset: the distances are 2 scales x 16 bags x
    # 2 * 2500^2 * 128 = 51.2 GFLOP, counted once
    dist = 2 * 16 * 2 * 2500 ** 2 * 128
    assert dist == 51_200_000_000
    grad, nograd = model_flops.FAMILIES["student"](student, 16)
    assert nograd == dist + 2 * 16 * 2 * 2 * 2500 * 128


def test_kernel_bounds_by_hand(teacher):
    rows, values, table = 4 * 8 * 144, 4 * 8 * 144 * 2500, 139 * 139
    fwd_bytes = 4 * table + 16 * rows + 4 * values
    assert kernels.k1_fwd(teacher, 4) == pytest.approx(fwd_bytes / 3.35e12)
    bwd_bytes = 8 * table + 24 * rows + 4 * values
    assert kernels.k1_bwd(teacher, 4) == pytest.approx(bwd_bytes / 3.35e12)
    # K3: 2 N^2 C flops a bag at 67 TFLOP/s (PERF.md: 0.0955 ms at B 4)
    assert kernels.k3_knn(teacher, 4) == pytest.approx(
        4 * 2 * 2500 ** 2 * 128 / 67e12)
    assert kernels.k3_knn(teacher, 4) * 1e3 == pytest.approx(0.0955, 1e-3)
    assert kernels.k1_fwd(teacher, 4) * 1e3 == pytest.approx(0.0138, 1e-2)


def test_every_bound_has_kernel_names():
    assert set(kernels.LAUNCH_BOUNDS) == set(kernels.KERNEL_NAMES)

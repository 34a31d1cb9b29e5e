"""Model flops of the two-scale teacher and student, from a
configuration's shapes: every matmul, attention product, convolution and
MLP, 2 flops a multiply-add.  Elementwise work, softmax, normalisation and
``grid_sample`` count nothing.  A train step's backward counts 2x the
forward of the differentiable part, nothing recomputed; DPC-KNN's
distances run under ``no_grad`` and count in the forward only: the
model's one ``N x N`` distance matrix a bag (the kernels K3-knn and
K3-parent each work it out again, which ``counts/kernels.py`` counts, not
this) and the distances to the centres.

``forward(settings, bags)`` and ``train(settings, bags)`` give the flops
of one batch of ``bags`` bags."""

from __future__ import annotations

from .shapes import CPB_HID, DIM_HEAD, GROUPS, attn_shape, clusters


def _linear(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def attention(settings: dict, bags: int) -> int:
    """One ``DeformCrossAttention2D`` call over ``bags`` bags."""
    a = attn_shape(settings)
    od = a.inner // GROUPS
    per_bag = (
        _linear(a.n, a.dim // GROUPS, a.inner)            # to_q (grouped)
        + 2 * GROUPS * od * a.k * 6 * 6                   # depthwise offsets
        + _linear(GROUPS * a.k, od, 2)                    # offsets 1x1
        + 2 * _linear(a.k, a.dim // GROUPS, a.inner)      # to_k, to_v
        + 2 * 2 * a.inner // DIM_HEAD * a.k * a.n * DIM_HEAD  # sim and PV
        + _linear(a.n, a.inner, a.dim))                   # to_out
    mlp = 2 * (2 * CPB_HID + CPB_HID * CPB_HID + CPB_HID)
    if a.divisor > 0:
        cpb = a.tn * a.tn * mlp                           # the table, once
    else:
        cpb = bags * GROUPS * a.k * a.n * mlp             # every pair
    return bags * per_bag + cpb


def _maxnet(settings: dict, inputs: int) -> int:
    dims = [inputs, 64, 48, 32, int(settings["omic_dim"])]
    return sum(_linear(1, dims[i], dims[i + 1]) for i in range(4))


def _teacher(settings: dict, bags: int) -> tuple:
    """(differentiable forward flops, no-grad forward flops)."""
    n, din = int(settings["fixdim"]), int(settings["input_path_dim"])
    d = int(settings["path_dim"])
    labels = int(settings["label_dim"])
    per_scale = (
        bags * _linear(n, din, d)                         # _fc1
        + 2 * attention(settings, bags)
        + bags * _linear(n, 2 * d, d)                     # FusionNet
        + 2 * bags * (2 * _linear(n, d, d)                # MHA q and out
                      + 2 * _linear(1, d, d)              # k and v
                      + 2 * 2 * n * d                     # scores, PV
                      + _linear(1, d, d))                 # pooler
        + 2 * bags * _linear(1, d, d)                     # pooler1, pooler2
        + bags * _linear(1, 2 * d, labels))               # classifier
    omics = bags * (_maxnet(settings, int(settings["input_size_omic_tumor"]))
                    + _maxnet(settings,
                              int(settings["input_size_omic_immune"])))
    a = attn_shape(settings)
    maps = 2 * 2 * bags * bags * 8 * a.k * a.n            # cross-Grams
    return 2 * per_scale + omics + maps, 0


def _student(settings: dict, bags: int) -> tuple:
    n, din = int(settings["fixdim"]), int(settings["input_path_dim"])
    d = int(settings["path_dim"])
    labels = int(settings["label_dim"])
    c = clusters(settings)
    per_scale = (
        bags * _linear(n, din, d)                         # _fc1
        + attention(settings, bags)
        + bags * _linear(n, d, 1)                         # token score
        + bags * 2 * n * c * d                            # merge einsum
        + bags * _linear(1, 2 * d, labels))               # classifier
    a = attn_shape(settings)
    grams = 2 * 8 * bags * bags * a.k * a.n               # per scale
    dpc = bags * (2 * n * n * d                           # token distances
                  + 2 * c * n * d)                        # to the centres
    return 2 * (per_scale + grams), 2 * dpc


FAMILIES = {"teacher": _teacher, "student": _student}


def forward(settings: dict, bags: int) -> int:
    grad, nograd = FAMILIES[settings["mode"]](settings, bags)
    return grad + nograd


def train(settings: dict, bags: int) -> int:
    grad, nograd = FAMILIES[settings["mode"]](settings, bags)
    return 3 * grad + nograd

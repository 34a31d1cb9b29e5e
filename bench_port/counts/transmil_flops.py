"""TransMIL's flops and the Nystrom core's roofline, from a configuration's
shapes and the published widths (``reference/transmil.py``): every matmul,
landmark product and convolution, 2 flops a multiply-add; elementwise
work, softmax, the landmark means and normalisation count nothing.

A bag of ``N = fixdim`` patches is made square (``side = ceil(sqrt(N))``),
a cls token added (``S = side^2 + 1`` tokens), and the Nystrom core runs
on the sequence left-padded to ``n``, a multiple of the ``m`` landmarks.
One core call, per bag and head of ``D``: ``q k_l^T`` and ``(attn1 P)
(attn3 v)`` ``2 n m D`` each, ``q_l k^T`` and ``attn3 v`` the same,
``q_l k_l^T`` ``2 m^2 D``, ``attn1 P`` ``2 n m^2``, and the pseudo-inverse
``P``, ``iters`` steps of 4 products of ``m^3``.

``forward(settings, bags)`` and ``train(settings, bags)`` give the flops
of one batch, the backward at 2x the differentiable forward (the
projection head, which the loss does not read, only forward).
``core_bound(settings, bags)`` is the least time of one core call with its
backward (``counts/kernels.py bound``): its flops, 3x the forward's, and
its bytes, each of q, k, v, the output and their cotangents once."""

from __future__ import annotations

import math

from ..reference import transmil as ref
from .kernels import bound


def _linear(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def tokens(settings: dict) -> tuple:
    """``(side, S, n)``: the grid's side, the tokens with the cls token,
    and the core's padded sequence."""
    side = math.ceil(math.sqrt(int(settings["fixdim"])))
    s = side * side + 1
    return side, s, s + (ref.LANDMARKS - s % ref.LANDMARKS) % ref.LANDMARKS


def core_forward(settings: dict, bags: int) -> int:
    """One call of the Nystrom core over ``bags`` bags."""
    _, _, n = tokens(settings)
    m, d = ref.LANDMARKS, ref.DIM // ref.HEADS
    per_head = (8 * n * m * d + 2 * m * m * d + 2 * n * m * m
                + ref.PINV_ITERS * 4 * 2 * m ** 3)
    return bags * ref.HEADS * per_head


def core_bound(settings: dict, bags: int) -> float:
    """Seconds of one core call, forward and backward, at its bound."""
    _, s, _ = tokens(settings)
    nbytes = 8 * 4 * bags * s * ref.DIM  # q, k, v, out and cotangents, f32
    return bound(nbytes, 3 * core_forward(settings, bags))


def _flops(settings: dict, bags: int) -> tuple:
    """(differentiable forward flops, forward flops of the projection)."""
    side, s, _ = tokens(settings)
    n, din = int(settings["fixdim"]), int(settings["input_path_dim"])
    dim, d = ref.DIM, ref.DIM // ref.HEADS
    layer = (bags * _linear(s, dim, 3 * dim)                  # to_qkv
             + core_forward(settings, bags)
             + 2 * bags * ref.HEADS * s * d * ref.RES_KERNEL  # res_conv
             + bags * _linear(s, dim, dim))                   # to_out
    ppeg = 2 * bags * dim * side * side * sum(k * k for k in
                                              ref.PPEG_KERNELS)
    grad = (bags * _linear(n, din, dim) + 2 * layer + ppeg
            + bags * _linear(1, dim, int(settings["label_dim"])))
    return grad, bags * _linear(1, dim, int(settings["path_dim"]))


def forward(settings: dict, bags: int) -> int:
    return sum(_flops(settings, bags))


def train(settings: dict, bags: int) -> int:
    grad, projection = _flops(settings, bags)
    return 3 * grad + projection

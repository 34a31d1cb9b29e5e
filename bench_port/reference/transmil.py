"""Plain PyTorch reference of TransMIL (Shao et al., "TransMIL:
Transformer based Correlated Multiple Instance Learning for Whole Slide
Image Classification", NeurIPS 2021; github.com/szc19990412/TransMIL,
``models/TransMIL.py``, with the Nystrom layer of the ``nystrom_attention``
package it imports), its loss and one AdamW train step.

Written from the published code, not from the port: it imports nothing of
the port and nothing of JAX, so the program cannot move it.  Every tensor
is float32.  The caller sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``: the benchmark's comparison turns both
off, and its control (the nearest precision below the configuration's)
turns both on.

The model: ``Linear(1024, 512)`` + ReLU; the bag made square by appending
its own first tokens; a cls token; two pre-norm Nystrom layers (8 heads of
64, 256 landmarks, 6 pseudo-inverse iterations, a depthwise ``(33, 1)``
residual conv on the values, ``to_out`` and dropout 0.1) with the PPEG
(depthwise 7/5/3 convs on the token grid) between them; LayerNorm and the
cls token's classifier.  Departures from the published code, each the
port's, so that one state dict loads into both with ``strict=True``:

- every LayerNorm has ``eps`` 1e-6 (flax's, which the JAX package trained
  with) where ``nn.LayerNorm`` defaults to 1e-5;
- the repository's ``multimodal_projection`` head, ``Linear(512,
  path_dim)`` of the cls token, beside the classifier ``_fc2``; the loss
  does not read it, so it takes a zero gradient and only AdamW's decay;
- the sequence is zero-padded on the left to a multiple of the 256
  landmarks, the landmarks are the means of contiguous segments, and the
  pseudo-inverse's normaliser is the largest column sum times the largest
  row sum over the whole batch and every head (so a bag's result depends
  on its batch-mates): all three as the published Nystrom layer does;
- the Nystrom layer crops the left pad before ``to_out`` and its dropout
  (the published layer crops after both): ``to_out`` acts row by row, and
  the dropout draws its mask over a contiguous tensor of the sequence's
  own tokens, as the program draws it, so that a run seeded alike draws
  the same masks (on the card, a mask drawn over a strided view is
  another draw of the generator's numbers);
- training is the repository's diag2021 preset: AdamW (torch's default,
  bias corrections in float64) with weight decay and the cosine schedule
  per step, 4 bags a batch, where the paper trains with Lookahead-RAdam
  at 1 bag a batch;
- the loss is cross-entropy weighted by the diag2021 class weights,
  normalised by the summed weights of the batch's labels.

The dropout masks come from torch's global generator, layer 1 then layer
2, in the order of the program's forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
CLASS_COL = {"diag2021": 5, "grade": 4, "subtype": 7}
# the published widths (models/TransMIL.py; the Nystrom layer's defaults)
DIM, HEADS, LANDMARKS, PINV_ITERS, RES_KERNEL = 512, 8, 256, 6, 33
PPEG_KERNELS = (7, 5, 3)
DROPOUT = 0.1


def pinv(x, iters):
    """Moore-Penrose pseudo-inverse of ``x [..., m, m]`` by ``iters``
    cubic iterations from ``x^T / (max col sum * max row sum)``."""
    a = x.abs()
    z = x.transpose(-1, -2) / (a.sum(dim=-1).max() * a.sum(dim=-2).max())
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


class NystromAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, landmarks, iters, kernel,
                 dropout):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.landmarks, self.iters = landmarks, iters
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.res_conv = nn.Conv2d(heads, heads, (kernel, 1),
                                  padding=(kernel // 2, 0), groups=heads,
                                  bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b, n, _ = x.shape
        m, h = self.landmarks, self.heads
        pad = (m - n % m) % m
        x = F.pad(x, (0, 0, pad, 0))
        q, k, v = (t.reshape(b, -1, h, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        q = q * self.dim_head ** -0.5
        seg = (n + pad) // m
        q_land = q.reshape(b, h, m, seg, -1).sum(dim=3) / seg
        k_land = k.reshape(b, h, m, seg, -1).sum(dim=3) / seg
        attn1 = (q @ k_land.transpose(-1, -2)).softmax(dim=-1)
        attn2 = (q_land @ k_land.transpose(-1, -2)).softmax(dim=-1)
        attn3 = (q_land @ k.transpose(-1, -2)).softmax(dim=-1)
        out = (attn1 @ pinv(attn2, self.iters)) @ (attn3 @ v)
        out = out + self.res_conv(v)
        out = out[:, :, -n:].transpose(1, 2).reshape(b, n, h * self.dim_head)
        return self.dropout(self.to_out(out))


class TransLayer(nn.Module):
    def __init__(self, dim, heads, landmarks, iters, kernel, dropout):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = NystromAttention(dim, heads, dim // heads, landmarks,
                                     iters, kernel, dropout)

    def forward(self, x):
        return x + self.attn(self.norm(x))


class PPEG(nn.Module):
    def __init__(self, dim, kernels):
        super().__init__()
        k0, k1, k2 = kernels
        self.proj = nn.Conv2d(dim, dim, k0, 1, k0 // 2, groups=dim)
        self.proj1 = nn.Conv2d(dim, dim, k1, 1, k1 // 2, groups=dim)
        self.proj2 = nn.Conv2d(dim, dim, k2, 1, k2 // 2, groups=dim)

    def forward(self, x, side):
        b, _, c = x.shape
        cls_token, feat = x[:, 0], x[:, 1:]
        cnn = feat.transpose(1, 2).reshape(b, c, side, side)
        y = self.proj(cnn) + cnn + self.proj1(cnn) + self.proj2(cnn)
        return torch.cat([cls_token[:, None], y.flatten(2).transpose(1, 2)],
                         dim=1)


class TransMIL(nn.Module):
    def __init__(self, label_dim, path_dim, input_dim, dim=DIM, heads=HEADS,
                 landmarks=LANDMARKS, iters=PINV_ITERS, kernel=RES_KERNEL,
                 ppeg=PPEG_KERNELS, dropout=DROPOUT):
        super().__init__()
        self._fc1 = nn.Linear(input_dim, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        layer = dict(heads=heads, landmarks=landmarks, iters=iters,
                     kernel=kernel, dropout=dropout)
        self.layer1 = TransLayer(dim, **layer)
        self.pos_layer = PPEG(dim, ppeg)
        self.layer2 = TransLayer(dim, **layer)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self._fc2 = nn.Linear(dim, label_dim)
        self.multimodal_projection = nn.Linear(dim, path_dim)

    def forward(self, x):
        h = F.relu(self._fc1(x))
        side = math.ceil(math.sqrt(h.shape[1]))
        add = side * side - h.shape[1]
        h = torch.cat([h, h[:, :add]], dim=1)
        h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h], dim=1)
        h = self.layer2(self.pos_layer(self.layer1(h), side))
        h = self.norm(h)[:, 0]
        return self.multimodal_projection(h), self._fc2(h)


def build(settings, device, **widths):
    """The reference model of ``settings`` on ``device`` at the published
    widths (``widths``: other widths, for tests at a small size; weights
    uninitialised: load a state dict)."""
    if settings["mode"] != "transmil":
        raise ValueError(f"mode {settings['mode']!r} is not TransMIL")
    return TransMIL(int(settings["label_dim"]), int(settings["path_dim"]),
                    int(settings["input_path_dim"]), **widths).to(device)


def weighted_cross_entropy(logits, labels, class_weights):
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (w * nll).sum() / w.sum()


def cosine_lr(settings, steps_per_epoch):
    """``step -> lr`` of the ``cosine`` policy: from ``lr`` down to 0 over
    ``epochs * steps_per_epoch`` steps."""
    if settings["lr_policy"] != "cosine":
        raise ValueError(f"lr_policy {settings['lr_policy']!r} is not in "
                         "the reference")
    lr, total = float(settings["lr"]), max(1, int(settings["epochs"])
                                           * steps_per_epoch)
    return lambda step: lr * 0.5 * (1 + math.cos(math.pi * min(step, total)
                                                 / total))


class Trainer:
    """The reference's train step: train-mode forward, the weighted
    cross-entropy of the logits, backward, a zero gradient for every
    parameter the loss does not reach, AdamW at the scheduled lr."""

    def __init__(self, model, settings, steps_per_epoch, class_weights):
        if settings["optimizer"] != "adamw":
            raise ValueError("the reference trains with AdamW")
        self.model, self.s = model, settings
        self.params = list(model.parameters())
        self.opt = torch.optim.AdamW(self.params, lr=1.0,
                                     weight_decay=float(
                                         settings["weight_decay"]))
        self.lr = cosine_lr(settings, steps_per_epoch)
        self.count = 0
        self.cw = class_weights

    def step(self, tensors):
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        y = tensors["label"][:, CLASS_COL[self.s["task_type"]]].long()
        _, logits = self.model(tensors["x_path10"])
        loss = weighted_cross_entropy(logits, y, self.cw)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.count)
        self.opt.step()
        self.count += 1
        return loss.detach()

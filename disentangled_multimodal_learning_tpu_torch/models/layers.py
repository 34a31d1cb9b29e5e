"""Shared building blocks (counterpart of
``disentangled_multimodal_learning_tpu/models/layers.py``).

Token tensors are channels-last ``[B, N, C]``.  Every LayerNorm uses
``eps=1e-6``, the flax default the JAX package was trained with (torch's
default is 1e-5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nystrom import nystrom_attention
from ..parallel import mesh
from ..parallel.seq_shard import nystrom_attention_seq_sharded

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class Pooler(nn.Module):
    """Mean-pool tokens -> dense -> tanh (``layers.py:60``)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states.mean(dim=1)))


class FusionNet(nn.Module):
    """Concat two token streams + linear fusion (``layers.py:71``)."""

    def __init__(self, feature_dim: int = 128):
        super().__init__()
        self.fusion_layer = nn.Linear(2 * feature_dim, feature_dim)

    def forward(self, feature1, feature2):
        return self.fusion_layer(torch.cat([feature1, feature2], dim=-1))


class TransFusionLayer(nn.Module):
    """Cross-attention of all tokens onto one kv token, residual, then
    Pooler -> ``[B, 1, D]`` (``layers.py:218``).  The JAX
    ``MultiheadAttention`` it mirrors is golden-tested against this very
    ``nn.MultiheadAttention`` (tests/test_layers.py).  In train mode the
    MHA drops its attention weights with p = 0.1 (JAX ``layers.py:119``,
    ``:228``, ``:244``)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.norm = layer_norm(dim)
        self.multihead_attn = nn.MultiheadAttention(dim, 8, dropout=0.1,
                                                    batch_first=True)
        self.pooler = Pooler(dim)

    def forward(self, x1, x2):
        kv = self.norm(x2)
        attn_out, _ = self.multihead_attn(self.norm(x1), kv, kv,
                                          need_weights=False)
        x = x1 + attn_out
        return self.pooler(self.norm(x))[:, None, :]


class NystromAttention(nn.Module):
    """Landmark attention layer (``layers.py:127-196``): ``to_qkv`` without
    bias, q scaled by ``dh**-0.5``, the Nystrom core (``ops/nystrom.py``,
    ``pinv_iterations`` pinv steps, 6), the value residual (unless
    ``residual`` is off), ``to_out`` and dropout.  The
    residual is the reference's depthwise ``Conv2d(heads, heads, (33, 1),
    groups=heads)`` over ``v [B, h, N, dh]`` (JAX repeats each head's
    filter over the flattened ``[B, N, inner]`` values: the same sums).
    In a sharded train step the pinv's maxima span the rows of the data
    group, and in a ``seq`` layout the core runs on this rank's chunk of
    the tokens (``parallel/seq_shard.py``; JAX's ``seq_mesh``)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 num_landmarks: int = 256, dropout: float = 0.0,
                 pinv_iterations: int = 6, residual: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.res_conv = (nn.Conv2d(heads, heads, (33, 1), padding=(16, 0),
                                   groups=heads, bias=False)
                         if residual else None)
        self.to_out = nn.Linear(inner, dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        B, N, _ = x.shape
        q, k, v = (t.unflatten(-1, (self.heads, self.dim_head)).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        q = q * self.dim_head ** -0.5
        a = mesh.current()  # a sharded step: its pinv group, its token axis
        pinv_group = a.layout.pinv_group if a else None
        seq = mesh.inner_group("seq")
        if seq is not None:
            out = nystrom_attention_seq_sharded(
                q, k, v, self.num_landmarks, seq, self.pinv_iterations,
                pinv_group)
        else:
            out = nystrom_attention(q, k, v, self.num_landmarks,
                                    self.pinv_iterations, pinv_group)
        if self.res_conv is not None:
            out = out + self.res_conv(v)
        return self.dropout(self.to_out(out.transpose(1, 2).flatten(2)))


class TransLayer(nn.Module):
    """Pre-norm Nystrom block ``x + attn(LN(x))`` (``layers.py:199-215``):
    8 heads of ``dim / 8``, ``dim / 2`` landmarks, dropout 0.1."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.norm = layer_norm(dim)
        self.attn = NystromAttention(dim, dim_head=dim // 8, heads=8,
                                     num_landmarks=dim // 2, dropout=0.1)

    def forward(self, x):
        return x + self.attn(self.norm(x))


class CrossAttLayer(nn.Module):
    """Residual cross-attention block ``x1 + MHA(LN(x1), LN(x2), LN(x2))``
    (``layers.py:235``; no factory mode builds it), 8 heads, attention
    dropout 0.1 in train mode."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.norm = layer_norm(dim)
        self.multihead_attn = nn.MultiheadAttention(dim, 8, dropout=0.1,
                                                    batch_first=True)

    def forward(self, x1, x2):
        kv = self.norm(x2)
        out, _ = self.multihead_attn(self.norm(x1), kv, kv,
                                     need_weights=False)
        return x1 + out


class FeedForward(nn.Module):
    """``net_2(dropout(gelu(net_0(x))))``, exact GELU, hidden ``dim *
    mult`` (``layers.py:348``)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net_0 = nn.Linear(dim, dim * mult)
        self.net_2 = nn.Linear(dim * mult, dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        return self.net_2(self.drop(F.gelu(self.net_0(x))))


class Nystromformer(nn.Module):
    """The pre-norm Nystrom transformer stack (``layers.py:363``; no factory
    mode builds it): ``depth`` times ``x + attn_i(attn_norm_i(x))`` (a
    :class:`NystromAttention`, its value residual where
    ``attn_values_residual``) then ``x + ff_i(ff_norm_i(x))`` (a
    :class:`FeedForward`)."""

    def __init__(self, dim: int, depth: int, dim_head: int = 64,
                 heads: int = 8, num_landmarks: int = 256,
                 pinv_iterations: int = 6, attn_values_residual: bool = True,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", layer_norm(dim))
            self.add_module(f"attn_{i}", NystromAttention(
                dim, dim_head=dim_head, heads=heads,
                num_landmarks=num_landmarks, dropout=attn_dropout,
                pinv_iterations=pinv_iterations,
                residual=attn_values_residual))
            self.add_module(f"ff_norm_{i}", layer_norm(dim))
            self.add_module(f"ff_{i}", FeedForward(dim, dropout=ff_dropout))

    def forward(self, x):
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(
                getattr(self, f"attn_norm_{i}")(x))
            x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_norm_{i}")(x))
        return x


class PPEG(nn.Module):
    """Pyramid positional encoding (``layers.py:249-271``): the tokens after
    the cls token, row-major on an ``H x W`` grid, plus depthwise 7/5/3
    convs (with biases) of themselves; the cls token passes through."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.proj1 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.proj2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, H: int, W: int):
        B, _, C = x.shape
        img = x[:, 1:].transpose(1, 2).reshape(B, C, H, W)
        y = img + self.proj(img) + self.proj1(img) + self.proj2(img)
        return torch.cat([x[:, :1], y.flatten(2).transpose(1, 2)], dim=1)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm transformer layer with a ReLU FFN
    (``layers.py:274-296``), built from parts so that its LayerNorms take
    flax's eps 1e-6; ``dropout`` on the attention weights, after the
    attention, inside the FFN and after it."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 512, dropout: float = 0.25):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, nhead,
                                               dropout=dropout,
                                               batch_first=True)
        self.norm1 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        attn_out, _ = self.self_attn(x, x, x, need_weights=False)
        x = self.norm1(x + self.dropout(attn_out))
        y = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(y))


class Attn_Net_Gated(nn.Module):
    """Gated attention scores (``layers.py:299-315``): ``attention_c(tanh(a)
    * sigmoid(b))``, dropout 0.25 on both gates where ``dropout``; returns
    ``(scores [B, N, n_classes], x)``."""

    def __init__(self, L: int = 1024, D: int = 256, dropout: bool = False,
                 n_classes: int = 1):
        super().__init__()
        self.attention_a = nn.Linear(L, D)
        self.attention_b = nn.Linear(L, D)
        self.attention_c = nn.Linear(D, n_classes)
        self.drop = nn.Dropout(0.25 if dropout else 0.0)

    def forward(self, x):
        a = self.drop(torch.tanh(self.attention_a(x)))
        b = self.drop(torch.sigmoid(self.attention_b(x)))
        return self.attention_c(a * b), x


def square_pad(h):
    """``[B, N, C]`` -> ``([B, side^2, C], side)``: the bag made square by
    appending its own first ``side^2 - N`` tokens (``mil.py:75-78``)."""
    side = int(math.ceil(math.sqrt(h.shape[1])))
    add = side * side - h.shape[1]
    return (torch.cat([h, h[:, :add]], dim=1) if add else h), side


def combine_logits(logits1, logits2, combination_type: str, weights=None):
    """Multi-scale logit combination, the four modes of ``layers.py:318``."""
    if combination_type == "average":
        return (logits1 + logits2) / 2
    if combination_type == "weighted":
        w = weights if weights is not None else (0.5, 0.5)
        return w[0] * logits1 + w[1] * logits2
    if combination_type == "softmax_average":
        p1 = torch.softmax(logits1, dim=1)
        p2 = torch.softmax(logits2, dim=1)
        return torch.log((p1 + p2) / 2 + 1e-8)
    if combination_type == "max_confidence":
        c1 = torch.softmax(logits1, dim=1).amax(dim=1, keepdim=True)
        c2 = torch.softmax(logits2, dim=1).amax(dim=1, keepdim=True)
        return torch.where(c1 > c2, logits1, logits2)
    raise ValueError(f"unknown combination_type {combination_type!r}")


def survival_chain(logits):
    """hazards = sigmoid(logits); S = cumprod(1 - h); risk = -sum(S)
    (``layers.py:339``)."""
    hazards = torch.sigmoid(logits)
    S = torch.cumprod(1.0 - hazards, dim=1)
    return hazards, S, -S.sum(dim=1)

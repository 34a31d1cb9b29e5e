"""Shared building blocks (counterpart of
``disentangled_multimodal_learning_tpu/models/layers.py``).

Token tensors are channels-last ``[B, N, C]``.  Every LayerNorm uses
``eps=1e-6``, the flax default the JAX package was trained with (torch's
default is 1e-5).
"""

from __future__ import annotations

import torch
from torch import nn

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

"""Bag-level MIL path encoders (counterpart of
``disentangled_multimodal_learning_tpu/models/mil.py``: ``ABMIL`` :18,
``GatedABMIL`` :41 and ``TransMIL`` :62) over patch-feature bags ``[B, N,
1024]``.  ABMIL and TransMIL return ``(encoded [B, path_dim], logits [B,
label_dim], None)``; GatedABMIL, which no factory mode builds,
``(prob, pred)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import PPEG, TransLayer, layer_norm, square_pad


class ABMIL(nn.Module):
    """Attention MIL without gating: scores ``Linear(L, D) -> tanh ->
    Linear(D, K)``, softmax over the bag, the weighted sum of the patches,
    a classifier and a projection to ``path_dim``."""

    def __init__(self, label_dim: int, path_dim: int = 128, L: int = 1024,
                 D: int = 128, K: int = 1):
        super().__init__()
        self.attention_0 = nn.Linear(L, D)
        self.attention_1 = nn.Linear(D, K)
        self.classifier = nn.Linear(L * K, label_dim)
        self.multimodal_projection = nn.Linear(L * K, path_dim)

    def forward(self, x):
        a = self.attention_1(torch.tanh(self.attention_0(x)))     # [B, N, K]
        a = torch.softmax(a.transpose(1, 2), dim=2)               # [B, K, N]
        m = (a @ x).flatten(1)                                    # [B, K*L]
        return self.multimodal_projection(m), self.classifier(m), None


class GatedABMIL(nn.Module):
    """Gated attention MIL: scores ``attention_weights(tanh(attention_V(x))
    * sigmoid(attention_U(x)))``, softmax over the bag, the weighted sum of
    the patches, and a sigmoid classifier; returns ``(prob [B, label_dim],
    pred [B])``, ``pred`` the argmax of ``prob``."""

    def __init__(self, label_dim: int = 2, L: int = 1024, D: int = 128,
                 K: int = 1):
        super().__init__()
        self.attention_V = nn.Linear(L, D)
        self.attention_U = nn.Linear(L, D)
        self.attention_weights = nn.Linear(D, K)
        self.classifier = nn.Linear(L * K, label_dim)

    def forward(self, x):
        a = self.attention_weights(torch.tanh(self.attention_V(x))
                                   * torch.sigmoid(self.attention_U(x)))
        a = torch.softmax(a.transpose(1, 2), dim=2)               # [B, K, N]
        prob = torch.sigmoid(self.classifier((a @ x).flatten(1)))
        return prob, prob.argmax(dim=1)


class TransMIL(nn.Module):
    """Nystrom-transformer MIL: ``Linear(1024, dim)`` + ReLU, the bag made
    square by wrapping its head (``layers.square_pad``), a cls token
    (N(0, 1) at init), TransLayer -> PPEG -> TransLayer, LayerNorm, and the
    cls token's classifier and projection.  At N 2,500 the sequence is
    2,501 tokens, left-padded to 2,560 for the 256 landmarks.  JAX's
    ``seq_mesh`` (the token axis sharded over chips) is a layout of the
    train step here (``seq_shard_devices``, ``parallel/seq_shard.py``)."""

    def __init__(self, label_dim: int, path_dim: int = 128,
                 input_dim: int = 1024, dim: int = 512):
        super().__init__()
        self._fc1 = nn.Linear(input_dim, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.layer1 = TransLayer(dim)
        self.pos_layer = PPEG(dim)
        self.layer2 = TransLayer(dim)
        self.norm = layer_norm(dim)
        self._fc2 = nn.Linear(dim, label_dim)
        self.multimodal_projection = nn.Linear(dim, path_dim)

    def forward(self, x):
        h, side = square_pad(F.relu(self._fc1(x)))
        h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h], dim=1)
        h = self.layer2(self.pos_layer(self.layer1(h), side, side))
        h = self.norm(h)[:, 0]
        return self.multimodal_projection(h), self._fc2(h), None

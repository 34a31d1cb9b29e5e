"""Gradient modulation of the two-branch classifier (counterpart of
``disentangled_multimodal_learning_tpu/train/grad_modulate.py``).

The classifier's ``[C, 2*hs]`` weight sees two feature halves (feature1 |
feature2).  Per class row, when the two half-gradients conflict (cosine
< 0), the half of the currently weaker branch (softmax score ratio < 1) is
replaced by a projected vector.  torch's weight layout is the reference's,
so a per-class row is a torch row (the JAX module works on columns of its
``[2*hs, C]`` kernel).  The reference's double subtraction is kept
(grad' = grad - proj; perpen = grad' - proj; result = |grad'| *
perpen / |perpen|).
"""

from __future__ import annotations

import torch

EPS = 1e-12


def _project_rows(g_weak, g_strong):
    """The reference's projection surgery, row by row ``[C, hs]``."""
    dot = (g_weak * g_strong).sum(dim=1, keepdim=True)
    proj = dot / (g_strong * g_strong).sum(dim=1, keepdim=True).clamp_min(
        EPS) * g_strong
    g1 = g_weak - proj
    perpen = g1 - proj
    unit = perpen / torch.linalg.vector_norm(
        perpen, dim=1, keepdim=True).clamp_min(EPS)
    return torch.linalg.vector_norm(g1, dim=1, keepdim=True) * unit


def branch_scores(feature1, feature2, weight, bias, labels):
    """Per-branch confidence: ``out_k = feature_k @ W_k^T + bias / 2``,
    ``score_k = sum_i softmax(out_k)[i, y_i]``; ``weight [C, 2*hs]``."""
    hs = feature1.shape[-1]
    out1 = feature1 @ weight[:, :hs].t() + bias / 2
    out2 = feature2 @ weight[:, hs:].t() + bias / 2
    y = labels[:, None].long()
    s1 = torch.softmax(out1, dim=-1).gather(1, y).sum()
    s2 = torch.softmax(out2, dim=-1).gather(1, y).sum()
    return s1, s2


@torch.no_grad()
def modulate_kernel_grad(weight_grad, feature1, feature2, weight, bias,
                         labels):
    """The modulated ``[C, 2*hs]`` classifier weight gradient."""
    hs = feature1.shape[-1]
    s1, s2 = branch_scores(feature1, feature2, weight, bias, labels)
    ratio1 = s1 / s2
    ratio2 = 1.0 / ratio1
    g1, g2 = weight_grad[:, :hs], weight_grad[:, hs:]
    sim = (g1 * g2).sum(dim=1, keepdim=True) / (
        torch.linalg.vector_norm(g1, dim=1, keepdim=True)
        * torch.linalg.vector_norm(g2, dim=1, keepdim=True)).clamp_min(EPS)
    conflict = sim < 0
    new1 = torch.where(conflict & (ratio1 < 1), _project_rows(g1, g2), g1)
    new2 = torch.where(conflict & (ratio1 >= 1) & (ratio2 < 1),
                       _project_rows(g2, g1), g2)
    return torch.cat([new1, new2], dim=1)

"""MCAT, the genomics-guided co-attention survival baseline (counterpart of
``disentangled_multimodal_learning_tpu/models/mcat.py``: ``SNNBlock`` :26,
``MCAT_Surv`` :39).

The bag ``Linear(1024, 256)`` + ReLU + dropout 0.25; one SNN tower of two
blocks per genomic signature, over contiguous slices ``omic_sizes`` of the
omic vector (431 genes = 100 + 100 + 100 + 131); a 1-head co-attention
(the signatures query the patches); a two-layer post-norm transformer on
each of the co-attended and the genomic tokens; gated attention pooling of
each; ``fusion`` ``"concat"`` (two Linear + ReLU, what the factory builds)
or ``"bilinear"`` (:class:`~.fusion.BilinearFusion` at scale 8); the
classifier and the survival chain.  Returns ``(logits, hazards, S)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .fusion import BilinearFusion
from .layers import Attn_Net_Gated, TorchTransformerEncoderLayer


class SNNBlock(nn.Module):
    """``fc`` -> ELU -> AlphaDropout (torch's semantics, which JAX's
    ``alpha_dropout`` reproduces)."""

    def __init__(self, dim1: int, dim2: int, dropout: float = 0.25):
        super().__init__()
        self.fc = nn.Linear(dim1, dim2)
        self.adrop = nn.AlphaDropout(dropout)

    def forward(self, x):
        return self.adrop(F.elu(self.fc(x)))


class _SignatureTowers(nn.Module):
    """The per-signature SNN towers, named as flax names them
    (``sig_{i}_{j}``), shared by MCAT and CMTA: ``x_omic [B, sum(sizes)]``
    -> ``[B, len(sizes), size_omic[-1]]``."""

    def __init__(self, omic_sizes, size_omic):
        super().__init__()
        self.omic_sizes = tuple(omic_sizes)
        self.depth = len(size_omic)
        for i, s in enumerate(self.omic_sizes):
            dims = (s, *size_omic)
            for j in range(self.depth):
                self.add_module(f"sig_{i}_{j}", SNNBlock(dims[j], dims[j + 1]))

    def signatures(self, x_omic):
        out = []
        for i, sig in enumerate(x_omic.split(self.omic_sizes, dim=1)):
            for j in range(self.depth):
                sig = getattr(self, f"sig_{i}_{j}")(sig)
            out.append(sig)
        return torch.stack(out, dim=1)


class MCAT_Surv(_SignatureTowers):
    def __init__(self, label_dim: int = 4,
                 omic_sizes=(100, 100, 100, 131), fusion: str = "concat",
                 dropout: float = 0.25, size_wsi=(1024, 256, 256),
                 size_omic=(256, 256)):
        super().__init__(omic_sizes, size_omic)
        self.fusion = fusion
        self.wsi_net = nn.Linear(size_wsi[0], size_wsi[1])
        self.wsi_drop = nn.Dropout(0.25)
        self.coattn = nn.MultiheadAttention(256, 1, batch_first=True)
        for prefix in ("path_transformer", "omic_transformer"):
            for i in range(2):
                self.add_module(f"{prefix}_{i}", TorchTransformerEncoderLayer(
                    256, 8, 512, dropout))
        for prefix in ("path", "omic"):
            self.add_module(f"{prefix}_attention_head", Attn_Net_Gated(
                size_wsi[2], size_wsi[2], dropout=True, n_classes=1))
            self.add_module(f"{prefix}_rho",
                            nn.Linear(size_wsi[2], size_wsi[2]))
        self.drop = nn.Dropout(dropout)
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=256, dim2=256, scale_dim1=8,
                                     scale_dim2=8, mmhid=256)
        else:
            self.mm_0 = nn.Linear(2 * size_wsi[2], size_wsi[2])
            self.mm_1 = nn.Linear(size_wsi[2], size_wsi[2])
        self.classifier = nn.Linear(size_wsi[2], label_dim)

    def _pooled(self, x, prefix: str):
        for i in range(2):
            x = getattr(self, f"{prefix}_transformer_{i}")(x)
        scores, h = getattr(self, f"{prefix}_attention_head")(x)
        w = torch.softmax(scores.transpose(1, 2), dim=2)          # [B, 1, n]
        h = F.relu(getattr(self, f"{prefix}_rho")((w @ h)[:, 0]))
        return self.drop(h)

    def forward(self, x_path, x_omic):
        h_path_bag = self.wsi_drop(F.relu(self.wsi_net(x_path)))
        h_omic_bag = self.signatures(x_omic)                    # [B, 4, 256]
        h_path_coattn, _ = self.coattn(h_omic_bag, h_path_bag, h_path_bag,
                                       need_weights=False)
        h_path = self._pooled(h_path_coattn, "path")
        h_omic = self._pooled(h_omic_bag, "omic")
        if self.fusion == "bilinear":
            h = self.mm(h_path, h_omic)
        else:
            h = F.relu(self.mm_1(F.relu(self.mm_0(
                torch.cat([h_path, h_omic], dim=1)))))
        logits = self.classifier(h)
        hazards = torch.sigmoid(logits)
        return logits, hazards, torch.cumprod(1.0 - hazards, dim=1)

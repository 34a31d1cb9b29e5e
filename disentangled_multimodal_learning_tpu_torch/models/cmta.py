"""CMTA, the cross-modal translation and alignment baseline (counterpart
of ``disentangled_multimodal_learning_tpu/models/cmta.py``:
``Transformer_P`` :23, ``Transformer_G`` :46, ``CMTA`` :64).

The bag ``Linear(1024, 256)`` + ReLU + dropout 0.25 and the genomic
signature towers of MCAT; a Nystrom-transformer encoder per modality
(path: square pad, cls token, TransLayer -> PPEG -> TransLayer; genes: cls
token, two TransLayers); 1-head cross attention of each modality's tokens
into the other's (``P_in_G``: path queries, ``G_in_P``: gene queries);
a decoder per modality on the cross-attended tokens; each modality's
encoder and decoder cls tokens averaged, fused (``"concat"``: two Linear
+ ReLU; ``"bilinear"``: :class:`~.fusion.BilinearFusion` at scale 8),
classified, and the survival chain.  Returns ``(logits, hazards, S,
cls_p_enc, cls_p_dec, cls_g_enc, cls_g_dec)``, the four cls tokens for
the reference's orthogonality loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .fusion import BilinearFusion
from .layers import PPEG, TransLayer, layer_norm, square_pad
from .mcat import _SignatureTowers


class _ClsTransformer(nn.Module):
    """A cls token (N(0, 1e-6) at init, ``models/factory.py
    init_weights``), two TransLayers and a LayerNorm; returns ``(cls
    [B, C], tokens [B, n, C])``."""

    init_std = {"cls_token": 1e-6}

    def __init__(self, feature_dim: int = 256):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, feature_dim))
        self.layer1 = TransLayer(feature_dim)
        self.layer2 = TransLayer(feature_dim)
        self.norm = layer_norm(feature_dim)

    def _with_cls(self, h):
        return torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h],
                         dim=1)

    def _out(self, h):
        h = self.norm(h)
        return h[:, 0], h[:, 1:]


class Transformer_P(_ClsTransformer):
    """The path tokens square-padded (the bag's head wrapped), a PPEG
    between the two TransLayers."""

    def __init__(self, feature_dim: int = 256):
        super().__init__(feature_dim)
        self.pos_layer = PPEG(feature_dim)

    def forward(self, features):
        h, side = square_pad(features)
        h = self.layer1(self._with_cls(h))
        return self._out(self.layer2(self.pos_layer(h, side, side)))


class Transformer_G(_ClsTransformer):
    def forward(self, features):
        return self._out(self.layer2(self.layer1(self._with_cls(features))))


class CMTA(_SignatureTowers):
    def __init__(self, label_dim: int = 4,
                 omic_sizes=(100, 100, 100, 131), fusion: str = "concat",
                 dropout: float = 0.25, size_wsi=(1024, 256, 256),
                 size_omic=(256, 256)):
        super().__init__(omic_sizes, size_omic)
        self.fusion = fusion
        self.wsi_net = nn.Linear(size_wsi[0], size_wsi[1])
        self.wsi_drop = nn.Dropout(0.25)
        fd = size_omic[-1]
        self.pathomics_encoder = Transformer_P(fd)
        self.genomics_encoder = Transformer_G(fd)
        self.P_in_G_Att = nn.MultiheadAttention(256, 1, batch_first=True)
        self.G_in_P_Att = nn.MultiheadAttention(256, 1, batch_first=True)
        self.pathomics_decoder = Transformer_P(fd)
        self.genomics_decoder = Transformer_G(fd)
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=256, dim2=256, scale_dim1=8,
                                     scale_dim2=8, mmhid=256)
        else:
            self.mm_0 = nn.Linear(2 * size_wsi[2], size_wsi[2])
            self.mm_1 = nn.Linear(size_wsi[2], size_wsi[2])
        self.classifier = nn.Linear(size_wsi[2], label_dim)

    def forward(self, x_path, x_omic):
        h_path = self.wsi_drop(F.relu(self.wsi_net(x_path)))
        h_omic_bag = self.signatures(x_omic)                    # [B, 4, 256]
        cls_p_enc, tok_p = self.pathomics_encoder(h_path)
        cls_g_enc, tok_g = self.genomics_encoder(h_omic_bag)
        p_in_g, _ = self.P_in_G_Att(tok_p, tok_g, tok_g, need_weights=False)
        g_in_p, _ = self.G_in_P_Att(tok_g, tok_p, tok_p, need_weights=False)
        cls_p_dec, _ = self.pathomics_decoder(p_in_g)
        cls_g_dec, _ = self.genomics_decoder(g_in_p)
        p_avg = (cls_p_enc + cls_p_dec) / 2
        g_avg = (cls_g_enc + cls_g_dec) / 2
        if self.fusion == "bilinear":
            fused = self.mm(p_avg, g_avg)
        else:
            fused = F.relu(self.mm_1(F.relu(self.mm_0(
                torch.cat([p_avg, g_avg], dim=1)))))
        logits = self.classifier(fused)
        hazards = torch.sigmoid(logits)
        S = torch.cumprod(1.0 - hazards, dim=1)
        return logits, hazards, S, cls_p_enc, cls_p_dec, cls_g_enc, cls_g_dec

"""Disentangled deformable cross-attention fusion models (counterpart of
``disentangled_multimodal_learning_tpu/models/deform_mil.py``:
``DeformCrossTransLayer`` :19, ``DeformCrossTransMIL`` :48 and
``DeformPathomicNet`` :96).

``attn_dim`` 1 prepends a cls token and runs the 1-D deformable attention
(``DeformCrossAttention1D``, whose CPB is the 1-D table kernel K4 at any
``cpb_table_divisor > 0``); ``attn_dim`` 2 runs the 2-D one and a Pooler,
which alone takes ``fused_table_attention`` and ``cpb_table_bf16`` (JAX's
1-D table has neither).
Each model holds only the attention its ``attn_dim`` runs, so a state_dict
from the port's JAX name map (``utils/jax_params.py``) loads with
``strict=True``.  Train mode turns on the dropouts of the JAX model:
AlphaDropout in both MaxNets and, at ``attn_dim`` 2, dropout 0.1 on the
attention weights (the 1-D attention has none: ``DeformCrossTransLayer``
passes no dropout, ``deform_mil.py:31-34``).
"""

from __future__ import annotations

import torch
from torch import nn

from .deform_attention import DeformCrossAttention1D, DeformCrossAttention2D
from .fusion import BilinearFusion
from .layers import FusionNet, Pooler, layer_norm
from .maxnet import MaxNet


class DeformCrossTransLayer(nn.Module):
    """LayerNorm (shared by both inputs), deformable cross attention of
    ``x1`` into ``x2``, residual."""

    def __init__(self, dim: int = 128, attn_dim: int = 2,
                 degenerate_1d_sampling: bool = False,
                 cpb_table_divisor: int = 0, attn_bf16_streams: bool = False,
                 fused_table_attention: bool = False,
                 cpb_table_bf16: bool = False, attn_layout: str = "auto"):
        super().__init__()
        self.attn_dim = attn_dim
        self.norm = layer_norm(dim)
        if attn_dim == 1:
            self.attn1d = DeformCrossAttention1D(
                dim=dim, downsample_factor=4, offset_scale=2,
                offset_kernel_size=6,
                degenerate_sampling=degenerate_1d_sampling,
                cpb_table_divisor=cpb_table_divisor,
                attn_bf16_streams=attn_bf16_streams, attn_layout=attn_layout)
        else:
            self.attn2d = DeformCrossAttention2D(
                dim=dim, dim_head=64, heads=8, dropout=0.1,
                downsample_factor=4, offset_scale=4, offset_groups=8,
                offset_kernel_size=6, cpb_table_divisor=cpb_table_divisor,
                attn_bf16_streams=attn_bf16_streams,
                fused_table_attention=fused_table_attention,
                cpb_table_bf16=cpb_table_bf16, attn_layout=attn_layout)

    def forward(self, x1, x2, return_vgrid: bool = False):
        if self.attn_dim == 1:
            return x1 + self.attn1d(self.norm(x1), self.norm(x2))
        x, vgrid = self.attn2d(self.norm(x1), self.norm(x2),
                               return_vgrid=return_vgrid)
        return (x1 + x, vgrid) if return_vgrid else x1 + x


class DeformCrossTransMIL(nn.Module):
    """Patch features 1024 -> 128 (Dense+ReLU), the omic vector broadcast
    over the tokens and fused (FusionNet), the deformable cross layer, then
    a classifier and a projection.  Returns ``(encoded, logits, None)``, and
    with ``return_vgrid`` also the broadcast omic ``[B, N, C]`` and the
    ``[B*G, 2, gh, gw]`` vgrid."""

    def __init__(self, label_dim: int = 4, input_dim: int = 1024,
                 path_dim: int = 128, attn_dim: int = 2,
                 return_vgrid: bool = False,
                 degenerate_1d_sampling: bool = False, **attn_kw):
        super().__init__()
        self.attn_dim = attn_dim
        self.return_vgrid = return_vgrid
        self._fc1 = nn.Sequential(nn.Linear(input_dim, path_dim), nn.ReLU())
        self.fusion_layer = FusionNet(path_dim)
        self.layer3 = DeformCrossTransLayer(
            path_dim, attn_dim, degenerate_1d_sampling, **attn_kw)
        if attn_dim == 1:
            self.cls_token = nn.Parameter(torch.empty(1, 1, path_dim))
        else:
            self.pooler = Pooler(path_dim)
        self.norm = layer_norm(path_dim)
        self._fc2 = nn.Linear(path_dim, label_dim)
        self.multimodal_projection = nn.Linear(path_dim, path_dim)

    def forward(self, path, omic):
        path = self._fc1(path)                                   # [B, N, C]
        B, N, C = path.shape
        omic_b = omic[:, None, :].expand(B, N, C)
        h = self.fusion_layer(path, omic_b)
        vgrid = None
        if self.attn_dim == 1:
            cls = self.cls_token.expand(B, 1, C)
            h = self.layer3(torch.cat([cls, h], dim=1),
                            torch.cat([cls, path], dim=1))
            h = self.norm(h)[:, 0]
        else:
            if self.return_vgrid:
                h, vgrid = self.layer3(h, path, return_vgrid=True)
            else:
                h = self.layer3(h, path)
            h = self.pooler(self.norm(h))
        logits = self._fc2(h)
        encoded = self.multimodal_projection(h)
        if self.return_vgrid:
            return encoded, logits, None, omic_b, vgrid
        return encoded, logits, None


class DeformPathomicNet(nn.Module):
    """Two MaxNet omic encoders (tumor, immune), two DeformCrossTransMIL
    branches on the same patches, their fusion (``fusion_type``
    ``"concat"``; any other: :class:`~.fusion.BilinearFusion` of the two
    vectors to ``mmhid``, JAX ``deform_mil.py:132-138``) and three
    classifiers; sigmoid on the three outputs for the survival task.
    Returns
    ``(features, vec_t, vec_i, logits, None, None, None)`` with ``logits``
    ``[tumor, immune, fused]``, and with ``return_vgrid`` ``[tumor, immune,
    fused, omic_t, vgrid_t, omic_i, vgrid_i]`` (reference
    ``models/model.py:563-564``).  ``x_omic`` is taken and not used, as in
    JAX.  ``output_range`` and ``output_shift`` are the reference's constant
    members (``torch_export.py:195-197`` writes them), kept as persistent
    buffers so that a reference-named state_dict loads strictly."""

    def __init__(self, label_dim: int, input_size_omic_tumor: int,
                 input_size_omic_immune: int, input_path_dim: int = 1024,
                 path_dim: int = 128, omic_dim: int = 128,
                 dropout_rate: float = 0.1, attn_dim: int = 2,
                 return_vgrid: bool = False, task_type: str = "diag2021",
                 degenerate_1d_sampling: bool = False,
                 cpb_table_divisor: int = 0, attn_bf16_streams: bool = False,
                 fused_table_attention: bool = False,
                 cpb_table_bf16: bool = False, attn_layout: str = "auto",
                 fusion_type: str = "concat", mmhid: int = 128):
        super().__init__()
        self.return_vgrid = return_vgrid
        self.survival = task_type == "survival"
        self.omic_net_tumor = MaxNet(input_size_omic_tumor, omic_dim,
                                     dropout_rate, label_dim)
        self.omic_net_immune = MaxNet(input_size_omic_immune, omic_dim,
                                      dropout_rate, label_dim)
        kw = dict(label_dim=label_dim, input_dim=input_path_dim,
                  path_dim=path_dim, attn_dim=attn_dim,
                  return_vgrid=return_vgrid,
                  degenerate_1d_sampling=degenerate_1d_sampling,
                  cpb_table_divisor=cpb_table_divisor,
                  attn_bf16_streams=attn_bf16_streams,
                  fused_table_attention=fused_table_attention,
                  cpb_table_bf16=cpb_table_bf16, attn_layout=attn_layout)
        self.pathomic_net_tumor = DeformCrossTransMIL(**kw)
        self.pathomic_net_immune = DeformCrossTransMIL(**kw)
        if fusion_type == "concat":
            self.fusion = None
            self.classifier = nn.Linear(2 * path_dim, label_dim)
        else:
            self.fusion = BilinearFusion(dim1=path_dim, dim2=omic_dim,
                                         mmhid=mmhid)
            self.classifier = nn.Linear(mmhid, label_dim)
        self.classifier_tumor = nn.Sequential(nn.Linear(path_dim, label_dim))
        self.classifier_immune = nn.Sequential(nn.Linear(path_dim, label_dim))
        self.register_buffer("output_range", torch.tensor([6.0]))
        self.register_buffer("output_shift", torch.tensor([-3.0]))

    def forward(self, x_path, x_omic, x_omic_tumor, x_omic_immune):
        omic_t, _ = self.omic_net_tumor(x_omic_tumor)
        omic_i, _ = self.omic_net_immune(x_omic_immune)
        out_t = self.pathomic_net_tumor(x_path, omic_t)
        out_i = self.pathomic_net_immune(x_path, omic_i)
        vec_t, vec_i = out_t[0], out_i[0]
        features = (torch.cat([vec_t, vec_i], dim=1) if self.fusion is None
                    else self.fusion(vec_t, vec_i))
        hazard = self.classifier(features)
        hazard_t = self.classifier_tumor(vec_t)
        hazard_i = self.classifier_immune(vec_i)
        if self.survival:
            hazard, hazard_t, hazard_i = (torch.sigmoid(h) for h in
                                          (hazard, hazard_t, hazard_i))
        logits = [hazard_t, hazard_i, hazard]
        if self.return_vgrid:
            logits += [out_t[3], out_t[4], out_i[3], out_i[4]]
        return features, vec_t, vec_i, logits, None, None, None

"""Two-scale genomics-guided teacher and pathology-only student
(counterpart of ``disentangled_multimodal_learning_tpu/models/teacher_student.py``:
``ClusterMergeNet`` :53, ``TeacherEncoder`` :80, ``StudentEncoder`` :108,
``TeacherNet`` :129, ``StudentNet`` :158, ``TeachersNet`` :180,
``StudentsNet`` :241, unstacked).

``unimodal=True`` gives the uniteacher (queries are ``[path, path]``).
Outputs are the reference's six structured dicts, keyed as in JAX.  Train
mode (``model.train()``) turns on the dropouts of the JAX model: AlphaDropout
in both MaxNets, dropout 0.1 on the deformable attention weights and on the
TransFusionLayers' MHA weights, and draws the student's DPC tie-break noise
from the torch RNG; eval mode (and ``deterministic_training``) turns the
dropouts off and pins that noise (``ops/cluster.py pinned_density_noise``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import cluster as cluster_ops
from .deform_attention import DeformCrossAttention2D
from .layers import (FusionNet, Pooler, TransFusionLayer, combine_logits,
                     layer_norm, survival_chain)
from .maxnet import MaxNet


def _deform2d(dim: int, **attn_kw):
    # instantiation constants of the reference (models/Modules.py:107-126;
    # JAX teacher_student.py:47-50); attn_kw: the attention options of the
    # config (cpb_table_divisor, attn_bf16_streams, fused_table_attention,
    # cpb_table_bf16)
    return DeformCrossAttention2D(
        dim=dim, dim_head=64, heads=8, dropout=0.1, downsample_factor=4,
        offset_scale=4, offset_groups=8, offset_kernel_size=6, **attn_kw)


class ClusterMergeNet(nn.Module):
    """LayerNorm, token weights ``exp(score)``, and the DPC-KNN merge down to
    ``max(ceil(N * sample_ratio), 1, min_clusters)`` tokens."""

    def __init__(self, dim: int, sample_ratio: float, min_clusters: int = 1):
        super().__init__()
        self.sample_ratio = sample_ratio
        self.min_clusters = min_clusters
        self.norm = layer_norm(dim)
        self.score = nn.Linear(dim, 1)

    def forward(self, x):
        B, N, _ = x.shape
        x = self.norm(x)
        token_weight = torch.exp(self.score(x))                  # [B, N, 1]
        cluster_num = max(max(math.ceil(N * self.sample_ratio), 1),
                          self.min_clusters)
        if self.training:
            noise = torch.rand((B, N), device=x.device)
        else:
            noise = cluster_ops.pinned_density_noise((B, N), x.device)
        return cluster_ops.cluster_merge(x, cluster_num, token_weight, k=5,
                                         density_noise=noise)


class TeacherEncoder(nn.Module):
    """Two deformable cross attentions (omic queries into the patch grid),
    residual, FusionNet, and two TransFusionLayers against the first fused
    token.  One LayerNorm is shared by every normalization, as in the
    reference."""

    def __init__(self, dim: int = 128, **attn_kw):
        super().__init__()
        self.norm = layer_norm(dim)
        self.attn2d_omic1 = _deform2d(dim, **attn_kw)
        self.attn2d_omic2 = _deform2d(dim, **attn_kw)
        self.fusion_layer = FusionNet(dim)
        self.transfusion_layer1 = TransFusionLayer(dim)
        self.transfusion_layer2 = TransFusionLayer(dim)

    def forward(self, x1, x2):
        norm = self.norm
        x2n = norm(x2)
        a1, attn1 = self.attn2d_omic1(norm(x1[0]), x2n)
        a2, attn2 = self.attn2d_omic2(norm(x1[1]), x2n)
        x = self.fusion_layer(x1[0] + a1, x1[1] + a2)            # [B, N, C]
        query = norm(x)
        f1 = self.transfusion_layer1(query, norm(x1[0][:, :1, :]))
        f2 = self.transfusion_layer2(query, norm(x1[1][:, :1, :]))
        return f1, f2, attn1, attn2                              # [B,1,C] x2


class StudentEncoder(nn.Module):
    """Deformable self attention with a residual, then the cluster merge down
    to ``ceil(N * sample_ratio)`` (at least 2) tokens."""

    def __init__(self, dim: int = 128, sample_ratio: float = 0.0008,
                 **attn_kw):
        super().__init__()
        self.norm = layer_norm(dim)
        self.attn2d = _deform2d(dim, **attn_kw)
        self.cluster_merge = ClusterMergeNet(dim, sample_ratio, min_clusters=2)

    def forward(self, x1, x2):
        a, attn = self.attn2d(self.norm(x1), self.norm(x2))
        return self.cluster_merge(x1 + a), attn          # [B, K, C], [B,H,K,N]


class TeacherNet(nn.Module):
    """Single-scale teacher: Dense+ReLU, TeacherEncoder, two Poolers and a
    classifier."""

    def __init__(self, label_dim: int, input_dim: int = 1024,
                 path_dim: int = 128, unimodal: bool = False, **attn_kw):
        super().__init__()
        self.unimodal = unimodal
        self._fc1 = nn.Sequential(nn.Linear(input_dim, path_dim), nn.ReLU())
        self.encoder = TeacherEncoder(path_dim, **attn_kw)
        self.norm = layer_norm(path_dim)
        self.pooler1 = Pooler(path_dim)
        self.pooler2 = Pooler(path_dim)
        self.classifier = nn.Linear(2 * path_dim, label_dim)

    def forward(self, path, omic_list):
        path = self._fc1(path)
        if self.unimodal:
            queries = (path, path)
        else:
            shape = path.shape
            queries = (omic_list[0][:, None, :].expand(shape),
                       omic_list[1][:, None, :].expand(shape))
        f1, f2, att1, att2 = self.encoder(queries, path)
        feature1 = self.pooler1(self.norm(f1))                   # [B, C]
        feature2 = self.pooler2(self.norm(f2))
        logits = self.classifier(torch.cat([feature1, feature2], dim=-1))
        hazards, S, risk = survival_chain(logits)
        return logits, hazards, S, risk, feature1, feature2, att1, att2


class StudentNet(nn.Module):
    """Single-scale student: Dense+ReLU, StudentEncoder on the patches as
    queries and kv, and a classifier on the first two cluster tokens."""

    def __init__(self, label_dim: int, input_dim: int = 1024,
                 path_dim: int = 128, sample_ratio: float = 0.0008,
                 **attn_kw):
        super().__init__()
        self._fc1 = nn.Sequential(nn.Linear(input_dim, path_dim), nn.ReLU())
        self.encoder = StudentEncoder(path_dim, sample_ratio, **attn_kw)
        self.classifier = nn.Linear(2 * path_dim, label_dim)

    def forward(self, path):
        path = self._fc1(path)
        feature, att = self.encoder(path, path)
        feature = torch.cat([feature[:, 0], feature[:, 1]], dim=-1)
        logits = self.classifier(feature)
        hazards, S, risk = survival_chain(logits)
        return logits, hazards, S, risk, feature, att


class TeachersNet(nn.Module):
    """Two-scale teacher ensemble with per-compartment omic encoders."""

    def __init__(self, label_dim: int, input_size_omic_tumor: int,
                 input_size_omic_immune: int, input_path_dim: int = 1024,
                 path_dim: int = 128, omic_dim: int = 128,
                 dropout_rate: float = 0.1,
                 combination_type: str = "max_confidence",
                 unimodal: bool = False, cpb_table_divisor: int = 0,
                 attn_bf16_streams: bool = False,
                 fused_table_attention: bool = False,
                 cpb_table_bf16: bool = False):
        super().__init__()
        self.combination_type = combination_type
        self.omic_net_tumor = MaxNet(input_size_omic_tumor, omic_dim,
                                     dropout_rate, label_dim)
        self.omic_net_immune = MaxNet(input_size_omic_immune, omic_dim,
                                      dropout_rate, label_dim)
        kw = dict(label_dim=label_dim, input_dim=input_path_dim,
                  path_dim=path_dim, unimodal=unimodal,
                  cpb_table_divisor=cpb_table_divisor,
                  attn_bf16_streams=attn_bf16_streams,
                  fused_table_attention=fused_table_attention,
                  cpb_table_bf16=cpb_table_bf16)
        self.teacher10_net = TeacherNet(**kw)
        self.teacher20_net = TeacherNet(**kw)

    def forward(self, x_path10, x_path20, x_omic_tumor, x_omic_immune):
        omic_t, _ = self.omic_net_tumor(x_omic_tumor)
        omic_i, _ = self.omic_net_immune(x_omic_immune)
        l10, h10, s10, r10, f1_10, f2_10, a1_10, a2_10 = self.teacher10_net(
            x_path10, [omic_t, omic_i])
        l20, h20, s20, r20, f1_20, f2_20, a1_20, a2_20 = self.teacher20_net(
            x_path20, [omic_t, omic_i])
        l_teas = combine_logits(l10, l20, self.combination_type)
        h_teas, s_teas, r_teas = survival_chain(l_teas)
        return (
            {"feature1_tea10": f1_10, "feature1_tea20": f1_20,
             "feature2_tea10": f2_10, "feature2_tea20": f2_20},
            {"att1_tea10": a1_10, "att1_tea20": a1_20,
             "att2_tea10": a2_10, "att2_tea20": a2_20},
            {"logits_tea10": l10, "logits_tea20": l20, "logits_teas": l_teas},
            {"hazards_tea10": h10, "hazards_tea20": h20,
             "hazards_teas": h_teas},
            {"S_tea10": s10, "S_tea20": s20, "S_teas": s_teas},
            {"risk_tea10": r10, "risk_tea20": r20, "risk_teas": r_teas},
        )


class StudentsNet(nn.Module):
    """Two-scale pathology-only student ensemble."""

    def __init__(self, label_dim: int, input_path_dim: int = 1024,
                 path_dim: int = 128, sample_ratio: float = 0.0008,
                 combination_type: str = "max_confidence",
                 cpb_table_divisor: int = 0, attn_bf16_streams: bool = False,
                 fused_table_attention: bool = False,
                 cpb_table_bf16: bool = False):
        super().__init__()
        self.combination_type = combination_type
        kw = dict(label_dim=label_dim, input_dim=input_path_dim,
                  path_dim=path_dim, sample_ratio=sample_ratio,
                  cpb_table_divisor=cpb_table_divisor,
                  attn_bf16_streams=attn_bf16_streams,
                  fused_table_attention=fused_table_attention,
                  cpb_table_bf16=cpb_table_bf16)
        self.student10_net = StudentNet(**kw)
        self.student20_net = StudentNet(**kw)

    def forward(self, x_path10, x_path20):
        l10, h10, s10, r10, f10, a10 = self.student10_net(x_path10)
        l20, h20, s20, r20, f20, a20 = self.student20_net(x_path20)
        l_stus = combine_logits(l10, l20, self.combination_type)
        h_stus, s_stus, r_stus = survival_chain(l_stus)
        return (
            {"feature_stu10": f10, "feature_stu20": f20},
            {"att_stu10": a10, "att_stu20": a20},
            {"logits_stu10": l10, "logits_stu20": l20, "logits_stus": l_stus},
            {"hazards_stu10": h10, "hazards_stu20": h20,
             "hazards_stus": h_stus},
            {"S_stu10": s10, "S_stu20": s20, "S_stus": s_stus},
            {"risk_stu10": r10, "risk_stu20": r20, "risk_stus": r_stus},
        )

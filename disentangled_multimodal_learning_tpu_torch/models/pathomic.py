"""Late-fusion and missing-modality pathomic baselines (counterpart of
``disentangled_multimodal_learning_tpu/models/pathomic.py``:
``PathomicNet`` :34, ``PathomicNet_Original`` :67, ``PathomicNet_FG`` :97,
``PathomicNet_Ensemble`` :127).  Each returns JAX's 7-tuple with the
logits ``[path, omic, final]`` at position 3; the loss and the metrics
read ``logits[2]``.

``fusion_type`` ``"concat"`` concatenates the path and omic vectors,
``"add"`` adds them, and anything else fuses them with
:class:`~.fusion.BilinearFusion` (JAX checks for no ``"pofusion"``).
JAX's ``model_inputs`` passes FG and Ensemble ``is_training=train``
(``models/factory.py:144``); here Ensemble reads the module's train mode,
which the train step sets (eval mode under ``deterministic_training``,
where JAX passes ``train=False`` too), and FG, which never reads it,
takes none.
"""

from __future__ import annotations

import torch
from torch import nn

from .fusion import BilinearFusion
from .layers import layer_norm
from .maxnet import MaxNet
from .mil import ABMIL


class _Fusion(nn.Module):
    """The path and omic vectors' fusion of ``fusion_type``; ``out_dim``
    is its width."""

    def __init__(self, fusion_type: str, path_dim: int, omic_dim: int,
                 mmhid: int, dropout_rate: float, skip: int = 0,
                 use_bilinear: int = 1, path_gate: int = 1,
                 omic_gate: int = 1, path_scale: int = 1,
                 omic_scale: int = 1):
        super().__init__()
        self.fusion_type = fusion_type
        if fusion_type == "concat":
            self.out_dim = path_dim + omic_dim
        elif fusion_type == "add":
            self.out_dim = path_dim
        else:
            self.out_dim = mmhid
            self.fusion = BilinearFusion(
                skip=skip, use_bilinear=use_bilinear, gate1=path_gate,
                gate2=omic_gate, dim1=path_dim, dim2=omic_dim,
                scale_dim1=path_scale, scale_dim2=omic_scale, mmhid=mmhid,
                dropout_rate=dropout_rate)

    def fuse(self, path_vec, omic_vec):
        if self.fusion_type == "concat":
            return torch.cat([path_vec, omic_vec], dim=1)
        if self.fusion_type == "add":
            return path_vec + omic_vec
        return self.fusion(path_vec, omic_vec)


class PathomicNet(_Fusion):
    """ABMIL path branch, MaxNet omic branch, their fusion, a classifier."""

    def __init__(self, label_dim: int, input_size_omic: int,
                 input_path_dim: int = 1024, path_dim: int = 128,
                 omic_dim: int = 128, mmhid: int = 128,
                 dropout_rate: float = 0.25, fusion_type: str = "concat",
                 **fusion_kw):
        super().__init__(fusion_type, path_dim, omic_dim, mmhid,
                         dropout_rate, **fusion_kw)
        self.path_net = ABMIL(label_dim, path_dim, L=input_path_dim)
        self.omic_net = MaxNet(input_size_omic, omic_dim, dropout_rate,
                               label_dim)
        self.classifier = nn.Linear(self.out_dim, label_dim)

    def forward(self, x_path, x_omic):
        path_vec, logits_path, _ = self.path_net(x_path)
        omic_vec, logits_omic = self.omic_net(x_omic)
        features = self.fuse(path_vec, omic_vec)
        logits = [logits_path, logits_omic, self.classifier(features)]
        return features, path_vec, omic_vec, logits, None, None, None


class PathomicNet_Original(_Fusion):
    """Mean-pooled path branch: ``path_net`` on the bag's mean, a per-patch
    ``path_classifier`` (its logits ``[B, N, C]``), MaxNet, the fusion and
    a classifier; JAX returns 0 in the other six places."""

    def __init__(self, label_dim: int, input_size_omic: int,
                 input_path_dim: int = 1024, path_dim: int = 128,
                 omic_dim: int = 128, mmhid: int = 128,
                 dropout_rate: float = 0.25, fusion_type: str = "concat",
                 **fusion_kw):
        super().__init__(fusion_type, path_dim, omic_dim, mmhid,
                         dropout_rate, **fusion_kw)
        self.path_net = nn.Linear(input_path_dim, path_dim)
        self.path_classifier = nn.Linear(input_path_dim, label_dim)
        self.omic_net = MaxNet(input_size_omic, omic_dim, dropout_rate,
                               label_dim)
        self.classifier = nn.Linear(self.out_dim, label_dim)

    def forward(self, x_path, x_omic):
        path_vec = self.path_net(x_path.mean(dim=1))
        hazard_path = self.path_classifier(x_path)
        omic_vec, hazard_omic = self.omic_net(x_omic)
        hazard = self.classifier(self.fuse(path_vec, omic_vec))
        return 0, 0, 0, [hazard_path, hazard_omic, hazard], 0, 0, 0


class PathomicNet_FG(nn.Module):
    """Missing modality: a small autoencoder (``ae_down`` 64, LayerNorm,
    ``ae_up`` to ``mmhid``) makes a pseudo-omic vector from the path
    vector; the final logits always read it, never the omic branch."""

    def __init__(self, label_dim: int, input_size_omic: int,
                 input_path_dim: int = 1024, path_dim: int = 128,
                 omic_dim: int = 128, mmhid: int = 128,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.path_net = ABMIL(label_dim, path_dim, L=input_path_dim)
        self.omic_net = MaxNet(input_size_omic, omic_dim, dropout_rate,
                               label_dim)
        self.ae_down = nn.Linear(path_dim, 64)
        self.ae_norm = layer_norm(64)
        self.ae_up = nn.Linear(64, mmhid)
        self.classifier = nn.Linear(path_dim + mmhid, label_dim)

    def forward(self, x_path, x_omic):
        path_vec, logits_path, _ = self.path_net(x_path)
        omic_vec, logits_omic = self.omic_net(x_omic)
        path2omic = self.ae_up(self.ae_norm(self.ae_down(path_vec)))
        features = torch.cat([path_vec, path2omic], dim=1)
        logits = [logits_path, logits_omic, self.classifier(features)]
        return features, path2omic, omic_vec, logits, None, None, None


class PathomicNet_Ensemble(nn.Module):
    """Missing modality: the final logits are the mean of the path and omic
    logits in training, the path logits alone otherwise."""

    def __init__(self, label_dim: int, input_size_omic: int,
                 input_path_dim: int = 1024, path_dim: int = 128,
                 omic_dim: int = 128, mmhid: int = 128,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.path_net = ABMIL(label_dim, path_dim, L=input_path_dim)
        self.omic_net = MaxNet(input_size_omic, omic_dim, dropout_rate,
                               label_dim)

    def forward(self, x_path, x_omic):
        path_vec, logits_path, _ = self.path_net(x_path)
        omic_vec, logits_omic = self.omic_net(x_omic)
        features = torch.cat([path_vec, omic_vec], dim=1)
        final = ((logits_path + logits_omic) / 2 if self.training
                 else logits_path)
        logits = [logits_path, logits_omic, final]
        return features, path_vec, omic_vec, logits, None, None, None

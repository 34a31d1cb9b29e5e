"""Model factory (counterpart of
``disentangled_multimodal_learning_tpu/models/factory.py``).

Unlike the JAX ``define_net``, which sets module globals
(``CPB_TABLE_DIVISOR``, ``ATTN_BF16_STREAMS``, ``FUSED_TABLE_ATTENTION``,
``TBL_BF16_OUT``), the port passes ``cpb_table_divisor``,
``attn_bf16_streams``, ``fused_table_attention`` and ``cpb_table_bf16``
down as constructor arguments.  The attention layout is no config field,
as in JAX (whose backend picks it): :func:`define_net` takes it as the
keyword ``attn_layout`` ("auto", the port's "kn", or "nk").  JAX's
``CPB_KERNEL_VERSION`` has no counterpart: its "v1" and "v5" compute the
same function, and both are kernel K2-nk in the port.

:func:`define_act_layer` and :func:`define_bifusion` are the reference's
factories, which no mode calls (JAX ``factory.py:152``, ``:169``).

The baseline modes (``path``, ``transmil``, ``omic``, the pathomic family,
``mcat`` and ``cmta``) run no kernel of the port: plain torch, as in JAX,
where they reach no Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.weight_init import apply_init_type
from .cmta import CMTA
from .fusion import BilinearFusion
from .deform_mil import DeformPathomicNet
from .maxnet import MaxNet
from .mcat import MCAT_Surv
from .mil import ABMIL, TransMIL
from .pathomic import (PathomicNet, PathomicNet_Ensemble, PathomicNet_FG,
                       PathomicNet_Original)
from .teacher_student import MultiScaleNet, StudentsNet, TeachersNet

# the baselines: no kernel of the port on their path
BASELINES = ("path", "transmil", "omic", "pathomic", "pathomic_original",
             "mcat", "cmta", "pathomic_fg", "pathomic_ensemble")
# the modes of the JAX factory (``models/factory.py:37-127``)
MODES = BASELINES + ("deformpathomic", "multiscale", "teacher", "uniteacher",
                     "student", "distillation")


def full_f32_matmuls() -> None:
    """Make float32 matmuls and convolutions on the card run in full f32,
    forward and backward alike (the flags are global).  cuDNN defaults to
    TF32 (about three decimal digits), which the CPB table build (every bias
    value interpolates from it) and the offset conv cannot take; matmuls
    already default to full f32, and are pinned here too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device where
    there is none, instead of running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; ask for the CPU with device='cpu' (--device cpu)")
    return device


def define_net(cfg, device="cuda", attn_layout: str = "auto"):
    """``cfg`` -> eval-mode model on ``device`` with random weights drawn
    from ``cfg.seed`` by a ``torch.Generator``, every deformable attention
    in ``attn_layout`` (``models/deform_attention.py``); load real weights
    over them with ``utils.jax_params`` or ``utils.checkpoint`` (the same
    weights in either layout).  The train step switches the model to train
    mode (eval mode under ``deterministic_training``).  In distillation
    mode, ``(student, teacher)``, both seeded so, on ``device``."""
    mode = cfg.mode
    if mode == "distillation":
        return (define_net(cfg.replace(mode="student"), device, attn_layout),
                define_net(cfg.replace(mode="teacher"), device, attn_layout))
    if mode not in MODES:
        raise NotImplementedError(f"model [{mode}] is not implemented")
    device = require_device(device)
    full_f32_matmuls()
    if mode in BASELINES:
        model = _baseline(cfg)
    else:
        model = _deform_model(cfg, attn_layout)
    init_weights(model, cfg.seed)
    apply_init_type(model, cfg.init_type, cfg.init_gain, cfg.seed)
    return model.to(device).eval()


def _baseline(cfg) -> nn.Module:
    """The baseline of ``cfg.mode``, with the JAX factory's arguments."""
    mode = cfg.mode
    common = dict(label_dim=cfg.label_dim)
    omic = dict(input_size_omic=cfg.input_size_omic,
                input_path_dim=cfg.input_path_dim, path_dim=cfg.path_dim,
                omic_dim=cfg.omic_dim, mmhid=cfg.mmhid,
                dropout_rate=cfg.dropout_rate, **common)
    if mode == "path":
        return ABMIL(path_dim=cfg.path_dim, L=cfg.input_path_dim, **common)
    if mode == "transmil":
        return TransMIL(path_dim=cfg.path_dim, input_dim=cfg.input_path_dim,
                        **common)
    if mode == "omic":
        return MaxNet(cfg.input_size_omic, cfg.omic_dim, cfg.dropout_rate,
                      cfg.label_dim)
    if mode == "pathomic":
        return PathomicNet(
            fusion_type=cfg.fusion_type, skip=cfg.skip,
            use_bilinear=cfg.use_bilinear, path_gate=cfg.path_gate,
            omic_gate=cfg.omic_gate, path_scale=cfg.path_scale,
            omic_scale=cfg.omic_scale, **omic)
    if mode == "pathomic_original":  # JAX passes no gates or scales
        return PathomicNet_Original(fusion_type=cfg.fusion_type,
                                    skip=cfg.skip,
                                    use_bilinear=cfg.use_bilinear, **omic)
    if mode == "pathomic_fg":
        return PathomicNet_FG(**omic)
    if mode == "pathomic_ensemble":
        return PathomicNet_Ensemble(**omic)
    if mode == "mcat":
        return MCAT_Surv(**common)
    return CMTA(**common)


def _deform_model(cfg, attn_layout: str) -> nn.Module:
    """The teacher, student, multiscale or deformpathomic model."""
    mode = cfg.mode
    common = dict(label_dim=cfg.label_dim, input_path_dim=cfg.input_path_dim,
                  path_dim=cfg.path_dim,
                  cpb_table_divisor=cfg.cpb_table_divisor,
                  attn_bf16_streams=cfg.attn_bf16_streams,
                  fused_table_attention=cfg.fused_table_attention,
                  cpb_table_bf16=cfg.cpb_table_bf16, attn_layout=attn_layout)
    if mode == "deformpathomic":
        model = DeformPathomicNet(
            input_size_omic_tumor=cfg.input_size_omic_tumor,
            input_size_omic_immune=cfg.input_size_omic_immune,
            omic_dim=cfg.omic_dim, dropout_rate=cfg.dropout_rate,
            attn_dim=cfg.attn_dim, return_vgrid=cfg.return_vgrid,
            task_type=cfg.task_type,
            degenerate_1d_sampling=cfg.degenerate_1d_sampling,
            fusion_type=cfg.fusion_type, mmhid=cfg.mmhid, **common)
    elif mode == "multiscale":
        model = MultiScaleNet(
            input_size_omic_tumor=cfg.input_size_omic_tumor,
            input_size_omic_immune=cfg.input_size_omic_immune,
            omic_dim=cfg.omic_dim, dropout_rate=cfg.dropout_rate,
            sample_ratio=cfg.path_cluster_num,
            combination_type=cfg.combination_type_teas, **common)
    elif mode == "student":
        model = StudentsNet(sample_ratio=cfg.path_cluster_num,
                            combination_type=cfg.combination_type_stus,
                            **common)
    else:
        model = TeachersNet(
            input_size_omic_tumor=cfg.input_size_omic_tumor,
            input_size_omic_immune=cfg.input_size_omic_immune,
            omic_dim=cfg.omic_dim, dropout_rate=cfg.dropout_rate,
            combination_type=cfg.combination_type_teas,
            unimodal=mode == "uniteacher", **common)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded init at JAX's scales (not JAX's draws): every weight ~ N(0,
    1/fan_in) (flax's lecun_normal, MaxNet's max_init, and the conv
    filters' 1/fan_in), the cls tokens ~ N(0, 1) (JAX's ``normal(1.0)``;
    a module's ``init_std`` overrides it: CMTA's 1e-6), the bilinear
    fusion weights ~ N(0, 0.02), biases 0, LayerNorm and BatchNorm scales
    1.  The draws come from one CPU ``torch.Generator``, so a seed gives
    the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if p.dim() == 1:
            is_scale = leaf == "weight"  # the only 1-D weights: LN, BN scales
            p.fill_(1.0 if is_scale else 0.0)
            continue
        x = torch.randn(p.shape, generator=g)
        if leaf == "in_proj_weight":  # packed q/k/v, each [d, d]
            x /= math.sqrt(p.shape[1])
        elif leaf == "cls_token":
            x *= getattr(modules[owner], "init_std", {}).get(leaf, 1.0)
        elif leaf.startswith("bilinear_w"):
            x *= 0.02
        else:
            x /= math.sqrt(math.prod(p.shape[1:]))
        p.copy_(x)


def define_act_layer(act_type: str = "Tanh"):
    """The reference's activation by name, as a callable: ``Tanh``,
    ``ReLU``, ``Sigmoid``, ``LSM`` (log-softmax over dim 1); ``none`` ->
    None; any other name raises ``NotImplementedError``."""
    table = {"Tanh": torch.tanh, "ReLU": F.relu, "Sigmoid": torch.sigmoid,
             "LSM": lambda x: F.log_softmax(x, dim=1), "none": None}
    if act_type not in table:
        raise NotImplementedError(f"activation layer [{act_type}] is not "
                                  "found")
    return table[act_type]


def define_bifusion(fusion_type: str, skip=1, use_bilinear=1, gate1=1,
                    gate2=1, dim1=32, dim2=32, scale_dim1=1, scale_dim2=1,
                    mmhid=32, dropout_rate=0.25) -> BilinearFusion:
    """The reference's fusion factory: ``pofusion`` is a
    :class:`BilinearFusion` of these arguments; any other type raises
    ``NotImplementedError``."""
    if fusion_type != "pofusion":
        raise NotImplementedError(f"fusion type [{fusion_type}] is not found")
    return BilinearFusion(skip=skip, use_bilinear=use_bilinear, gate1=gate1,
                          gate2=gate2, dim1=dim1, dim2=dim2,
                          scale_dim1=scale_dim1, scale_dim2=scale_dim2,
                          mmhid=mmhid, dropout_rate=dropout_rate)

"""Model factory (counterpart of
``disentangled_multimodal_learning_tpu/models/factory.py``).

Unlike the JAX ``define_net``, which sets module globals
(``CPB_TABLE_DIVISOR``, ``ATTN_BF16_STREAMS``, ``FUSED_TABLE_ATTENTION``,
``TBL_BF16_OUT``), the port passes ``cpb_table_divisor``,
``attn_bf16_streams``, ``fused_table_attention`` and ``cpb_table_bf16``
down as constructor arguments.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .deform_mil import DeformPathomicNet
from .teacher_student import StudentsNet, TeachersNet

# modes the JAX factory knows, with the ROADMAP (Queue 1) slice that ports each
_LATER = {
    "distillation": "the distillation/multiscale slice",
    "multiscale": "the distillation/multiscale slice",
    **{m: "the baselines slice" for m in (
        "path", "transmil", "omic", "pathomic", "pathomic_original", "mcat",
        "cmta", "pathomic_fg", "pathomic_ensemble")},
}


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


def define_net(cfg, device="cuda") -> nn.Module:
    """``cfg`` -> eval-mode model on ``device`` with random weights drawn
    from ``cfg.seed`` by a ``torch.Generator``; load real weights over them
    with ``utils.jax_params``.  The train step switches the model to train
    mode (eval mode under ``deterministic_training``)."""
    mode = cfg.mode
    if mode in _LATER:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: ROADMAP Queue 1, {_LATER[mode]}")
    if mode not in ("teacher", "uniteacher", "student", "deformpathomic"):
        raise NotImplementedError(f"model [{mode}] is not implemented")
    device = require_device(device)
    full_f32_matmuls()
    common = dict(label_dim=cfg.label_dim, input_path_dim=cfg.input_path_dim,
                  path_dim=cfg.path_dim,
                  cpb_table_divisor=cfg.cpb_table_divisor,
                  attn_bf16_streams=cfg.attn_bf16_streams,
                  fused_table_attention=cfg.fused_table_attention,
                  cpb_table_bf16=cfg.cpb_table_bf16)
    if mode == "deformpathomic":
        model = DeformPathomicNet(
            input_size_omic_tumor=cfg.input_size_omic_tumor,
            input_size_omic_immune=cfg.input_size_omic_immune,
            omic_dim=cfg.omic_dim, dropout_rate=cfg.dropout_rate,
            attn_dim=cfg.attn_dim, return_vgrid=cfg.return_vgrid,
            task_type=cfg.task_type,
            degenerate_1d_sampling=cfg.degenerate_1d_sampling, **common)
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
    init_weights(model, cfg.seed)
    return model.to(device).eval()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded init: every weight ~ N(0, 1/fan_in) (the scale of flax's
    lecun_normal and of MaxNet's max_init), the cls tokens ~ N(0, 1) (JAX's
    ``normal(1.0)``), biases 0, LayerNorms 1/0.  The draws come from one
    CPU ``torch.Generator``, so a seed gives the same weights on every
    device."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 1:
            is_ln_scale = leaf == "weight"  # the only 1-D weights are LN scales
            p.fill_(1.0 if is_ln_scale else 0.0)
            continue
        if leaf == "in_proj_weight":  # packed q/k/v, each [d, d]
            fan_in = p.shape[1]
        elif leaf == "cls_token":
            fan_in = 1
        else:
            fan_in = math.prod(p.shape[1:])
        p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))

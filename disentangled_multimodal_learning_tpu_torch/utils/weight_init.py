"""``init_type`` re-initialisation (counterpart of
``disentangled_multimodal_learning_tpu/utils/weight_init.py
apply_init_type``, applied where JAX's ``init_model_state`` applies it,
``train/trainers.py:47-56``: here in ``models/factory.py define_net``,
after the seeded init).

It changes the leaves JAX changes, not the ones the reference's classname
filter would (``Conv*`` / ``Linear`` / ``BatchNorm2d``, reference
``utils/utils.py:180-242``):

- every weight that is a flax ``kernel`` (ndim >= 2) in the JAX model:
  the Linear weights (``in_proj_weight`` as its three q/k/v kernels), the
  deformable attentions' projections, offset convs and output convs; each
  drawn in JAX's kernel layout with flax's fans, then laid out as torch
  holds it; its module's bias is zeroed;
- every BatchNorm scale ~ N(1, gain), its bias zeroed.

It leaves what JAX holds under other names: the cls tokens, the
bilinear fusion weights, PPEG's filters, the Nystrom ``res_conv``, the
CPB MLPs and the 1-D attention's offset conv (JAX's raw
``offset_conv_kernel``), and the LayerNorms.  ``max`` and ``none`` are
no-ops (``max`` is MaxNet's own init).  The draws come from a CPU
``torch.Generator`` seeded with ``seed``, so they do not depend on the
device; they are not JAX's draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn

VALID_INIT_TYPES = ("max", "none", "normal", "xavier", "kaiming",
                    "orthogonal")


def _fans(shape) -> tuple[int, int]:
    """flax ``variance_scaling``'s fans of a kernel ``[..., in, out]``: the
    leading axes count as receptive field."""
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def _orthogonal(shape, gain: float, g) -> torch.Tensor:
    """flax ``orthogonal(scale, column_axis=-1)``: the kernel as a
    ``[prod(leading), out]`` matrix with orthonormal rows or columns
    (whichever are fewer), times ``gain``."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=g,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (gain * q).reshape(shape).float()


def _draw(shape, init_type: str, gain: float, g) -> torch.Tensor:
    """A kernel of JAX layout ``shape`` drawn per ``init_type`` (torch's
    std semantics, as JAX's ``_initializer`` follows them)."""
    fan_in, fan_out = _fans(shape)
    if init_type == "normal":
        std = gain
    elif init_type == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    elif init_type == "kaiming":  # gain unused, as in the reference
        std = math.sqrt(2.0 / fan_in)
    elif init_type == "orthogonal":
        return _orthogonal(shape, gain, g)
    else:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    return torch.randn(shape, generator=g) * std


def _kernels(module: nn.Module):
    """``(name, kernel shapes in JAX's layout, to_torch)`` of each weight of
    ``module`` (itself, not its children) that JAX holds as ``kernel``
    leaves; ``to_torch`` takes the list of drawn kernels."""
    from ..models.deform_attention import PointwiseConv

    if isinstance(module, nn.MultiheadAttention):
        d = module.embed_dim
        return [("in_proj_weight", [(d, d)] * 3,
                 lambda ks: torch.cat([k.T for k in ks], dim=0))]
    if isinstance(module, nn.Linear):
        o, i = module.weight.shape
        return [("weight", [(i, o)], lambda ks: ks[0].T)]
    if isinstance(module, PointwiseConv):
        o, ci = module.weight.shape[:2]
        kdims = module.weight.shape[2:]
        if module.groups > 1:  # JAX's grouped kernel [G, ci, co]
            gr = module.groups
            return [("weight", [(gr, ci, o // gr)],
                     lambda ks: ks[0].transpose(1, 2).reshape(o, ci, *kdims))]
        return [("weight", [(ci, o)], lambda ks: ks[0].T.reshape(o, ci,
                                                                 *kdims))]
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        w = module.weight
        nd = w.dim() - 2
        shape = (*w.shape[2:], w.shape[1], w.shape[0])  # [*k, in, out]
        return [("weight", [shape],
                 lambda ks: ks[0].permute(nd + 1, nd, *range(nd)))]
    return []


def _held_raw(model: nn.Module) -> set:
    """Names of the modules whose weights JAX holds as raw params (not
    ``kernel`` leaves), so ``apply_init_type`` leaves them."""
    from ..models.deform_attention import CPB, DeformCrossAttention1D
    from ..models.layers import PPEG, NystromAttention

    raw = set()
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, CPB):  # JAX's mlp_{i}_kernel leaves
            raw.update(c for c, _ in m.named_modules(prefix=name))
        elif isinstance(m, PPEG):
            raw.update(f"{prefix}{c}" for c in ("proj", "proj1", "proj2"))
        elif isinstance(m, NystromAttention):
            raw.add(f"{prefix}res_conv")
        elif isinstance(m, DeformCrossAttention1D):
            raw.add(f"{prefix}to_offsets.0")
    return raw


@torch.no_grad()
def apply_init_type(model: nn.Module, init_type: str, init_gain: float = 0.02,
                    seed: int = 0) -> nn.Module:
    """Re-initialise ``model``'s JAX kernels per ``init_type`` and its
    BatchNorms (see the module docstring); no-op for ``max`` and
    ``none``.  Returns ``model``."""
    if init_type in ("max", "none"):
        return model
    if init_type not in VALID_INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    from ..models.fusion import FlaxBatchNorm1d

    g = torch.Generator().manual_seed(seed)
    raw = _held_raw(model)
    for name, m in model.named_modules():
        if isinstance(m, FlaxBatchNorm1d):
            m.weight.copy_(1.0 + init_gain * torch.randn(
                m.weight.shape, generator=g))
            m.bias.zero_()
            continue
        if name in raw:
            continue
        for leaf, shapes, to_torch in _kernels(m):
            w = getattr(m, leaf)
            w.copy_(to_torch([_draw(s, init_type, init_gain, g)
                              for s in shapes]))
            bias = getattr(m, "in_proj_bias" if leaf == "in_proj_weight"
                           else "bias", None)
            if bias is not None:
                bias.zero_()
    return model

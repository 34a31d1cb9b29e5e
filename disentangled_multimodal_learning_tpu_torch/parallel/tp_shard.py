"""Tensor parallelism over the heads and offset groups of the 2-D
deformable attention (counterpart of
``disentangled_multimodal_learning_tpu/parallel/tp_shard.py``).

``DeformCrossAttention2D`` is block-diagonal over its ``G`` offset groups
(one head each): ``to_q``, ``to_k`` and ``to_v`` are grouped 1x1 convs,
each group samples its own channels of ``x2`` at its own offsets, and the
CPB bias has one row block per head.  The heads meet again only in
``to_out``.  In a ``model`` layout of ``tp`` ranks, rank ``t`` computes the
groups ``[t G/tp, (t+1) G/tp)`` of every 2-D attention
(``DeformCrossAttention2D.head_shard``):

- its groups of ``to_q``, ``to_k`` and ``to_v`` (JAX's ``P("model", None,
  None)`` on their kernels) and of ``x2``'s channels for the grid sample;
- their offsets, through the shared depthwise offset conv, and their
  heads' rows of the CPB bias, through the shared CPB MLP (both replicated
  in JAX's specs, ``tp_shard.py:62-90``), so the table kernel K1 (or K2,
  K5 by the divisor; K6 where it runs) launches on ``B * G/tp`` rows;
- its heads' input rows of ``to_out`` (JAX's ``P("model", None)``), whose
  outputs are summed over the ranks (a differentiable all-reduce), with the
  bias added once.
The attention maps (or the vgrids) of all heads are gathered for the
consistency losses.  Everything outside the 2-D attentions runs on every
rank of the group, the 1-D attention too, as in JAX.

Every rank keeps every parameter: the gradient's all-reduce over every rank
sums each rank's share (the grouped weights' own rows, the shared modules'
partial sums, the rest's ``1/tp`` shares; ``parallel/mesh.py``).  JAX turns
its Pallas CPB off under tp (``engage_tp``), because GSPMD cannot split a
``pallas_call``; each rank of the port runs single-device code, so its
kernels stay on (the same function).
"""

from __future__ import annotations

from ..models.deform_attention import DeformCrossAttention2D


def tp_module_names(model) -> list[str]:
    """The 2-D attentions a ``model`` layout splits (JAX
    ``count_tp_modules``: four in the teacher, two in the student)."""
    return [name for name, m in model.named_modules()
            if isinstance(m, DeformCrossAttention2D)]


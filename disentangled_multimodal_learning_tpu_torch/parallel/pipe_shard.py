"""Pipeline parallelism: distillation as a two-stage pipeline (counterpart
of ``disentangled_multimodal_learning_tpu/parallel/pipe_shard.py``).

Distillation runs two models back to back: the frozen teacher's forward,
whose logits and features feed the student's loss.  In a ``stage`` layout
rank 0 of each stage group (stage 0) runs the teacher and rank 1 (stage 1)
the student, on the rows of its data group, split into
``pipe_microbatches`` microbatches: for each, stage 0 computes the teacher's
boundary tensors (two ``[b, C]`` logit blocks and two ``[b, 256]`` feature
blocks) and broadcasts them to stage 1, which runs the student's forward
and backward on it and accumulates the gradient.  The teacher is frozen,
so no gradient crosses the seam; stage 0's gradient is 0, and the
all-reduce of the gradient over every rank gives each rank the step's.

Exactness: every loss term is a sum of per-row terms over a denominator
that the student's parameters do not change (weighted CE's summed class
weights of the GLOBAL batch, or its row count; the KL and MSE terms' global
batch size), computed once from the global batch
(:func:`global_denominators`), so the microbatches' gradients add up to
the unpipelined step's, up to the order of the sums.  Under
``deterministic_training`` each microbatch's student draws the pinned DPC
tie-break noise of its rows of the global batch, so the decomposition is
that of the unpipelined step exactly.  The logging-only ``batchloss`` is a
Gram over the whole batch, which microbatches cannot accumulate: it is
left out of the metrics, as JAX leaves it out, and so is the teacher-output
cache (JAX checks the pipeline first, ``trainers.py:160-164``).  The
schedule is sequential per rank (stage 0 may run ahead by the broadcast's
buffering); JAX's ``M + 1``-tick schedule is the same computation.
"""

from __future__ import annotations

import torch

from ..train import losses as L
from ..train.steps import (MODEL_INPUTS, TASK_LABEL_COL,
                           make_teacher_boundary_fn, task_class_weights)
from . import mesh


def global_denominators(cfg, label) -> tuple:
    """``(d_task, d_batch)`` of the global batch's ``label [B, 12]``: the
    summed CE sample weights (or B where the task has none) and B."""
    cw = task_class_weights(cfg, cfg.task_type)
    B = label.shape[0]
    if cfg.task_type != "survival" and cw is not None:
        w = torch.as_tensor(cw, dtype=torch.float32, device=label.device)
        d_task = w[label[:, int(TASK_LABEL_COL[cfg.task_type])].long()].sum()
    else:
        d_task = torch.tensor(float(B), device=label.device)
    return d_task, torch.tensor(float(B), device=label.device)


def _ce_num(logits, labels, class_weights):
    """The numerator (a sum over rows) of weighted CE."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None].long())[:, 0]
    if class_weights is None:
        return nll.sum()
    w = torch.as_tensor(class_weights, dtype=logits.dtype,
                        device=logits.device)[labels.long()]
    return (w * nll).sum()


def _kl_num(student_logits, teacher_logits, t: float):
    """The numerator of ``losses.distillation_loss``: the summed KL x T^2."""
    soft_targets = torch.softmax(teacher_logits / t, dim=1)
    soft_prob = torch.log_softmax(student_logits / t, dim=1)
    kl = soft_targets * (torch.log(soft_targets.clamp_min(1e-12)) - soft_prob)
    return kl.sum() * t ** 2


def micro_loss(cfg, out, label, boundary, denoms) -> tuple:
    """A microbatch's contribution to the distillation loss, already over
    the global denominators: ``(loss, taskloss, dl, df)``."""
    d_task, d_batch = denoms
    features, _, logits, hazards, S, _ = out
    lt10, lt20, ft10, ft20 = boundary
    cw = task_class_weights(cfg, cfg.task_type)
    tags = ("stu10", "stu20")
    if cfg.task_type == "survival":  # the NLL is a mean: rows x mean
        num = label.shape[0] * sum(
            L.task_loss("survival", hazards=hazards[f"hazards_{t}"],
                        S=S[f"S_{t}"], label=label) for t in tags)
    else:
        y = label[:, int(TASK_LABEL_COL[cfg.task_type])]
        num = sum(_ce_num(logits[f"logits_{t}"], y, cw) for t in tags)
    taskloss = num / d_task
    zero = torch.zeros((), device=label.device)
    dl = df = zero
    t = float(cfg.temperature)
    if cfg.distill_logits:
        dl = (_kl_num(logits["logits_stu10"], lt10, t)
              + _kl_num(logits["logits_stu20"], lt20, t)) / d_batch
    if cfg.distill_feature:
        df = ((((features["feature_stu10"] - ft10) ** 2).sum()
               + ((features["feature_stu20"] - ft20) ** 2).sum())
              / (d_batch * ft10.shape[-1]))
    if cfg.distill_logits and cfg.distill_feature:
        loss = taskloss + 0.01 * dl + 0.01 * df
    elif cfg.distill_logits:
        loss = taskloss + dl
    elif cfg.distill_feature:
        loss = taskloss + df
    else:
        loss = taskloss
    return loss, taskloss, dl, df


def make_pipe_distill_step(model, teacher, cfg, optimizer, scheduler,
                           layout):
    """The pipelined distillation step of this rank of a ``stage`` layout
    (``step(tensors of the global batch) -> metrics``, the same on every
    rank: ``loss``, ``taskloss`` and the distillation terms that are on)."""
    M = max(1, int(cfg.pipe_microbatches or 1))
    stage = layout.inner_index
    teacher_fwd = make_teacher_boundary_fn(teacher)
    inputs = MODEL_INPUTS["student"]
    train_mode = not cfg.deterministic_training
    params = list(model.parameters())
    # stage 0's global rank in this rank's stage group
    src = layout.data_index * layout.inner

    def step(tensors: dict) -> dict:
        B = tensors["label"].shape[0]
        off, b = layout.rows(B)
        if b % M:
            raise ValueError(f"per-rank batch {b} is not divisible by "
                             f"pipe_microbatches={M}")
        mb = b // M
        denoms = global_denominators(cfg, tensors["label"])
        model.train(train_mode)
        optimizer.zero_grad(set_to_none=True)
        acc = torch.zeros(4, device=tensors["label"].device)
        for t in range(M):
            micro = mesh.slice_rows(tensors, off + t * mb, mb)
            with mesh.active(layout, off + t * mb, B):
                if stage == 0:
                    tea = [x.contiguous() for x in teacher_fwd(micro)]
                else:
                    dim = 2 * cfg.path_dim
                    tea = [torch.empty((mb, n), device=acc.device)
                           for n in (cfg.label_dim, cfg.label_dim, dim, dim)]
                for x in tea:
                    mesh.broadcast_(x, src, layout.inner_group)
                if stage == 1:
                    out = model(**{a: micro[k] for a, k in inputs.items()})
                    parts = micro_loss(cfg, out, micro["label"], tea, denoms)
                    parts[0].backward()
                    acc += torch.stack([p.detach() for p in parts])
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.sum_grads(params, layout)
        mesh.all_reduce_(acc, layout.mesh_group)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        # stage 1 of each data group summed its microbatches' shares
        metrics = {"loss": acc[0], "taskloss": acc[1]}
        if cfg.distill_logits:
            metrics["distillloss_logits"] = acc[2]
        if cfg.distill_feature:
            metrics["distillloss_feature"] = acc[3]
        return metrics

    return step

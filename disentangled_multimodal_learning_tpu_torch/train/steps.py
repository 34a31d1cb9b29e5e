"""The teacher and student train steps (counterpart of
``disentangled_multimodal_learning_tpu/train/steps.py``: ``TASK_LABEL_COL``
:30, ``batch_to_arrays`` :38, ``_model_kwargs`` :48, ``task_class_weights``
:100 and the teacher / uniteacher / student branches of ``make_train_step``
:109-322).

One step, in order: the train-mode forward (``TeachersNet`` or
``StudentsNet``); the two-scale task loss (weighted CE, or the survival
NLL) plus, with ``multiscale_attention``, the attention consistency loss
(the teacher's ``omic_domain_scale_loss`` on its four maps, the student's
``1000 * path_batch_loss`` on its two), both on the pre-dropout maps;
``loss.backward()``; for the teachers, with ``gradient_modulate``, the
modulation of both classifiers' weight gradients (JAX modulates no student
gradient); the optimizer step; the per-iteration scheduler step.
``deterministic_training`` runs the forward in eval mode (dropout off, the
DPC noise pinned), the JAX trajectory-parity setting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.contract import LabelCol
from . import losses as L
from .grad_modulate import modulate_kernel_grad

TASK_LABEL_COL = {
    "diag2021": LabelCol.DIAG,
    "grade": LabelCol.GRADE,
    "subtype": LabelCol.SUBTYPE,
    "survival": LabelCol.SURVIVAL_BIN,
}
_TEACHER_INPUTS = ("x_path10", "x_path20", "x_omic_tumor", "x_omic_immune")
# the forward's inputs per mode
MODEL_INPUTS = {"teacher": _TEACHER_INPUTS, "uniteacher": _TEACHER_INPUTS,
                "student": ("x_path10", "x_path20")}


def batch_to_tensors(batch, device) -> dict:
    """Host batch -> the step's tensors on ``device`` (labels as int64)."""
    def to(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, dtype=dtype, non_blocking=True)

    out = {k: to(getattr(batch, k)) for k in _TEACHER_INPUTS + ("x_omic",)}
    out["label"] = to(batch.label, torch.int64)
    return out


def task_class_weights(cfg, task: str):
    """CE class weights for ``task``: none for survival, and none for
    diag2021 under ``external_eval``; grade/subtype stay weighted."""
    if task == "survival" or (task == "diag2021" and cfg.external_eval):
        return None
    return cfg.class_weights


def _two_scale_task_loss(task, label, logits, hazards, S, class_weights,
                         tags):
    return sum(L.task_loss(task, logits=logits[f"logits_{t}"],
                           hazards=hazards[f"hazards_{t}"], S=S[f"S_{t}"],
                           label=label, class_weights=class_weights)
               for t in tags)


def make_train_step(model, cfg, optimizer, scheduler=None):
    """The train step of ``cfg.mode`` (teacher, uniteacher or student):
    ``step(tensors) -> metrics``, a dict of detached 0-d tensors (``loss``,
    ``taskloss`` and, with ``multiscale_attention``, ``batchloss``); read
    them with ``float()`` only where the host needs the value."""
    mode = cfg.mode
    if mode not in MODEL_INPUTS:
        raise NotImplementedError(
            f"mode {mode!r}: the port trains the teacher, the uniteacher and "
            "the student (ROADMAP Queue 1 names the slice of each other mode)")
    student = mode == "student"
    inputs = MODEL_INPUTS[mode]
    tags = ("stu10", "stu20") if student else ("tea10", "tea20")
    task = cfg.task_type
    cw = task_class_weights(cfg, task)
    label_col = int(TASK_LABEL_COL[task])
    train_mode = not cfg.deterministic_training
    modulate = cfg.gradient_modulate and not student
    nets = (("teacher10_net", "tea10"), ("teacher20_net", "tea20"))
    params = list(model.parameters())

    def train_step(tensors: dict) -> dict:
        model.train(train_mode)
        optimizer.zero_grad(set_to_none=True)
        label = tensors["label"]
        features, atts, logits, hazards, S, _ = model(
            **{k: tensors[k] for k in inputs})
        taskloss = _two_scale_task_loss(task, label, logits, hazards, S, cw,
                                        tags)
        loss = taskloss
        metrics = {"taskloss": taskloss.detach()}
        if cfg.multiscale_attention:
            if student:
                batchloss = 1000.0 * L.path_batch_loss(atts["att_stu10"],
                                                       atts["att_stu20"])
            else:
                batchloss = L.omic_domain_scale_loss(
                    atts["att1_tea10"], atts["att1_tea20"],
                    atts["att2_tea10"], atts["att2_tea20"])
            loss = loss + batchloss
            metrics["batchloss"] = batchloss.detach()
        loss.backward()
        # a parameter the loss does not reach (the MaxNets' classifiers)
        # gets a zero gradient, so the optimizer still decays it, as optax
        # does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if modulate:
            y = label[:, label_col]
            for net, tag in nets:
                cls = getattr(model, net).classifier
                cls.weight.grad = modulate_kernel_grad(
                    cls.weight.grad, features[f"feature1_{tag}"].detach(),
                    features[f"feature2_{tag}"].detach(), cls.weight.detach(),
                    cls.bias.detach(), y)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics["loss"] = loss.detach()
        return metrics

    return train_step

"""Held-out evaluation of the teacher, the student and deformpathomic
(counterpart of ``disentangled_multimodal_learning_tpu/train/evaluation.py:41
Evaluator``, ``distill_val`` :78, ``fused_val`` :176): the deterministic
forward over a loader, softmax of the logits on the host, and the seven
classification metrics per tag (deformpathomic: one tag, ``fused``, the
fused logits ``logits[2]``)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.contract import LabelCol
from .metrics import compute_avg_metrics
from .steps import MODEL_INPUTS

METRIC_NAMES = ("acc", "f1", "auc", "bac", "sens", "spec", "prec")
# the logits tags evaluated per model type (JAX distill_val :81-86; the
# fused logits of fused_val)
TAGS = {"teacher": ("tea10", "tea20", "teas"),
        "student": ("stu10", "stu20", "stus"),
        "fused": ("fused",)}
_LABEL_COL = {"diag2021": LabelCol.DIAG, "grade": LabelCol.GRADE,
              "subtype": LabelCol.SUBTYPE}


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def model_inputs(batch, device, mode: str) -> dict:
    """Host batch -> the forward kwargs of ``mode``'s model on ``device``."""
    return {arg: torch.from_numpy(np.ascontiguousarray(getattr(batch, key)))
            .to(device, non_blocking=True)
            for arg, key in MODEL_INPUTS[mode].items()}


class Evaluator:
    """Metrics of ``model`` (a ``cfg.mode`` model) on ``device`` over the
    tags of ``model_type`` (``teacher``, ``student`` or ``fused``)."""

    def __init__(self, model, cfg, device, model_type: str):
        if cfg.task_type not in _LABEL_COL:
            raise NotImplementedError(
                f"task_type {cfg.task_type!r}: the port evaluates the "
                "classification tasks; survival (c-index) comes with the "
                "checkpoints and survival evaluation")
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.tags = TAGS[model_type]
        self.fused = model_type == "fused"

    @torch.inference_mode()
    def step(self, batch) -> dict:
        """One deterministic forward -> the logits dict, as host numpy.  The
        attention maps are not copied back (``need_attention=False``)."""
        out = self.model(**model_inputs(batch, self.device, self.cfg.mode))
        logits = {"logits_fused": out[3][2]} if self.fused else out[2]
        return {k: v.float().cpu().numpy() for k, v in logits.items()}

    def logits(self, loader):
        """All batches -> (per-tag logits ``[M, C]`` with the loader's padded
        duplicates stripped, labels ``[M, 12]``)."""
        outs, labels = [], []
        for batch in loader:
            out = self.step(batch)
            keep = batch.label.shape[0] - batch.pad
            outs.append({k: v[:keep] for k, v in out.items()})
            labels.append(batch.label[:keep])
        return ({k: np.concatenate([o[k] for o in outs]) for k in outs[0]},
                np.concatenate(labels))

    def metrics(self, logits, labels) -> dict:
        """``{f"{metric}_{tag}": value}`` for every metric and tag, the keys
        of the JAX ``distill_val`` dicts."""
        y = labels[:, _LABEL_COL[self.cfg.task_type]]
        out = {}
        for t in self.tags:
            vals = compute_avg_metrics(y, _softmax_np(logits[f"logits_{t}"]))
            out.update({f"{n}_{t}": v for n, v in zip(METRIC_NAMES, vals)})
        return out

"""Held-out evaluation of the teacher, the student (plain or distilled),
multiscale, deformpathomic and the baselines (counterpart of
``disentangled_multimodal_learning_tpu/train/evaluation.py:41
Evaluator``, ``distill_val`` :78, ``export_attention_maps`` :110,
``fused_val`` :176, ``simple_val`` :192, ``save_roc_csv`` :219): the
deterministic forward over a loader, then per tag (deformpathomic and the
pathomic family: one tag, ``fused``, the fused output ``logits[2]``;
``path``, ``transmil``, ``omic``, ``mcat`` and ``cmta``: one tag,
``simple``, their logits ``out[1]`` (``out[0]`` for MCAT and CMTA))

- on the classification tasks, softmax of the logits on the host and the
  seven metrics, and with ``save4roc`` each tag's scores in
  ``roc_{tag}_fold{k}.csv`` (teacher and student tags, as in JAX);
- on survival, the c-index of the model's risks (``out[5]``; the fused
  tag: ``-sum(cumprod(1 - fused))``, its output read as hazards; MCAT and
  CMTA: ``-sum(S)`` of their ``S``) against the censorships and times.
  ``path``, ``transmil`` and ``omic`` have no survival output (JAX's
  ``simple_val`` reads ``o[2]``, which is ``None`` for them, and fails),
  so their evaluator refuses the survival task.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..data.contract import LabelCol
from ..models.deform_attention import DeformCrossAttention2D, attn_kv_axis
from ..utils import profiling
from .metrics import cindex, compute_avg_metrics
from .steps import MODEL_INPUTS, arrays_to_device

METRIC_NAMES = ("acc", "f1", "auc", "bac", "sens", "spec", "prec")
# the logits tags evaluated per model type (JAX distill_val :81-86; the
# fused logits of fused_val; the logits of simple_val)
TAGS = {"teacher": ("tea10", "tea20", "teas"),
        "student": ("stu10", "stu20", "stus"),
        # the multiscale model's teachers and students; its headline is the
        # combined student (JAX evaluation.py:81-86, trainers.py:209-213)
        "scales": ("tea10", "tea20", "stu10", "stu20", "stus"),
        "fused": ("fused",), "simple": ("simple",)}
# the baselines whose simple_val output is o[1] (the others': o[0])
_LOGITS_AT_1 = ("path", "transmil", "omic")
_LABEL_COL = {"diag2021": LabelCol.DIAG, "grade": LabelCol.GRADE,
              "subtype": LabelCol.SUBTYPE}


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def model_type_of(mode: str) -> str:
    """The tags a ``mode``'s model is evaluated on (JAX ``Evaluator.__call__``
    :227-236): ``teacher``, ``student``, ``scales``, ``fused`` or
    ``simple``."""
    if mode in ("teacher", "uniteacher"):
        return "teacher"
    if mode in ("student", "distillation"):
        return "student"
    if mode == "multiscale":
        return "scales"
    if mode in ("deformpathomic", "pathomic", "pathomic_original",
                "pathomic_fg", "pathomic_ensemble"):
        return "fused"
    return "simple"


def headline_metrics(tags, survival: bool, result: dict) -> dict:
    """JAX's flat metrics (``trainers.py:318-336 _metricdicts_to_flat``)
    from ``{f"{metric}_{tag}": value}``: the last (headline) tag's seven
    metrics, or on survival its ``cindex`` followed, where there are
    several tags, by every tag's ``cindex_{tag}``."""
    headline = tags[-1]
    if survival:
        flat = {"cindex": result[f"cindex_{headline}"]}
        if len(tags) > 1:
            flat.update(result)
        return flat
    return {n: result[f"{n}_{headline}"] for n in METRIC_NAMES}


def model_inputs(batch, device, mode: str) -> dict:
    """Host batch -> the forward kwargs of ``mode``'s model on ``device``,
    by ``steps.arrays_to_device`` (on a card, staged through pinned
    memory)."""
    return arrays_to_device({arg: getattr(batch, key) for arg, key
                             in MODEL_INPUTS[mode].items()}, {}, device)


def export_dir(cfg) -> str:
    """Where the evaluation's exports go: ``cfg.checkpoints``, or the
    working directory where checkpoints are off."""
    return cfg.checkpoints if cfg.checkpoints not in ("#", "") else "."


class Evaluator:
    """Metrics of ``model`` (a ``cfg.mode`` model; in distillation mode the
    student) on ``device`` over the tags of ``model_type`` (``teacher``,
    ``student``, ``scales``, ``fused`` or ``simple``)."""

    def __init__(self, model, cfg, device, model_type: str):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.tags = TAGS[model_type]
        self.model_type = model_type
        self.fused = model_type == "fused"
        self.survival = cfg.task_type == "survival"
        if model_type == "simple" and self.survival and (
                cfg.mode in _LOGITS_AT_1):
            raise NotImplementedError(
                f"mode {cfg.mode!r} has no survival output to rank by: its "
                "model returns (features, logits) with no hazards or S, and "
                "JAX's simple_val, which reads S from o[2] (None there), "
                "fails on it too")

    @torch.inference_mode()
    def step(self, batch) -> dict:
        """One deterministic forward -> the logits dict (and on survival
        the risks, ``risk_<tag>``), as host numpy; the attention maps are
        not copied back.  Inside an ``eval_batch`` span, the forward
        between the device marks ``forward.start`` and ``forward.end``."""
        with profiling.span("eval_batch"):
            inputs = model_inputs(batch, self.device, self.cfg.mode)
            profiling.device_mark("forward.start", self.device)
            out = self.model(**inputs)
            profiling.device_mark("forward.end", self.device)
            if self.fused:
                res = {"logits_fused": out[3][2]}
            elif self.model_type == "simple":
                at_1 = self.cfg.mode in _LOGITS_AT_1
                res = {"logits_simple": out[1] if at_1 else out[0]}
                if self.survival:
                    res["risk_simple"] = -out[2].sum(dim=1)
            else:
                res = {**out[2], **out[5]} if self.survival else out[2]
            return {k: v.float().cpu().numpy() for k, v in res.items()}

    def logits(self, loader):
        """All batches -> (per-tag outputs ``[M, ...]`` with the loader's
        padded duplicates stripped, labels ``[M, 12]``)."""
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
        of the JAX ``distill_val`` dicts (survival: ``cindex_{tag}``)."""
        if self.survival:
            censor = labels[:, LabelCol.CENSOR]
            times = labels[:, LabelCol.SURVIVAL_TIME]
            if self.fused:
                fused = logits["logits_fused"]
                return {"cindex_fused": cindex(
                    -np.cumprod(1.0 - fused, axis=1).sum(axis=1), censor,
                    times)}
            return {f"cindex_{t}": cindex(logits[f"risk_{t}"], censor, times)
                    for t in self.tags}
        y = labels[:, _LABEL_COL[self.cfg.task_type]]
        out = {}
        for t in self.tags:
            probs = _softmax_np(logits[f"logits_{t}"])
            vals = compute_avg_metrics(y, probs)
            out.update({f"{n}_{t}": v for n, v in zip(METRIC_NAMES, vals)})
            if self.cfg.save4roc and self.model_type not in ("fused",
                                                             "simple"):
                base = export_dir(self.cfg)
                os.makedirs(base, exist_ok=True)
                save_roc_csv(os.path.join(
                    base, f"roc_{t}_fold{self.cfg.cur_fold}.csv"), y, probs)
        return out

    @torch.inference_mode()
    def export_attention_maps(self, loader, path: str) -> str:
        """Write the npz JAX writes (reference train_test.py:1121-1177):
        for every attention map of the teacher or student, ``att_<key>``
        ``[M, N]``, its per-head max then its mean over the kv axis of the
        model's layout; ``scores`` (the combined logits, ``teas`` or
        ``stus``), ``labels`` (the task's column), ``wsi_ids``, and
        ``attention``, the first map's alias."""
        layouts = {m.layout for m in self.model.modules()
                   if isinstance(m, DeformCrossAttention2D)}
        kv_ax = attn_kv_axis(layouts.pop())
        col = (LabelCol.SURVIVAL_BIN if self.survival
               else _LABEL_COL[self.cfg.task_type])
        maps: dict[str, list] = {}
        scores, labels, ids = [], [], []
        for batch in loader:
            out = self.model(**model_inputs(batch, self.device, self.cfg.mode))
            atts, logits = out[1], out[2]
            keep = batch.label.shape[0] - batch.pad
            for key in sorted(atts):
                att = atts[key][:keep].float().amax(dim=1).mean(dim=kv_ax)
                maps.setdefault(key, []).append(att.cpu().numpy())
            score_key = sorted(k for k in logits
                               if k.endswith(("stus", "teas")))[-1]
            scores.append(logits[score_key][:keep].float().cpu().numpy())
            labels.append(batch.label[:keep, col])
            ids.extend(list(batch.wsi_id)[:keep])
        arrays = {"scores": np.concatenate(scores),
                  "labels": np.concatenate(labels),
                  "wsi_ids": np.asarray(ids)}
        for key, chunks in maps.items():
            arrays[f"att_{key}"] = np.concatenate(chunks)
        arrays["attention"] = arrays[f"att_{sorted(maps)[0]}"]
        np.savez(path, **arrays)
        return path


def save_roc_csv(path: str, ground_truth, activations) -> None:
    """A header ``label,score_0,...`` and one row a sample (reference
    train_test.py:1095-1119)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label"] + [f"score_{i}"
                                for i in range(activations.shape[1])])
        for y, row in zip(ground_truth, activations):
            w.writerow([int(y)] + [float(v) for v in row])

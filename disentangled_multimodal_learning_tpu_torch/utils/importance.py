"""Gene importance on the port's eval forward (counterpart of
``disentangled_multimodal_learning_tpu/utils/importance.py``):

- ablation importance (one gene column zeroed at a time) and permutation
  importance (one column shuffled, ``n_trials`` times), each the drop of a
  score such as :func:`make_omic_score_fn`'s accuracy;
- integrated gradients (midpoint rule) and expected-gradients SHAP (IG
  averaged over baselines drawn from a background set), with
  ``torch.autograd.grad`` of the summed per-sample logit with respect to
  the omic input; :func:`integrated_gradients_importance` and
  :func:`deep_shap_importance` reduce them to a mean ``|attribution|``
  per gene over the evaluation set (its own background, as the
  reference's DeepExplainer workflow);
- :func:`export_gene_importance`, the reference's two CSVs.

Only ``x_omic`` is perturbed or attributed, as in JAX.  So a model that
reads no ``x_omic`` gets exactly zero attributions (deformpathomic reads
only the tumor and immune omics); and the modes whose eval output JAX
reads the logits of at a place that is not there (``teacher``,
``uniteacher``, ``student``, ``multiscale``, ``distillation``: ``out[3]``
is a dict of features, ``[2]`` a KeyError; ``path`` and ``transmil``:
``out[3]`` an IndexError) raise ``NotImplementedError``.  The numpy
generators are drawn in JAX's order, so a seed gives both packages the same
shuffles and baselines.
"""

from __future__ import annotations

import csv
import os
from typing import Callable

import numpy as np
import torch

from ..data.contract import LabelCol
from ..train.evaluation import model_inputs

# the task's label column (JAX importance.py:160-162)
_COL = {"diag2021": LabelCol.DIAG, "grade": LabelCol.GRADE,
        "subtype": LabelCol.SUBTYPE, "survival": LabelCol.SURVIVAL_BIN}
# the modes whose eval output has no logits where JAX reads them -> why
_NO_LOGITS = dict.fromkeys(
    ("teacher", "uniteacher", "student", "multiscale", "distillation"),
    "its eval output (features, attention, logits, ...) is a tuple of "
    "dicts, so JAX's out[3][2] raises KeyError")
_NO_LOGITS.update(dict.fromkeys(
    ("path", "transmil"), "its eval output is (features, logits, None), so "
    "JAX's out[3][2] raises IndexError (and it reads no x_omic)"))


def ablation_feature_importance(score_fn: Callable[[np.ndarray], float],
                                x_omic: np.ndarray) -> np.ndarray:
    """Per gene, ``score_fn(x_omic)`` minus the score with that gene's
    column zeroed."""
    base = score_fn(x_omic)
    imp = np.zeros(x_omic.shape[1], dtype=np.float64)
    for g in range(x_omic.shape[1]):
        ablated = x_omic.copy()
        ablated[:, g] = 0.0
        imp[g] = base - score_fn(ablated)
    return imp


def permutation_feature_importance(score_fn: Callable[[np.ndarray], float],
                                   x_omic: np.ndarray, n_trials: int = 3,
                                   seed: int = 0) -> np.ndarray:
    """Per gene, the mean score drop over ``n_trials`` shuffles of its
    column (``np.random.default_rng(seed)``, genes in order)."""
    rng = np.random.default_rng(seed)
    base = score_fn(x_omic)
    imp = np.zeros(x_omic.shape[1], dtype=np.float64)
    for g in range(x_omic.shape[1]):
        drops = []
        for _ in range(n_trials):
            shuffled = x_omic.copy()
            rng.shuffle(shuffled[:, g])
            drops.append(base - score_fn(shuffled))
        imp[g] = float(np.mean(drops))
    return imp


def export_gene_importance(importance: np.ndarray, gene_list,
                           out_dir: str = ".", top_k: int = 2) -> dict:
    """``difference_acc_list.csv`` (header ``0``, one score a row) and
    ``gene_importance.csv`` (header ``0``, the ``top_k`` genes by
    descending score) in ``out_dir``; returns ``{"scores": path, "genes":
    path}``."""
    os.makedirs(out_dir, exist_ok=True)
    scores_path = os.path.join(out_dir, "difference_acc_list.csv")
    with open(scores_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["0"])
        for v in importance:
            w.writerow([float(v)])
    order = np.argsort(importance)[::-1]
    genes_path = os.path.join(out_dir, "gene_importance.csv")
    with open(genes_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["0"])
        for i in order[:top_k]:
            w.writerow([gene_list[int(i)]])
    return {"scores": scores_path, "genes": genes_path}


def integrated_gradients(logit_fn: Callable, x_omic, baseline=None,
                         steps: int = 32) -> np.ndarray:
    """Integrated gradients of ``logit_fn`` (``[M, G] -> [M]``) at
    ``x_omic`` (numpy or a tensor on the model's device) from ``baseline``
    (default zeros): the gradients at the midpoints ``(i + 0.5) / steps``
    of the path, summed in that order, times ``(x - baseline) / steps``.
    Returns numpy ``[M, G]``, whose rows sum to about ``f(x) -
    f(baseline)``.  A ``logit_fn`` that does not read its input gets
    zeros."""
    x = torch.as_tensor(x_omic)
    if isinstance(baseline, np.ndarray):  # a broadcast view is read-only
        baseline = np.ascontiguousarray(baseline)
    x0 = (torch.zeros_like(x) if baseline is None
          else torch.as_tensor(baseline, dtype=x.dtype, device=x.device))
    alphas = (torch.arange(steps, dtype=x.dtype, device=x.device) + 0.5) / steps
    total = torch.zeros_like(x)
    with torch.enable_grad():
        for a in alphas:
            xi = (x0 + a * (x - x0)).requires_grad_()
            g, = torch.autograd.grad(logit_fn(xi).sum(), xi,
                                     allow_unused=True)
            if g is not None:
                total = total + g
    return ((x - x0) * total / steps).detach().cpu().numpy()


def expected_gradients_shap(logit_fn: Callable, x, background,
                            n_baselines: int = 8, steps: int = 16,
                            seed: int = 0) -> np.ndarray:
    """Expected-gradients SHAP: the mean of :func:`integrated_gradients`
    from ``min(n_baselines, len(background))`` rows of ``background``
    drawn by ``np.random.default_rng(seed).choice`` without replacement
    (each broadcast over ``x``'s rows).  Returns float64 ``[M, G]``, whose
    rows sum to about ``f(x) - mean f(baselines)``."""
    rng = np.random.default_rng(seed)
    background = np.asarray(background)
    n = min(n_baselines, len(background))
    idx = rng.choice(len(background), size=n, replace=n > len(background))
    acc = np.zeros(tuple(x.shape), dtype=np.float64)
    for i in idx:
        base = np.broadcast_to(background[i], tuple(x.shape))
        acc += integrated_gradients(logit_fn, x, baseline=base, steps=steps)
    return acc / n


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _check_mode(cfg) -> None:
    if cfg.mode in _NO_LOGITS:
        raise NotImplementedError(
            f"gene importance of mode {cfg.mode!r}: {_NO_LOGITS[cfg.mode]}")


def logits_of(mode: str, out):
    """The logits JAX's importance reads from an eval output: ``out[1]``
    for ``omic``, ``out[0]`` for MCAT and CMTA, the fused ``out[3][2]``
    otherwise."""
    if mode == "omic":
        return out[1]
    if mode in ("mcat", "cmta"):
        return out[0]
    return out[3][2]


def true_class_logit_fn(model, cfg, batch):
    """``x_omic -> [B]``: the eval forward of ``batch`` with its omic input
    replaced, the true-class logit per sample."""
    _check_mode(cfg)
    device = _device(model)
    inputs = model_inputs(batch, device, cfg.mode)
    y = torch.as_tensor(batch.label[:, _COL[cfg.task_type]],
                        dtype=torch.int64, device=device)
    rows = torch.arange(len(y), device=device)

    def logit_fn(x_omic):
        kw = dict(inputs)
        if "x_omic" in kw:
            kw["x_omic"] = x_omic
        return logits_of(cfg.mode, model(**kw))[rows, y]

    return logit_fn


def _without_pad(a: np.ndarray, batch) -> np.ndarray:
    pad = getattr(batch, "pad", 0)
    return a[: a.shape[0] - pad] if pad else a


def integrated_gradients_importance(model, cfg, batches,
                                    steps: int = 32) -> np.ndarray:
    """Per gene, the mean ``|IG|`` of the true-class logit over every bag
    of ``batches`` (padded rows dropped), ``model`` in eval mode on its
    own device."""
    model.eval()
    out = []
    for b in batches:
        ig = integrated_gradients(true_class_logit_fn(model, cfg, b),
                                  torch.as_tensor(b.x_omic,
                                                  device=_device(model)),
                                  steps=steps)
        out.append(_without_pad(ig, b))
    return np.abs(np.concatenate(out, axis=0)).mean(axis=0)


def deep_shap_importance(model, cfg, batches, n_baselines: int = 8,
                         steps: int = 16, seed: int = 0) -> np.ndarray:
    """Per gene, the mean ``|SHAP|`` (:func:`expected_gradients_shap` of
    the true-class logit) over every bag of ``batches`` (padded rows
    dropped), the background being all of the batches' omic rows (the
    padded ones included, as in JAX)."""
    model.eval()
    background = np.concatenate([np.asarray(b.x_omic) for b in batches])
    out = []
    for b in batches:
        phi = expected_gradients_shap(
            true_class_logit_fn(model, cfg, b),
            torch.as_tensor(b.x_omic, device=_device(model)), background,
            n_baselines=n_baselines, steps=steps, seed=seed)
        out.append(_without_pad(phi, b))
    return np.abs(np.concatenate(out, axis=0)).mean(axis=0)


def make_omic_score_fn(model, cfg, batches) -> Callable[[np.ndarray], float]:
    """``x_omic [M, G] -> accuracy``: the eval forward of ``batches`` (their
    path inputs fixed, ``M`` their rows in order) with the omic rows
    replaced, argmax against the task's labels (padded rows counted, as in
    JAX)."""
    _check_mode(cfg)
    model.eval()
    device = _device(model)
    fixed = [model_inputs(b, device, cfg.mode) for b in batches]
    labels = [np.asarray(b.label[:, _COL[cfg.task_type]]) for b in batches]
    sizes = np.cumsum([0] + [len(y) for y in labels])

    @torch.inference_mode()
    def score_fn(x_omic: np.ndarray) -> float:
        correct = 0
        for i, inputs in enumerate(fixed):
            kw = dict(inputs)
            if "x_omic" in kw:
                kw["x_omic"] = torch.as_tensor(
                    x_omic[sizes[i]: sizes[i + 1]],
                    dtype=inputs["x_omic"].dtype, device=device)
            pred = logits_of(cfg.mode, model(**kw)).argmax(dim=-1)
            correct += int((pred.cpu().numpy() == labels[i]).sum())
        return correct / max(int(sizes[-1]), 1)

    return score_fn

"""Classification metrics and the survival c-index in numpy (port of the
numpy branch of ``compute_avg_metrics``,
``disentangled_multimodal_learning_tpu/train/metrics.py:84``, and of
``concordance_index_censored`` :127 and ``cindex`` :157; no sklearn, no
sksurv), with the reference metrics no evaluation calls: ``make_one_hot``
:164, ``compute_confusion_matrix`` :170, ``compute_avg_metrics_micro``
:183 and ``cindex_lifelines`` :216 (no lifelines)."""

from __future__ import annotations

import numpy as np


def _confusion(y_true, y_pred, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)), 1)
    return cm


def sensitivity_macro(y_true, y_pred, n_classes) -> float:
    """Macro recall over the classes present in ``y_true``."""
    cm = _confusion(y_true, y_pred, n_classes)
    support = cm.sum(axis=1)
    present = support > 0
    if not present.any():
        return 0.0
    return float((np.diag(cm)[present] / support[present]).mean())


def specificity_macro(y_true, y_pred, n_classes) -> float:
    """Mean over classes of TN / (TN + FP)."""
    cm = _confusion(y_true, y_pred, n_classes)
    total = cm.sum()
    specs = []
    for k in range(n_classes):
        tp = cm[k, k]
        fp = cm[:, k].sum() - tp
        fn = cm[k, :].sum() - tp
        tn = total - tp - fp - fn
        specs.append(tn / (tn + fp) if tn + fp > 0 else 0.0)
    return float(np.mean(specs))


def _auc_binary(y_true, score) -> float:
    """Rank-based ROC-AUC (Mann-Whitney U); ties get half credit."""
    pos = score[y_true == 1]
    neg = score[y_true == 0]
    if len(pos) == 0 or len(neg) == 0:
        return np.nan
    scores = np.concatenate([pos, neg])
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(order), dtype=np.float64)
    i, n = 0, len(order)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i: j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    n_pos, n_neg = len(pos), len(neg)
    return float((ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def auc_ovr_macro(y_true, probs) -> float:
    """One-vs-rest macro AUC over the classes that are neither absent nor
    the only class."""
    if probs.ndim == 1 or probs.shape[1] == 1:
        return _auc_binary(y_true, probs.ravel())
    aucs = []
    for k in range(probs.shape[1]):
        mask = (y_true == k).astype(np.int64)
        if 0 < mask.sum() < len(mask):
            aucs.append(_auc_binary(mask, probs[:, k]))
    return float(np.mean(aucs)) if aucs else 0.0


def compute_avg_metrics(ground_truth, activations):
    """(acc, f1_macro, auc_ovr, bac, sens_macro, spec_macro, prec_macro)
    from labels ``[M]`` and class probabilities ``[M, C]``."""
    y = np.asarray(ground_truth).astype(np.int64)
    probs = np.asarray(activations, dtype=np.float64)
    pred = probs.argmax(-1)
    n_classes = probs.shape[1]
    acc = float((pred == y).mean())
    cm = _confusion(y, pred, n_classes)
    recalls, precisions, f1s = [], [], []
    for k in range(n_classes):
        tp = cm[k, k]
        r = tp / cm[k].sum() if cm[k].sum() else 0.0
        p = tp / cm[:, k].sum() if cm[:, k].sum() else 0.0
        recalls.append(r)
        precisions.append(p)
        f1s.append(2 * p * r / (p + r) if p + r else 0.0)
    present = cm.sum(1) > 0
    f1 = float(np.mean(f1s))
    bac = float(np.asarray(recalls)[present].mean())
    prec = float(np.mean(precisions))
    auc = auc_ovr_macro(y, probs)
    sens = sensitivity_macro(y, pred, n_classes)
    spec = specificity_macro(y, pred, n_classes)
    return acc, f1, auc, bac, sens, spec, prec


def concordance_index_censored(event_indicator, event_time, risk_score,
                               tied_tol: float = 1e-8) -> float:
    """Harrell's censored concordance index with sksurv's semantics: the
    comparable pairs are (i, j) with an event at i and ``time_i <
    time_j``, or tied times where j is censored; a pair is concordant when
    ``risk_i > risk_j``, and a risk difference within ``tied_tol`` counts
    0.5.  0.0 when no pair is comparable."""
    ev = np.asarray(event_indicator).astype(bool)
    t = np.asarray(event_time, dtype=np.float64)
    r = np.asarray(risk_score, dtype=np.float64)
    ti, tj = t[:, None], t[None, :]
    comparable = ev[:, None] & ((tj > ti) | ((tj == ti) & ~ev[None, :]))
    np.fill_diagonal(comparable, False)
    n_comp = int(comparable.sum())
    if n_comp == 0:
        return 0.0
    d = r[:, None] - r[None, :]
    tied = int((comparable & (np.abs(d) <= tied_tol)).sum())
    concordant = int((comparable & (d > tied_tol)).sum())
    return float((concordant + 0.5 * tied) / n_comp)


def cindex(all_risk_scores, all_censorships, all_event_times) -> float:
    """The c-index of risks against censorships (1 = censored) and times."""
    return concordance_index_censored(
        (1 - np.asarray(all_censorships)).astype(bool), all_event_times,
        all_risk_scores)


def make_one_hot(data, n: int = 0) -> np.ndarray:
    """Integer labels ``[M]`` -> int16 one-hot ``[M, n]`` (``n`` 0: the
    largest label + 1)."""
    num = n if n else int(np.max(data) + 1)
    return (np.arange(num) == np.asarray(data)[:, None]).astype(np.int16)


def compute_confusion_matrix(ground_truth, activations, labels) -> np.ndarray:
    """The confusion matrix of the labels against the argmax of
    ``activations``, rows and columns in the order of ``labels``; a pair
    with a label outside ``labels`` is not counted."""
    y = np.asarray(ground_truth).astype(np.int64)
    pred = np.asarray(activations).argmax(-1)
    n = len(labels)
    cm = np.zeros((n, n), dtype=np.int64)
    index = {int(l): i for i, l in enumerate(labels)}
    for t, p in zip(y, pred):
        if int(t) in index and int(p) in index:
            cm[index[int(t)], index[int(p)]] += 1
    return cm


def compute_avg_metrics_micro(ground_truth, activations):
    """Micro-averaged (acc, f1, auc, bac, sens, spec, prec): the AUC of the
    raveled one-hot labels against the raveled probabilities; micro
    precision, recall and F1 all equal the accuracy; specificity pools TN
    and FP over the classes; bac is the macro recall over the classes
    present."""
    y = np.asarray(ground_truth).astype(np.int64)
    probs = np.asarray(activations, dtype=np.float64)
    pred = probs.argmax(-1)
    n_classes = probs.shape[1]
    acc = float((pred == y).mean())
    auc = _auc_binary(make_one_hot(y, n=n_classes).ravel(), probs.ravel())
    cm = _confusion(y, pred, n_classes)
    prec = rec = f1 = np.diag(cm).sum() / max(cm.sum(), 1)
    total = cm.sum()
    tn_sum = fp_sum = 0
    for k in range(n_classes):
        tpk = cm[k, k]
        fpk = cm[:, k].sum() - tpk
        fnk = cm[k, :].sum() - tpk
        tn_sum += total - tpk - fpk - fnk
        fp_sum += fpk
    spec = tn_sum / max(tn_sum + fp_sum, 1)
    bac = float(np.mean([cm[k, k] / cm[k].sum() for k in range(n_classes)
                         if cm[k].sum()]))
    return acc, f1, auc, bac, rec, spec, prec


def cindex_lifelines(hazards, event_all, survtime_all) -> float:
    """The reference's ``CIndex_lifeline``: the c-index of ``hazards`` as
    risks against the events (1 = event) and times."""
    return concordance_index_censored(np.asarray(event_all).astype(bool),
                                      survtime_all, np.asarray(hazards))

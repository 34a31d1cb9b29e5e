"""The numbers that decide ``correct``, each a gap between what the
program produced and what the plain reference computes from the same
inputs and weights (``PERF.md`` gives each limit and the readings it was
set from).

- ``loss_gap``: the largest relative gap of a train step's loss.
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it (AdamW's first moment after one step,
  over ``1 - beta1``), against the reference's norm of that leaf or of the
  median leaf, whichever is larger.
- ``first_change_gap``: the same gap, by the worst leaf, for the change
  that the first update made to the parameters.
- ``change_gap``: the same gap for the parameters' change over the
  chunk compared, taken by the median leaf (the worst leaf's swings with
  the noise of the later steps, ``PERF.md``), leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's
  (they move by round-off alone; ``first_change_gap`` leaves them out
  too).
- ``logit_gap``: the largest gap of a served logit, against the largest
  reference logit of its batch and tag.
"""

from __future__ import annotations

import numpy as np
import torch

ROUNDOFF_LEAF = 1e-3


def loss_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Each leaf's ``| |got| - |want| |`` over ``max(|want|, median
    |want|)``, over the leaves in ``keep`` (default all); ``[inf]`` where
    the leaves differ or a norm is not finite."""
    if set(got) != set(want):
        return [float("inf")]
    g, w = _norms(got), _norms(want)
    names = [k for k in w if keep is None or k in keep]
    median = float(np.median([w[k] for k in w]))
    gaps = [abs(g[k] - w[k]) / max(w[k], median) for k in names]
    return gaps if all(np.isfinite(gaps)) else [float("inf")]


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, keep))


def median_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The median leaf's gap (:func:`leaf_gaps`)."""
    return float(np.median(leaf_gaps(got, want, keep)))


def moving_leaves(first_grad: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(first_grad)
    median = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= ROUNDOFF_LEAF * median}


def logit_gap(got: dict, want: dict) -> float:
    """``got``/``want``: tag -> ``[B, C]`` logits of one batch."""
    if set(got) != set(want):
        return float("inf")
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        if g.shape != w.shape:
            return float("inf")
        worst = max(worst, float(np.max(np.abs(g - w))
                                 / max(np.max(np.abs(w)), 1e-30)))
    return worst

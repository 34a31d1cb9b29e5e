"""Reference-named aliases over the port's modules (counterpart of
``disentangled_multimodal_learning_tpu/compat.py``), so that code written
against the reference's API (``from ...compat import NLLSurvLoss,
define_optimizer``) runs on the port:

- ``TrilinearFusion_A`` / ``_B`` (reference ``models/fusion.py``);
- the survival losses ``nll_loss``, ``CoxLoss``, ``ce_surv`` and their
  callable classes, and ``define_loss`` (reference ``utils/utils.py``,
  ``models/cmta_utils.py``);
- ``define_optimizer`` and ``define_scheduler`` (reference
  ``models/model.py:107-168``): the port's optimizer over a module's
  parameters and its per-iteration ``LambdaLR``;
- the L1 regularizers ``regularize_*`` of a module (reference
  ``utils/utils.py:34-72``);
- ``shap_feature_importance``: expected-gradients SHAP
  (``utils/importance.py deep_shap_importance``) in place of the
  reference's ``shap.DeepExplainer``.
"""

from __future__ import annotations

import functools

from .models.fusion import TrilinearFusion
from .train import losses as _L
from .train.optim import make_optimizer, make_scheduler

TrilinearFusion_A = functools.partial(TrilinearFusion, variant="A")
TrilinearFusion_B = functools.partial(TrilinearFusion, variant="B")

nll_loss = _L.nll_surv_loss
CoxLoss = _L.cox_loss
ce_surv = _L.ce_surv_loss


class NLLSurvLoss:
    """The survival NLL as a callable, ``alpha`` 0.15 by default."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha

    def __call__(self, hazards, S, Y, c, alpha=None):
        a = self.alpha if alpha is None else alpha
        return _L.nll_surv_loss(hazards, S, Y, c, alpha=a)


class CrossEntropySurvLoss:
    """The cross-entropy survival loss as a callable, ``alpha`` 0.15."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha

    def __call__(self, hazards, S, Y, c, alpha=None):
        a = self.alpha if alpha is None else alpha
        return _L.ce_surv_loss(hazards, S, Y, c, alpha=a)


class CoxSurvLoss:
    """The Cox loss as a callable."""

    def __call__(self, survtime, censor, hazard_pred):
        return _L.cox_loss(survtime, censor, hazard_pred)


def define_loss(which: str):
    """A loss by the reference's name."""
    table = {"ce_surv": CrossEntropySurvLoss(), "nll_surv": NLLSurvLoss(),
             "cox_surv": CoxSurvLoss(), "kl": _L.kl_loss,
             "cosine": _L.cosine_loss, "orthogonal": _L.orthogonal_loss}
    if which not in table:
        raise NotImplementedError(f"unknown loss: {which}")
    return table[which]


def define_optimizer(args, model):
    """``args.optimizer`` (AdamW, Adam, SGD or the optax Adagrad) over
    ``model``'s parameters (a module or an iterable), at base lr 1:
    :func:`define_scheduler` sets each step's lr."""
    params = model.parameters() if hasattr(model, "parameters") else model
    return make_optimizer(args, params)


def define_scheduler(args, optimizer, steps_per_epoch: int = 1):
    """``args.lr_policy`` as a per-iteration ``LambdaLR`` of
    ``optimizer``."""
    return make_scheduler(args, optimizer, steps_per_epoch)


def regularize_weights(model):
    """L1 over every parameter of ``model``."""
    return _L.l1_regularizer(model)


def _subtree(model, key_fragment: str) -> dict:
    """The parameters (not the BatchNorm statistics, which are buffers)
    whose top-level name holds ``key_fragment``, JAX's ``_subtree`` of the
    same params; a dict of tensors is read as such a tree."""
    named = (model.named_parameters() if hasattr(model, "named_parameters")
             else model.items())
    return {k: v for k, v in named
            if key_fragment in k.split(".", 1)[0].lower()}


def regularize_path_weights(model):
    """L1 over the path branch (top-level names holding ``path``)."""
    return _L.l1_regularizer(_subtree(model, "path"))


def regularize_MM_weights(model):
    """L1 over the fusion (top-level names holding ``fusion``)."""
    return _L.l1_regularizer(_subtree(model, "fusion"))


def regularize_MM_omic(model):
    """L1 over the omic branch (top-level names holding ``omic``)."""
    return _L.l1_regularizer(_subtree(model, "omic"))


def shap_feature_importance(*args, **kwargs):
    """``utils/importance.py deep_shap_importance(model, cfg, batches,
    ...)``: expected-gradients SHAP with the evaluation set as the
    background, as the reference's DeepExplainer workflow uses it."""
    from .utils.importance import deep_shap_importance

    return deep_shap_importance(*args, **kwargs)

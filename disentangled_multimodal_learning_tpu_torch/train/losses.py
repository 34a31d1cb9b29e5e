"""Task losses, the attention consistency losses of the teacher and the
student, and the vgrid consistency loss of deformpathomic (counterpart of
``disentangled_multimodal_learning_tpu/train/losses.py``: weighted CE :30,
``nll_surv_loss`` :42, ``task_loss`` :89, ``path_batch_loss`` :131,
``distillation_loss`` :106, ``feature_distillation_loss`` :117,
``path_batch_loss_stacked`` :156 (its per-scale Gram, :func:`gram_mean`,
for the scale-branch layout), ``diag_variance_loss`` :176,
``omic_domain_scale_loss`` :183,
``batch_loss_vgrid`` :200), and the reference losses no step calls
(``compat.py`` and the tests do): ``cox_loss`` :65, ``ce_surv_loss`` :76,
``kl_loss`` :222, ``cosine_loss`` :235, ``orthogonal_loss`` :240,
``low_rank_loss`` :249, ``sigmoid_rampup`` :257, ``l1_regularizer`` :269,
``directional_consistency_loss`` :279.

Label tensors are integer ``[B, 12]`` in the column order of
``data/contract.py``.  The attention maps the consistency losses read may be
bf16 on the card (``attn_bf16_streams``): the Grams upcast them and
contract in f32, as the JAX einsums do with ``preferred_element_type``.
"""

from __future__ import annotations

import math

import torch

from ..data.contract import LabelCol

_CLASS_COL = {"diag2021": LabelCol.DIAG, "grade": LabelCol.GRADE,
              "subtype": LabelCol.SUBTYPE}


def weighted_cross_entropy(logits, labels, class_weights=None):
    """torch ``CrossEntropyLoss`` semantics: mean over samples, or the
    weighted mean (normalized by the summed sample weights) when per-class
    weights are given."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    if class_weights is None:
        return nll.mean()
    w = torch.as_tensor(class_weights, dtype=logits.dtype,
                        device=logits.device)[labels.long()]
    return (w * nll).sum() / w.sum()


def nll_surv_loss(hazards, S, Y, c, alpha: float = 0.4, eps: float = 1e-7):
    """Discrete-time survival NLL with censoring: ``hazards``/``S [B, K]``,
    ``Y [B]`` integer bin, ``c [B]`` censorship (1 = censored)."""
    Y = Y[:, None].long()
    c = c[:, None].to(hazards.dtype)
    if S is None:
        S = torch.cumprod(1.0 - hazards, dim=1)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    s_y = S_padded.gather(1, Y)
    h_y = hazards.gather(1, Y)
    s_y1 = S_padded.gather(1, Y + 1)
    uncensored = -(1.0 - c) * (torch.log(s_y.clamp_min(eps))
                               + torch.log(h_y.clamp_min(eps)))
    censored = -c * torch.log(s_y1.clamp_min(eps))
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return loss.mean()


def task_loss(task_type: str, logits=None, hazards=None, S=None, label=None,
              class_weights=None):
    """The trainer's per-task switch: weighted CE on the task's label column
    for diag2021/grade/subtype, the survival NLL with alpha = 0 for
    survival."""
    if task_type == "survival":
        return nll_surv_loss(hazards, S, label[:, LabelCol.SURVIVAL_BIN],
                             label[:, LabelCol.CENSOR], alpha=0.0)
    return weighted_cross_entropy(logits, label[:, _CLASS_COL[task_type]],
                                  class_weights)


def distillation_loss(student_logits, teacher_logits, temperature=2.0):
    """KL(teacher || student) of the softened distributions at
    ``temperature``, summed over classes, averaged over the batch
    (``batchmean``) and scaled by T^2; the teacher's probabilities are
    clipped at 1e-12 inside the log, as in JAX."""
    t = temperature
    soft_targets = torch.softmax(teacher_logits / t, dim=1)
    soft_prob = torch.log_softmax(student_logits / t, dim=1)
    kl = soft_targets * (torch.log(soft_targets.clamp_min(1e-12)) - soft_prob)
    return kl.sum() / student_logits.shape[0] * t ** 2


def feature_distillation_loss(student_feat, teacher_feat):
    """Mean squared error of the student's features to the teacher's."""
    return ((student_feat - teacher_feat) ** 2).mean()


def path_batch_loss(att10, att20):
    """Student cross-scale consistency: per head, the Gram of the batch's
    flattened maps (``[B, H, K, N]`` here, ``[B, H, N, K]`` in JAX: the
    contraction over both trailing axes does not see the layout),
    row-normalized, averaged over heads; the squared difference of the two
    scales' averages, summed, over B."""
    return gram_mean_loss(gram_mean(att10), gram_mean(att20))


def gram_mean(a):
    """One scale's share of :func:`path_batch_loss`: the per-head Grams of
    the batch's flattened maps ``a [B, H, K, N]``, row-normalized,
    averaged over heads -> ``[B, B]`` (the Gram JAX's
    ``path_batch_loss_stacked`` keeps per scale before the seam)."""
    a = a.float().flatten(2).transpose(0, 1)                     # [H, B, KN]
    s = a @ a.transpose(1, 2)                                    # [H, B, B]
    return (s / torch.linalg.vector_norm(s, dim=2, keepdim=True)).mean(0)


def gram_mean_loss(m10, m20):
    """:func:`path_batch_loss` from the two scales' :func:`gram_mean`."""
    return ((m10 - m20) ** 2 / m10.shape[0]).sum()


def diag_variance_loss(x, weight: float = 1.0):
    """Unbiased variance (n - 1) of the matrix diagonal, times ``weight``."""
    return weight * torch.diagonal(x).var(unbiased=True)


def omic_domain_scale_loss(att1_10, att1_20, att2_10, att2_20):
    """Teacher cross-scale attention consistency: per compartment, the
    cross-Gram of the flattened ``[B, H, K, N]`` maps of the two scales,
    row-normalized, with the variance of its diagonal times 1e4.  The inner
    product is independent of the layout of the trailing axes."""
    def sim_loss(a, b):
        s = a.float().flatten(1) @ b.float().flatten(1).t()
        s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True)
        return diag_variance_loss(s, weight=10000.0)

    return sim_loss(att1_10, att1_20) + sim_loss(att2_10, att2_20)


def _row_normalized_gram(a):
    """``a a^T`` over the last two axes, each row divided by its L2 norm."""
    s = a @ a.transpose(-1, -2)
    return s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)


def batch_loss_vgrid(omic, vgrid):
    """deformpathomic's omic-similarity vs vgrid-similarity consistency:
    ``omic [n, ...]`` (the broadcast omic features), ``vgrid [n*G, 2, gh,
    gw]`` with G = 8.  The vgrid is reshaped to ``(8, n, -1)`` in flat C
    order, verbatim from the reference: the leading axis is (batch,
    group)-major, so that interleaves batch and group (a documented
    reference quirk, kept)."""
    n = omic.shape[0]
    s = _row_normalized_gram(omic.reshape(n, -1))
    mean_vs = _row_normalized_gram(vgrid.reshape(8, n, -1)).mean(dim=0)
    return ((s - mean_vs) ** 2 / n).sum()


def cox_loss(survtime, censor, hazard_pred):
    """Cox partial likelihood over the batch's ``[B, B]`` risk sets
    (``survtime_j >= survtime_i``), times ``censor``, as the reference
    writes it."""
    theta = hazard_pred.reshape(-1)
    risk = (survtime[None, :] >= survtime[:, None]).to(theta.dtype)
    log_risk = torch.log((torch.exp(theta)[None, :] * risk).sum(dim=1))
    return -((theta - log_risk) * censor).mean()


def ce_surv_loss(hazards, S, Y, c, alpha: float = 0.4, eps: float = 1e-7):
    """The cross-entropy survival loss (CMTA's ``CrossEntropySurvLoss``):
    ``hazards``/``S [B, K]``, ``Y [B]`` bin, ``c [B]`` censorship."""
    Y = Y[:, None].long()
    c = c[:, None].to(hazards.dtype)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    s_y = S.gather(1, Y)
    reg = -(1.0 - c) * (torch.log(S_padded.gather(1, Y) + eps)
                        + torch.log(hazards.gather(1, Y).clamp_min(eps)))
    ce_l = (-c * torch.log(s_y.clamp_min(eps))
            - (1.0 - c) * torch.log((1.0 - s_y).clamp_min(eps)))
    return ((1.0 - alpha) * ce_l + alpha * reg).mean()


def kl_loss(y, y_hat):
    """Sum-reduced KL(softmax(y) || softmax(y_hat)), ``softmax(y)`` clipped
    at 1e-12 inside its log."""
    p = torch.softmax(y, dim=-1)
    return (p * (torch.log(p.clamp_min(1e-12))
                 - torch.log_softmax(y_hat, dim=-1))).sum()


def _cossim(a, b, dim: int = 1, eps: float = 1e-8):
    """Cosine similarity with the PRODUCT of the norms clamped at ``eps``
    (JAX ``losses.py:229-232``; ``F.cosine_similarity`` clamps each
    norm)."""
    num = (a * b).sum(dim=dim)
    den = (torch.linalg.vector_norm(a, dim=dim)
           * torch.linalg.vector_norm(b, dim=dim))
    return num / den.clamp_min(eps)


def cosine_loss(y, y_hat):
    """``1 - cos(y, y_hat)`` per row."""
    return 1.0 - _cossim(y, y_hat)


def orthogonal_loss(P, P_hat, G, G_hat, gamma: float = 0.5):
    """CMTA's orthogonal loss: the reconstructions ``P_hat``, ``G_hat``
    pulled to the detached originals, and the pairs pushed apart, per
    row."""
    pd, gd = P.detach(), G.detach()
    pos = ((1.0 - _cossim(pd, P_hat).abs())
           + (1.0 - _cossim(gd, G_hat).abs()))
    neg = (_cossim(P, G).abs() + _cossim(pd, G_hat).abs()
           + _cossim(gd, P_hat).abs())
    return pos + gamma * neg


def low_rank_loss(x):
    """The sum of every singular value but the largest."""
    return torch.linalg.svdvals(x)[1:].sum()


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """``exp(-5 (1 - t)^2)`` of ``t = clip(current, 0, length) / length``
    (1 at length 0)."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-5.0 * phase * phase)


def _leaves(params):
    if isinstance(params, torch.nn.Module):
        yield from params.parameters()
    elif isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, (list, tuple)) or hasattr(params, "__next__"):
        for v in params:
            yield from _leaves(v)
    else:
        yield torch.as_tensor(params)


def l1_regularizer(params):
    """The sum of ``|w|`` over ``params``: a module's parameters, or the
    tensors of a (nested) dict, list or iterator."""
    return sum(w.abs().sum() for w in _leaves(params))


def directional_consistency_loss(m, eps: float = 1e-6):
    """``(|mean sign of m[0] - m[1]| - 1)^2`` over the entries whose
    difference is above ``eps`` (0 when there are none)."""
    diff = m[0] - m[1]
    nz = (diff.abs() > eps).to(diff.dtype)
    n_nz = nz.sum()
    x = torch.where(n_nz > 0, (torch.sign(diff) * nz).sum()
                    / n_nz.clamp_min(1.0), torch.zeros_like(n_nz))
    return (x.abs() - 1.0) ** 2

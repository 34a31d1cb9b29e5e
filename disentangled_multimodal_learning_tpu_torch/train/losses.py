"""Task losses, the attention consistency losses of the teacher and the
student, and the vgrid consistency loss of deformpathomic (counterpart of
``disentangled_multimodal_learning_tpu/train/losses.py``: weighted CE :30,
``nll_surv_loss`` :42, ``task_loss`` :89, ``path_batch_loss`` :131,
``distillation_loss`` :106, ``feature_distillation_loss`` :117,
``diag_variance_loss`` :176, ``omic_domain_scale_loss`` :183,
``batch_loss_vgrid`` :200).

Label tensors are integer ``[B, 12]`` in the column order of
``data/contract.py``.  The attention maps the consistency losses read may be
bf16 on the card (``attn_bf16_streams``): the Grams upcast them and
contract in f32, as the JAX einsums do with ``preferred_element_type``.
"""

from __future__ import annotations

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
    n = att10.shape[0]

    def gram_mean(a):
        a = a.float().flatten(2).transpose(0, 1)                 # [H, B, KN]
        s = a @ a.transpose(1, 2)                                # [H, B, B]
        return (s / torch.linalg.vector_norm(s, dim=2, keepdim=True)).mean(0)

    return ((gram_mean(att10) - gram_mean(att20)) ** 2 / n).sum()


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

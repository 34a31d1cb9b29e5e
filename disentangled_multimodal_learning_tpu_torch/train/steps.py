"""The teacher, student, multiscale, deformpathomic, distillation and
baseline train steps (counterpart of
``disentangled_multimodal_learning_tpu/train/steps.py``:
``TASK_LABEL_COL`` :30, ``batch_to_arrays`` :38, ``_model_kwargs`` :48,
``task_class_weights`` :100, ``make_train_step`` :109-322 (the baselines'
branch :257-273), ``make_teacher_boundary_fn`` :325 and
``make_distill_cached_step`` :349).

One step, in order: the train-mode forward (``TeachersNet``,
``StudentsNet``, ``MultiScaleNet`` or ``DeformPathomicNet``); the loss of
the mode (below); ``loss.backward()``; with ``gradient_modulate``, the
modulation of the classifier weight gradients (the teachers' two
classifiers from their two feature halves, the deformpathomic top-level
``classifier`` from the detached tumor and immune vectors; JAX modulates
no student gradient); the optimizer step; the per-iteration scheduler
step.  ``deterministic_training`` runs the forward in eval mode (dropout
off, the DPC noise pinned), the JAX trajectory-parity setting.

Losses: teacher and student, the two-scale task loss (weighted CE, or the
survival NLL) plus, with ``multiscale_attention``, the attention
consistency loss (the teacher's ``omic_domain_scale_loss`` on its four
maps, the student's ``1000 * path_batch_loss`` on its two), both on the
pre-dropout maps; multiscale, the task loss of the teacher pair plus that
of the student pair and, with ``multiscale_attention``, both consistency
losses (JAX modulates no multiscale gradient); deformpathomic, ``loss3``
(the task loss on the fused logits) plus, with ``return_vgrid``,
``0.5 * bs_t + 0.5 * bs_i`` of ``batch_loss_vgrid``; the baselines,
``taskloss`` alone: for ``mcat`` and ``cmta`` the survival NLL (alpha 0)
of their hazards and S on survival, else weighted CE of their logits
``out[0]``; for ``path``, ``transmil`` and ``omic`` weighted CE of
``out[1]``; for the pathomic family weighted CE of the final logits
``out[3][2]`` (on the survival task too, against the survival bin, as
in JAX).  No baseline gradient is modulated (JAX modulates none), and
their BatchNorm (BilinearFusion) updates its running statistics in train
mode only, so under ``deterministic_training`` it is frozen, as in JAX.

Distillation trains the student against a frozen teacher's boundary
tensors (:func:`make_teacher_boundary_fn`: its two scales' logits and
256-wide features, from an eval-mode forward without gradients): the
student's two-scale task loss plus ``distillation_loss`` at ``temperature``
on the logits and ``feature_distillation_loss`` on the features, weighted
as JAX weighs them (both on: ``taskloss + 0.01 dl + 0.01 df``; one alone:
``taskloss`` plus it); ``path_batch_loss`` is logged under
``multiscale_attention``, not added, and no gradient is modulated.  The
uncached step runs the teacher each step; :func:`make_distill_cached_step`
reads the tensors from the batch (``tea_lt10`` ...), filled by
``train/distill_cache.py``.  Deviation from JAX: its cached step runs the
student with ``train=True`` whatever ``deterministic_training`` says
(``steps.py:371``), while its uncached step honours it; here both honour
it, so that the two steps compute the same loss, as JAX's docstring says
they do.

In a parallel layout (``parallel/mesh.py``) the step takes the global
batch on every rank and runs the rank's share of it: its rows' forward in
the layout's context (BatchNorm, the Nystrom core and the 2-D attention
run their sharded forms), the loss above on the outputs gathered over the
data axis, the rank's share of the backward, one all-reduce of the
gradient (JAX's ``psum``), then the modulation and the optimizer on the
global gradient; the scale layout runs ``parallel/branch_shard.py``'s
forward and backward, the pipeline ``parallel/pipe_shard.py``'s step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.contract import LabelCol
from ..models.factory import BASELINES
from ..parallel import branch_shard, mesh
from . import losses as L
from .grad_modulate import modulate_kernel_grad

TASK_LABEL_COL = {
    "diag2021": LabelCol.DIAG,
    "grade": LabelCol.GRADE,
    "subtype": LabelCol.SUBTYPE,
    "survival": LabelCol.SURVIVAL_BIN,
}
_TEACHER_INPUTS = {k: k for k in ("x_path10", "x_path20", "x_omic_tumor",
                                  "x_omic_immune")}
_STUDENT_INPUTS = {"x_path10": "x_path10", "x_path20": "x_path20"}
# the forward's inputs per mode (distillation: the student's): model
# argument -> batch field
MODEL_INPUTS = {"teacher": _TEACHER_INPUTS, "uniteacher": _TEACHER_INPUTS,
                "multiscale": _TEACHER_INPUTS,
                "student": _STUDENT_INPUTS, "distillation": _STUDENT_INPUTS,
                "deformpathomic": {"x_path": "x_path10", "x_omic": "x_omic",
                                   "x_omic_tumor": "x_omic_tumor",
                                   "x_omic_immune": "x_omic_immune"},
                "path": {"x": "x_path10"}, "transmil": {"x": "x_path10"},
                "omic": {"x_omic": "x_omic"}}
MODEL_INPUTS.update(dict.fromkeys(
    ("pathomic", "pathomic_original", "pathomic_fg", "pathomic_ensemble",
     "mcat", "cmta"), {"x_path": "x_path10", "x_omic": "x_omic"}))
# the teacher boundary tensors of one batch, in make_teacher_boundary_fn's
# order: the logits of both scales, then the features of both
BOUNDARY_KEYS = ("tea_lt10", "tea_lt20", "tea_ft10", "tea_ft20")


def batch_to_tensors(batch, device) -> dict:
    """Host batch -> the step's tensors on ``device`` (labels as int64)."""
    def to(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, dtype=dtype, non_blocking=True)

    out = {k: to(getattr(batch, k)) for k in tuple(_TEACHER_INPUTS)
           + ("x_omic",)}
    out["label"] = to(batch.label, torch.int64)
    return out


def task_class_weights(cfg, task: str):
    """CE class weights for ``task``: none for survival, and none for
    diag2021 under ``external_eval``; grade/subtype stay weighted."""
    if task == "survival" or (task == "diag2021" and cfg.external_eval):
        return None
    return cfg.class_weights


def _task_loss(cfg, out, label, cw, tags):
    """The task loss summed over the two scales' ``tags``."""
    _, _, logits, hazards, S, _ = out
    return sum(L.task_loss(cfg.task_type, logits=logits[f"logits_{t}"],
                           hazards=hazards[f"hazards_{t}"], S=S[f"S_{t}"],
                           label=label, class_weights=cw)
               for t in tags)


def _two_scale_loss(model, cfg, out, label, cw):
    """Teacher / student: -> (loss, metrics, modulated classifiers)."""
    student = cfg.mode == "student"
    features, atts, *_ = out
    taskloss = _task_loss(cfg, out, label, cw, ("stu10", "stu20") if student
                          else ("tea10", "tea20"))
    loss = taskloss
    metrics = {"taskloss": taskloss}
    if cfg.multiscale_attention:
        if student:
            batchloss = 1000.0 * L.path_batch_loss(atts["att_stu10"],
                                                   atts["att_stu20"])
        else:
            batchloss = L.omic_domain_scale_loss(
                atts["att1_tea10"], atts["att1_tea20"],
                atts["att2_tea10"], atts["att2_tea20"])
        loss = loss + batchloss
        metrics["batchloss"] = batchloss
    modulated = [] if student else [
        (getattr(model, net).classifier, features[f"feature1_{tag}"],
         features[f"feature2_{tag}"])
        for net, tag in (("teacher10_net", "tea10"), ("teacher20_net", "tea20"))]
    return loss, metrics, modulated


def _multiscale_loss(model, cfg, out, label, cw):
    """MultiScaleNet: -> (loss, metrics, no modulated classifiers)."""
    atts = out[1]
    taskloss = (_task_loss(cfg, out, label, cw, ("tea10", "tea20"))
                + _task_loss(cfg, out, label, cw, ("stu10", "stu20")))
    loss = taskloss
    metrics = {"taskloss": taskloss}
    if cfg.multiscale_attention:
        batchloss = (L.omic_domain_scale_loss(
            atts["att1_tea10"], atts["att1_tea20"],
            atts["att2_tea10"], atts["att2_tea20"])
            + 1000.0 * L.path_batch_loss(atts["att_stu10"],
                                         atts["att_stu20"]))
        loss = loss + batchloss
        metrics["batchloss"] = batchloss
    return loss, metrics, []


def _deformpathomic_loss(model, cfg, out, label, cw):
    """DeformPathomicNet: -> (loss, metrics, modulated classifiers).  On
    the survival task the fused output is already a sigmoid, the hazards
    of ``nll_surv_loss``."""
    _, vec_t, vec_i, logits, *_ = out
    fused = logits[2]
    loss3 = L.task_loss(cfg.task_type, logits=fused, hazards=fused,
                        label=label, class_weights=cw)
    loss = loss3
    metrics = {"loss3": loss3}
    if cfg.return_vgrid:
        batch_sim = (0.5 * L.batch_loss_vgrid(logits[3], logits[4])
                     + 0.5 * L.batch_loss_vgrid(logits[5], logits[6]))
        loss = loss + batch_sim
        metrics["batch_sim_loss"] = batch_sim
    return loss, metrics, [(model.classifier, vec_t, vec_i)]


def _baseline_loss(model, cfg, out, label, cw):
    """A baseline: -> (loss, metrics, no modulated classifiers)."""
    y = label[:, int(TASK_LABEL_COL[cfg.task_type])]
    if cfg.mode in ("mcat", "cmta"):
        logits, hazards, S = out[:3]
        loss = L.task_loss(cfg.task_type, logits=logits, hazards=hazards,
                           S=S, label=label, class_weights=cw)
    elif cfg.mode in ("path", "transmil", "omic"):
        loss = L.weighted_cross_entropy(out[1], y, cw)
    else:
        loss = L.weighted_cross_entropy(out[3][2], y, cw)
    return loss, {"taskloss": loss}, []


def _distillation_loss(cfg, out, label, cw, boundary):
    """The distilled student's loss against the teacher's ``boundary``
    tensors: -> (loss, metrics)."""
    features, atts, logits, *_ = out
    lt10, lt20, ft10, ft20 = boundary
    t = float(cfg.temperature)
    taskloss = _task_loss(cfg, out, label, cw, ("stu10", "stu20"))
    metrics = {"taskloss": taskloss}
    loss = taskloss
    if cfg.distill_logits:
        dl = (L.distillation_loss(logits["logits_stu10"], lt10, t)
              + L.distillation_loss(logits["logits_stu20"], lt20, t))
        metrics["distillloss_logits"] = dl
    if cfg.distill_feature:
        df = (L.feature_distillation_loss(features["feature_stu10"], ft10)
              + L.feature_distillation_loss(features["feature_stu20"], ft20))
        metrics["distillloss_feature"] = df
    if cfg.distill_logits and cfg.distill_feature:
        loss = taskloss + 0.01 * dl + 0.01 * df
    elif cfg.distill_logits:
        loss = taskloss + dl
    elif cfg.distill_feature:
        loss = taskloss + df
    if cfg.multiscale_attention:  # logged, not trained on
        with torch.no_grad():
            metrics["batchloss"] = L.path_batch_loss(atts["att_stu10"],
                                                     atts["att_stu20"])
    return loss, metrics


def make_teacher_boundary_fn(teacher):
    """``boundary(tensors) -> (lt10, lt20, ft10, ft20)``: the frozen
    ``teacher``'s eval-mode forward without gradients, its two scales'
    logits ``[B, C]`` and concatenated feature halves ``[B, 256]``."""
    inputs = MODEL_INPUTS["teacher"]

    @torch.no_grad()
    def teacher_boundary(tensors: dict) -> tuple:
        teacher.eval()
        features, _, logits, *_ = teacher(
            **{arg: tensors[key] for arg, key in inputs.items()})
        return (logits["logits_tea10"], logits["logits_tea20"],
                torch.cat([features["feature1_tea10"],
                           features["feature2_tea10"]], dim=-1),
                torch.cat([features["feature1_tea20"],
                           features["feature2_tea20"]], dim=-1))

    return teacher_boundary


def sharded_boundary(boundary_fn, layout):
    """``boundary_fn`` over a global batch with each rank of ``layout``'s
    data axis running it on its own rows (in the layout's step context),
    the results gathered: the teacher's share of a sharded distillation
    step, and what the teacher-output cache fills with."""
    if layout is None or layout.size == 1:
        return boundary_fn

    def boundary(tensors: dict) -> tuple:
        total = tensors["label"].shape[0]
        off, b = layout.rows(total)
        with mesh.active(layout, off, total):
            out = boundary_fn(mesh.slice_rows(tensors, off, b))
        return tuple(mesh.gather_rows(t, layout.data_group) for t in out)

    return boundary


def make_distill_cached_step(model, cfg, optimizer, scheduler=None,
                             layout=None):
    """The distillation step on precomputed teacher boundary tensors,
    ``tensors[k]`` for ``k`` in :data:`BOUNDARY_KEYS`; otherwise the
    uncached step (see the module docstring)."""
    return _make_step(model, cfg, optimizer, scheduler,
                      lambda tensors: tuple(tensors[k] for k in BOUNDARY_KEYS),
                      layout)


def make_train_step(model, cfg, optimizer, scheduler=None, teacher=None,
                    layout=None):
    """The train step of ``cfg.mode`` (teacher, uniteacher, student,
    multiscale, deformpathomic, a baseline, or distillation with the frozen
    ``teacher``):
    ``step(tensors) -> metrics``, a dict of detached 0-d tensors (``loss``,
    ``taskloss`` and, with ``multiscale_attention``, ``batchloss``;
    distillation adds ``distillloss_logits`` and ``distillloss_feature``
    as they are on; deformpathomic: ``loss``, ``loss3`` and, with
    ``return_vgrid``, ``batch_sim_loss``; a baseline: ``loss`` and
    ``taskloss``); read them with ``float()`` only where the host needs
    the value.  With a ``layout`` (``parallel/mesh.py``) of more than one
    rank, ``tensors`` is the global batch and the step is this rank's
    share of it (:func:`_sharded_backward`); every rank returns the same
    metrics and holds the same parameters after it."""
    if cfg.mode not in MODEL_INPUTS:
        raise NotImplementedError(f"mode {cfg.mode!r} is not a mode of the "
                                  "port")
    if (cfg.mode == "deformpathomic" and cfg.gradient_modulate
            and cfg.fusion_type != "concat"):
        raise ValueError(
            "gradient_modulate splits the deformpathomic classifier's weight "
            "into a tumor and an immune half, which only fusion_type "
            "'concat' gives it; with BilinearFusion the classifier reads "
            "the fused vector (JAX fails there on a shape mismatch in "
            "modulate_kernel_grad): turn gradient_modulate off")
    if cfg.mode == "distillation":
        if teacher is None:
            raise ValueError("mode 'distillation' needs the frozen teacher "
                             "(teacher=...)")
        return _make_step(model, cfg, optimizer, scheduler, sharded_boundary(
            make_teacher_boundary_fn(teacher), layout), layout)
    return _make_step(model, cfg, optimizer, scheduler, layout=layout)


def _make_step(model, cfg, optimizer, scheduler, boundary_fn=None,
               layout=None):
    """The step of :func:`make_train_step`; with ``boundary_fn``
    (``tensors -> teacher boundary`` of the global batch) the distillation
    step; with ``layout``, a rank's share of a sharded step."""
    mode = cfg.mode
    inputs = MODEL_INPUTS[mode]
    loss_fn = {"deformpathomic": _deformpathomic_loss,
               "multiscale": _multiscale_loss}.get(mode, _two_scale_loss)
    if mode in BASELINES:
        loss_fn = _baseline_loss
    params = list(model.parameters())
    cw = task_class_weights(cfg, cfg.task_type)
    if cw is not None:  # on the card once: a CUDA graph copies no host list
        cw = torch.tensor(cw, dtype=torch.float32, device=params[0].device)
    label_col = int(TASK_LABEL_COL[cfg.task_type])
    train_mode = not cfg.deterministic_training

    def losses_of(out, label, boundary):
        if boundary is not None:
            return (*_distillation_loss(cfg, out, label, cw, boundary), [])
        return loss_fn(model, cfg, out, label, cw)

    def train_step(tensors: dict) -> dict:
        boundary = boundary_fn(tensors) if boundary_fn is not None else None
        model.train(train_mode)
        optimizer.zero_grad(set_to_none=True)
        label = tensors["label"]
        if layout is not None and layout.size > 1:
            loss, metrics, modulated = _sharded_backward(
                model, cfg, tensors, inputs, layout, cw,
                lambda out: losses_of(out, label, boundary))
        else:
            out = model(**{arg: tensors[key] for arg, key in inputs.items()})
            loss, metrics, modulated = losses_of(out, label, boundary)
            loss.backward()
        # a parameter the loss does not reach (the MaxNets' classifiers)
        # gets a zero gradient, so the optimizer still decays it, as optax
        # does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if layout is not None:
            mesh.sum_grads(params, layout)
        if cfg.gradient_modulate:
            y = label[:, label_col]
            for cls, f1, f2 in modulated:
                cls.weight.grad = modulate_kernel_grad(
                    cls.weight.grad, f1.detach(), f2.detach(),
                    cls.weight.detach(), cls.bias.detach(), y)
            if layout is not None and layout.kind == "scale":
                branch_shard.share_classifier_grads(model, cfg.mode, layout)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def _sharded_backward(model, cfg, tensors, inputs, layout, cw, losses_of):
    """This rank's forward and backward of a sharded step over the global
    batch ``tensors``: the forward of its rows (in the layout's step
    context, so that BatchNorm, the Nystrom core and the 2-D attention run
    their sharded forms), then the loss of the whole batch on the outputs
    gathered over the data axis and this rank's share of its backward
    (``parallel/mesh.py backward_from_rows``); the scale layout runs its
    own branch (``parallel/branch_shard.py``).  Returns ``(loss, metrics,
    modulated classifiers)``."""
    total = tensors["label"].shape[0]
    off, b = layout.rows(total)
    own = mesh.slice_rows(tensors, off, b)
    with mesh.active(layout, off, total):
        if layout.kind == "scale":
            return branch_shard.forward_backward(model, cfg, own, tensors,
                                                 layout, cw)
        out = model(**{arg: own[key] for arg, key in inputs.items()})
    return mesh.backward_from_rows(out, losses_of, layout)

"""The training driver of the teacher, the student and deformpathomic
(counterpart of ``disentangled_multimodal_learning_tpu/train/trainers.py``:
``run_training`` :60-315, ``trainTeachersModel`` :364,
``trainStudentsModel`` :370, ``trainDeformPathomicModel`` :384,
``testStudentsModel`` :415, ``testDeformPathomicModel`` :423) on one
device.

Per epoch: ``set_epoch`` on the train loader, one train step per batch with
the scheduler stepped per iteration, the ``eval_every_iters`` cadence
(evaluation whenever the iteration count crosses a multiple of it, with
``eval_during_training`` and a test loader), and at the epoch's end the
plateau watcher on the mean train loss.  After the last epoch, the final
evaluation through :class:`~.evaluation.Evaluator`.

What the JAX driver does besides, and the port does not yet: meshes and
sharded steps, ``scan_steps``, and checkpoints and resume (they come with
the checkpoints and survival evaluation).  A ``checkpoints`` directory other than ``"#"`` raises instead of
training without saving.
"""

from __future__ import annotations

import time

import torch

from .evaluation import METRIC_NAMES, Evaluator
from .optim import (ReduceLROnPlateau, make_optimizer, make_scheduler,
                    set_learning_rate)
from .steps import batch_to_tensors, make_train_step


def run_training(cfg, model, loaders, logger=None, model_type="teacher"):
    """Train ``model`` (on its own device) over ``loaders = (train, test)``;
    returns ``(model, final_metrics, None)``: the trained model, the
    metrics of the final evaluation on the combined tag of ``model_type``
    (``teas``, ``stus`` or ``fused``: ``acc``, ``auc``, ...) with every
    tag's under ``detail``, the last step's ``train_loss`` and every step's under
    ``train_losses``, and no checkpoint path."""
    if cfg.checkpoints not in ("#", ""):
        raise NotImplementedError(
            f"checkpoints={cfg.checkpoints!r}: the port does not save "
            "checkpoints yet (they come with the checkpoints, resume and "
            "survival evaluation); pass --checkpoints '#'")
    train_loader, test_loader = loaders
    device = next(model.parameters()).device
    steps_per_epoch = max(1, len(train_loader))
    plateau = (ReduceLROnPlateau(cfg.plateau_factor, cfg.plateau_patience,
                                 cfg.plateau_threshold)
               if cfg.lr_policy == "plateau" else None)
    optimizer = make_optimizer(cfg, model.parameters())
    scheduler = make_scheduler(cfg, optimizer, steps_per_epoch, plateau)
    train_step = make_train_step(model, cfg, optimizer, scheduler)
    evaluator = Evaluator(model, cfg, device, model_type)
    headline = evaluator.tags[-1]  # teas / stus / fused
    torch.manual_seed(cfg.seed + 1234)  # the dropout draws
    start = time.time()
    cur_iters = 0
    losses = []  # device scalars, read once at the end

    for epoch in range(cfg.epochs):
        train_loader.set_epoch(epoch)
        epoch_losses = []
        for i, batch in enumerate(train_loader):
            metrics = train_step(batch_to_tensors(batch, device))
            losses.append(metrics["loss"])
            prev_iters, cur_iters = cur_iters, cur_iters + 1
            if plateau is not None:
                epoch_losses.append(metrics["loss"])
            crossed = (cur_iters // cfg.eval_every_iters
                       > prev_iters // cfg.eval_every_iters)
            if cfg.eval_during_training and test_loader is not None and crossed:
                result = evaluate(evaluator, test_loader)
                if logger is not None:
                    logger.log({"training": {k: float(v)
                                             for k, v in metrics.items()},
                                "test": result})
                print("\rFold: [%2d/%2d] Epoch: [%2d/%2d] Iter [%4d/%4d] || "
                      "Time: %4.4f sec || Loss: %.4f || auc_%s %.4f"
                      % (cfg.cur_fold, cfg.kfold, epoch, cfg.epochs, i + 1,
                         len(train_loader), time.time() - start,
                         float(metrics["loss"]), headline,
                         result[f"auc_{headline}"]),
                      end="", flush=True)
        if plateau is not None and epoch_losses:
            mean_loss = float(torch.stack(epoch_losses).mean())
            set_learning_rate(optimizer, cfg.lr * plateau.step(mean_loss))

    final = {}
    if test_loader is not None:
        detail = evaluate(evaluator, test_loader)
        final = {n: detail[f"{n}_{headline}"] for n in METRIC_NAMES}
        final["detail"] = detail
    if losses:
        final["train_losses"] = torch.stack(losses).tolist()
        final["train_loss"] = final["train_losses"][-1]
    return model, final, None


def evaluate(evaluator, loader) -> dict:
    """The evaluator's metrics over ``loader`` in eval mode (the next train
    step puts the model back in its train mode)."""
    evaluator.model.eval()
    return evaluator.metrics(*evaluator.logits(loader))


def trainTeachersModel(model, dataloader, optimizer, scheduler, logger, args):
    """Reference-named entry (``optimizer`` and ``scheduler`` are built from
    ``args``, as in JAX)."""
    return run_training(args, model, dataloader, logger, model_type="teacher")


def trainStudentsModel(model, dataloader, optimizer, scheduler, logger, args):
    """Reference-named entry of the student, as :func:`trainTeachersModel`."""
    return run_training(args, model, dataloader, logger, model_type="student")


def trainDeformPathomicModel(model, dataloader, optimizer, scheduler, logger,
                             args):
    """Reference-named entry of deformpathomic, as
    :func:`trainTeachersModel`; the metrics are those of the fused
    logits."""
    return run_training(args, model, dataloader, logger, model_type="fused")


def _run_test(model, loader, args, model_type):
    """The evaluator over ``loader`` in eval mode -> ``(metrics, logits)``:
    ``{f"{metric}_{tag}": value}`` and ``{f"logits_{tag}": [M, C]}``; for
    the one ``fused`` tag the metrics are flat (``{"acc": ...}``), as JAX
    ``_metricdicts_to_flat`` gives them."""
    evaluator = Evaluator(model, args, next(model.parameters()).device,
                          model_type)
    model.eval()
    logits, labels = evaluator.logits(loader)
    metrics = evaluator.metrics(logits, labels)
    if model_type == "fused":
        metrics = {n: metrics[f"{n}_fused"] for n in METRIC_NAMES}
    return metrics, logits


def testTeachersModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "teacher")


def testStudentsModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "student")


def testDeformPathomicModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "fused")

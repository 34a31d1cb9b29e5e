"""The training driver of the teacher, the student, multiscale,
deformpathomic, distillation and the baselines (counterpart of
``disentangled_multimodal_learning_tpu/train/trainers.py``:
``run_training`` :60-315, ``trainTeachersModel`` :364,
``trainStudentsModel`` :370, ``trainDistillation`` :376,
``trainDeformPathomicModel`` :384, ``testStudentsModel`` :415,
``testDistillation`` :419, ``testDeformPathomicModel`` :423,
``testBaselineModel`` :427, ``testMultiScaleModel`` :434) on one device.
Multiscale evaluates five tags (``tea10``, ``tea20``, ``stu10``,
``stu20``, ``stus``) and stamps its checkpoint with the combined student's
metrics, as JAX does; a baseline trains through ``run_training`` itself
(JAX's generic trainer) on the one tag of its evaluation (``fused`` or
``simple``, ``evaluation.model_type_of``).

Per epoch: ``set_epoch`` on the train loader, one train step per batch with
the scheduler stepped per iteration, the ``eval_every_iters`` cadence
(evaluation whenever the iteration count crosses a multiple of it, with
``eval_during_training`` and a test loader), at the epoch's end the
plateau watcher on the mean train loss and, every ``save_every_epochs``
epochs, the fold's rolling checkpoint ``{mode}_fold_{k}_latest``.  After
the last epoch, the final evaluation through :class:`~.evaluation.Evaluator`
and, unless ``checkpoints`` is ``"#"``, a metric-stamped checkpoint
(``utils/checkpoint.py``).

``resume`` restores the rolling checkpoint (model, optimizer, scheduler
and step), the port's ``{mode}_fold_{k}_latest.pt`` or else the one the
JAX package wrote, ``{mode}_fold_{k}_latest.ckpt`` (``utils/checkpoint.py``
reads it), and starts at epoch ``step // steps_per_epoch``; the dropout
generator restarts from the run's seed, as JAX restarts its dropout key, so
with dropout on a resumed fold matches an uninterrupted one only under
``deterministic_training``.

Distillation trains the student against the frozen ``teacher``: with
``distill_teacher_cache`` and a loader of known size, through the cached
step and a :class:`~.distill_cache.TeacherBoundaryCache` on the student's
device; otherwise through the uncached step.

In a process group (``parallel/mesh.py``) every rank runs this driver on
the same loaders: the layout comes from :func:`~..parallel.mesh.choose_layout`
(JAX's precedence: the pipeline, tensor parallelism, the scale branches,
TransMIL's token axis, data parallelism), the parameters start as rank
0's, each step is the rank's share of the global batch, and rank 0 alone
evaluates, logs and saves (its checkpoint is the single-process one).  The
dropout stream of a rank is seeded with its data index added, so the data
shards draw other masks and the ranks of one inner group the same ones
(the replicated parts stay equal).  A pipeline (``pipe_devices``) trains
distillation without the teacher-output cache, as JAX does.

``scan_steps`` K > 1 takes JAX's order (``trainers.py:234-285``): each
batch (with its teacher boundary tensors, in distillation with the cache)
joins a buffer keyed by the shape of ``x_path10``, buffers kept in
first-seen order, since bucketed loaders interleave bag lengths; a full
buffer is a chunk of K updates (on the card in one process, a shape's
first chunk K single steps, which warm up, and every later one a replay of
the shape's CUDA graph of K steps, ``train/graph_chunk.py``; on the CPU and
in a process group, K single steps), after which the last step's metrics are logged, the
plateau watcher gets all K losses and the eval cadence is checked once,
against the iteration count before the chunk; at each epoch's end the
buffers that did not fill run one batch at a time through the single step,
in first-seen order, each checked against the cadence at the epoch's last
index, before plateau and the rolling checkpoint.

What the JAX driver does besides, and the port does not: the orbax
checkpoint backend (the port writes ``.pt``, reads JAX's pickle ``.ckpt``
and refuses ``.orbax``).
"""

from __future__ import annotations

import os
import time

import torch

from ..parallel import mesh
from ..parallel.pipe_shard import make_pipe_distill_step
from ..utils.checkpoint import (JAX_SUFFIX, SUFFIX, metric_stamped_name,
                                restore_state, save_checkpoint)
from .distill_cache import TeacherBoundaryCache, loader_dataset_size
from .evaluation import (METRIC_NAMES, Evaluator, headline_metrics,
                         model_type_of)
from .graph_chunk import ChunkRunner
from .optim import (ReduceLROnPlateau, make_optimizer, make_scheduler,
                    set_learning_rate)
from .steps import (batch_to_tensors, make_distill_cached_step,
                    make_teacher_boundary_fn, make_train_step,
                    sharded_boundary)


def run_training(cfg, model, loaders, logger=None, model_type="teacher",
                 teacher=None, state=None):
    """Train ``model`` (on its own device) over ``loaders = (train, test)``,
    from the checkpoint payload ``state`` where given (``reload``);
    returns ``(model, final_metrics, checkpoint_path)``: the trained model;
    the metrics of the final evaluation on the combined tag of
    ``model_type`` (``teas``, ``stus`` (students and ``scales``),
    ``fused`` or ``simple``: ``acc``, ``auc``, ...,
    or ``cindex`` on survival) with every tag's under ``detail`` and the
    evaluated outputs under ``logits``, the last step's ``train_loss`` and
    every step's under ``train_losses``; and the checkpoint's path (None
    where ``checkpoints`` is ``"#"``).  In distillation mode ``teacher`` is
    the frozen teacher.  In a process group, ranks other than 0 return no
    evaluation and no checkpoint (see the module docstring)."""
    train_loader, test_loader = loaders
    device = next(model.parameters()).device
    mode = cfg.mode
    layout = None
    if mesh.in_group():
        layout = mesh.choose_layout(cfg, has_teacher=teacher is not None)
        print(f"[parallel] rank {mesh.world_rank()[1]}: " + (
            "the whole batch on every rank" if layout is None else
            f"{layout.kind} layout, data {layout.dp} x {layout.kind} "
            f"{layout.inner}" + (", idle" if layout.idle else "")))
        if layout is not None and layout.idle:
            return model, {}, None
    lead = mesh.world_rank()[1] == 0
    steps_per_epoch = max(1, len(train_loader))
    plateau = (ReduceLROnPlateau(cfg.plateau_factor, cfg.plateau_patience,
                                 cfg.plateau_threshold)
               if cfg.lr_policy == "plateau" else None)
    scan_k = max(1, int(cfg.scan_steps))
    # a chunk is one CUDA graph on the card in one process (gloo's
    # collectives are not captured), K eager steps elsewhere
    graphs = scan_k > 1 and device.type == "cuda" and not mesh.in_group()
    if scan_k > 1 and lead:
        print(f"[scan_steps] {scan_k} updates a chunk: " + (
            "each full chunk one CUDA graph a bag shape" if graphs
            else "eager steps (" + ("a process group: its collectives are "
                                    "not captured" if mesh.in_group()
                                    else f"no graphs on {device.type}")
            + ")"))
    optimizer = make_optimizer(cfg, model.parameters(), capturable=graphs)
    scheduler = make_scheduler(cfg, optimizer, steps_per_epoch, plateau)
    step = 0
    if state is not None:
        step = restore_state(model, optimizer, scheduler, state)
    saving = cfg.checkpoints not in ("#", "")
    writing = saving and lead
    latest_name = f"{mode}_fold_{cfg.cur_fold + 1}_latest"
    latest_path = next((p for p in (
        os.path.join(cfg.checkpoints, latest_name + suffix)
        for suffix in (SUFFIX, JAX_SUFFIX)) if os.path.exists(p)), None)
    start_epoch = 0
    if cfg.resume and saving and latest_path is not None:
        step = restore_state(model, optimizer, scheduler, latest_path,
                             mode, cfg.attn_dim)
        start_epoch = min(step // steps_per_epoch, cfg.epochs)
        print(f"[resume] {latest_path}: step {step} -> starting at epoch "
              f"{start_epoch}")

    if layout is not None:
        for m in (model, teacher):
            if m is not None:
                mesh.broadcast_state(m, layout)
    # the step without the schedule (a chunk steps it K at a time), and the
    # single step with it
    step_fn, cache = make_step(cfg, model, optimizer, None, teacher, layout,
                               loader_dataset_size(train_loader))

    def train_step(tensors):
        metrics = step_fn(tensors)
        scheduler.step()
        return metrics

    runner = (ChunkRunner(step_fn, optimizer, scheduler, scan_k) if graphs
              else None)
    warm = set()  # the bag shapes whose first chunk ran as single steps
    evaluator = Evaluator(model, cfg, device, model_type)
    headline = evaluator.tags[-1]  # teas / stus / fused / simple
    score = "cindex" if evaluator.survival else "auc"
    # the dropout draws (a rank's stream: its data shard's)
    torch.manual_seed(cfg.seed + 1234 + (layout.data_index if layout else 0))
    start = time.time()
    cur_iters = start_epoch * steps_per_epoch
    losses = []  # device scalars, read once at the end

    def advance(ms, epoch, i):
        """After the updates ``ms`` (their metric dicts) at batch index
        ``i``: the counts, the losses, one eval-cadence check."""
        nonlocal step, cur_iters
        metrics = ms[-1]
        step += len(ms)
        losses.extend(m["loss"] for m in ms)
        prev_iters, cur_iters = cur_iters, cur_iters + len(ms)
        if plateau is not None:
            epoch_losses.extend(m["loss"] for m in ms)
        crossed = (cur_iters // cfg.eval_every_iters
                   > prev_iters // cfg.eval_every_iters)
        if (cfg.eval_during_training and test_loader is not None
                and crossed and lead):
            result = evaluate(evaluator, test_loader)
            if logger is not None:
                logger.log(eval_payload(evaluator, metrics, result))
            print("\rFold: [%2d/%2d] Epoch: [%2d/%2d] Iter [%4d/%4d] || "
                  "Time: %4.4f sec || Loss: %.4f || %s_%s %.4f"
                  % (cfg.cur_fold, cfg.kfold, epoch, cfg.epochs, i + 1,
                     len(train_loader), time.time() - start,
                     float(metrics["loss"]), score, headline,
                     result[f"{score}_{headline}"]),
                  end="", flush=True)

    for epoch in range(start_epoch, cfg.epochs):
        train_loader.set_epoch(epoch)
        epoch_losses = []
        bufs = {}  # pending batches by bag shape, first seen first
        for i, batch in enumerate(train_loader):
            tensors = batch_to_tensors(batch, device)
            if cache is not None:
                tensors.update(cache.boundary(tensors, batch.indices))
            if scan_k == 1:
                advance([train_step(tensors)], epoch, i)
                continue
            key = tuple(tensors["x_path10"].shape)
            buf = bufs.setdefault(key, [])
            buf.append(tensors)
            if len(buf) == scan_k:
                bufs[key] = []
                if runner is not None and key in warm:
                    advance(runner.run(key, buf), epoch, i)
                else:
                    warm.add(key)
                    advance([train_step(t) for t in buf], epoch, i)
        # the buffers that did not fill, one batch at a time
        for buf in bufs.values():
            for tensors in buf:
                advance([train_step(tensors)], epoch, len(train_loader) - 1)
        if plateau is not None and epoch_losses:
            mean_loss = float(torch.stack(epoch_losses).mean())
            set_learning_rate(optimizer, cfg.lr * plateau.step(mean_loss))
        every = cfg.save_every_epochs
        if writing and every > 0 and (epoch + 1) % every == 0:
            save_checkpoint(cfg.checkpoints, latest_name, model, optimizer,
                            scheduler, step,
                            extra={"mode": mode, "task": cfg.task_type,
                                   "fold": cfg.cur_fold, "epoch": epoch + 1})

    if cache is not None:
        print(f"[distill cache] {cache.hits} hits, {cache.misses} misses")
    final = {}
    if test_loader is not None and lead:
        evaluator.model.eval()
        logits, labels = evaluator.logits(test_loader)
        detail = evaluator.metrics(logits, labels)
        names = ("cindex",) if evaluator.survival else METRIC_NAMES
        final = {n: detail[f"{n}_{headline}"] for n in names}
        final["detail"] = detail
        final["logits"] = logits
    if losses:
        final["train_losses"] = torch.stack(losses).tolist()
        final["train_loss"] = final["train_losses"][-1]
    path = None
    if writing:
        stamp = final if test_loader is not None else dict.fromkeys(
            ("cindex",) + METRIC_NAMES, 0.0)
        path = save_checkpoint(
            cfg.checkpoints, metric_stamped_name(
                cfg.cur_fold, cfg.epochs - 1, stamp, cfg.task_type, mode=mode),
            model, optimizer, scheduler, step,
            extra={"mode": mode, "task": cfg.task_type, "fold": cfg.cur_fold})
    return model, final, path


def make_step(cfg, model, optimizer, scheduler, teacher=None, layout=None,
              n_samples: int | None = None):
    """``(train step, teacher-output cache or None)`` of ``cfg.mode`` in
    ``layout``: the pipelined distillation step in a ``stage`` layout;
    distillation with ``distill_teacher_cache`` and a train set of known
    size ``n_samples``, the cached step and its cache on the model's
    device (filled by the layout's ranks together); else
    ``make_train_step``."""
    if layout is not None and layout.kind == "stage":
        return make_pipe_distill_step(model, teacher, cfg, optimizer,
                                      scheduler, layout), None
    if cfg.mode == "distillation" and cfg.distill_teacher_cache and n_samples:
        cache = TeacherBoundaryCache(
            sharded_boundary(make_teacher_boundary_fn(teacher), layout),
            n_samples, next(model.parameters()).device)
        return make_distill_cached_step(model, cfg, optimizer, scheduler,
                                        layout), cache
    return make_train_step(model, cfg, optimizer, scheduler, teacher=teacher,
                           layout=layout), None


def evaluate(evaluator, loader) -> dict:
    """The evaluator's metrics over ``loader`` in eval mode (the next train
    step puts the model back in its train mode)."""
    evaluator.model.eval()
    return evaluator.metrics(*evaluator.logits(loader))


def eval_payload(evaluator, train_metrics: dict, result: dict) -> dict:
    """What a cadence evaluation logs, in the shape of JAX ``_log_eval``
    (``trainers.py:346-357``): ``"training"``, every train metric as a
    float; ``"test"``, the headline metrics (``headline_metrics``), where a
    model type with several tags (teacher, student, scales) on a
    classification task has per-metric dicts of every tag's values in
    their place (``{"acc": {"acc_tea10": ...}}``: JAX's detail dicts
    overwrite its flat floats)."""
    tags = evaluator.tags
    test = headline_metrics(tags, evaluator.survival, result)
    if len(tags) > 1 and not evaluator.survival:
        test = {n: {f"{n}_{t}": result[f"{n}_{t}"] for t in tags}
                for n in test}
    return {"training": {k: float(v) for k, v in train_metrics.items()},
            "test": test}


def trainTeachersModel(model, dataloader, optimizer, scheduler, logger, args,
                       state=None):
    """Reference-named entry (``optimizer`` and ``scheduler`` are built from
    ``args``, as in JAX; ``state``: a checkpoint payload to start from)."""
    return run_training(args, model, dataloader, logger, model_type="teacher",
                        state=state)


def trainStudentsModel(model, dataloader, optimizer, scheduler, logger, args,
                       state=None):
    """Reference-named entry of the student, as :func:`trainTeachersModel`."""
    return run_training(args, model, dataloader, logger, model_type="student",
                        state=state)


def trainDistillation(student_model, teacher_model, dataloader, optimizer,
                      scheduler, logger, args, student_state=None):
    """Reference-named entry of distillation: the student trained against
    ``teacher_model`` (its weights already loaded), from the checkpoint
    payload ``student_state`` where given."""
    return run_training(args, student_model, dataloader, logger,
                        model_type="student", teacher=teacher_model,
                        state=student_state)


def trainDeformPathomicModel(model, dataloader, optimizer, scheduler, logger,
                             args, state=None):
    """Reference-named entry of deformpathomic, as
    :func:`trainTeachersModel`; the metrics are those of the fused
    logits."""
    return run_training(args, model, dataloader, logger, model_type="fused",
                        state=state)


def trainMultiScaleModel(model, dataloader, optimizer, scheduler, logger,
                         args, state=None):
    """The multiscale model's entry, as :func:`trainTeachersModel`; the
    headline metrics are the combined student's (JAX's ``run_training``
    with model type ``scales``)."""
    return run_training(args, model, dataloader, logger, model_type="scales",
                        state=state)


def _run_test(model, loader, args, model_type):
    """The evaluator over ``loader`` in eval mode -> ``(metrics, logits)``:
    ``{f"{metric}_{tag}": value}`` and ``{f"logits_{tag}": [M, C]}`` (and
    the risks on survival); for the one ``fused`` or ``simple`` tag the
    metrics are flat (``{"acc": ...}`` or ``{"cindex": ...}``), as JAX
    ``_metricdicts_to_flat`` gives them."""
    evaluator = Evaluator(model, args, next(model.parameters()).device,
                          model_type)
    model.eval()
    logits, labels = evaluator.logits(loader)
    metrics = evaluator.metrics(logits, labels)
    if model_type in ("fused", "simple"):
        metrics = {k.rsplit("_", 1)[0]: v for k, v in metrics.items()}
    return metrics, logits


def testTeachersModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "teacher")


def testStudentsModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "student")


def testDistillation(model, dataloader, args):
    """The distilled student's tags (``stu10``, ``stu20``, ``stus``)."""
    return _run_test(model, dataloader, args, "student")


def testDeformPathomicModel(model, dataloader, args):
    return _run_test(model, dataloader, args, "fused")


def testBaselineModel(model, dataloader, args):
    """A baseline's evaluation: the fused logits of the pathomic family,
    the logits of ``path``, ``transmil``, ``omic``, ``mcat`` and ``cmta``
    (JAX's, which the reference imports and never defined)."""
    return _run_test(model, dataloader, args, model_type_of(args.mode))


def testMultiScaleModel(model, dataloader, args):
    """The five tags of the multiscale model (teachers and students)."""
    return _run_test(model, dataloader, args, "scales")

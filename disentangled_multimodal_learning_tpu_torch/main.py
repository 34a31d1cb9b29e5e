"""Training entry of the port: the k-fold training loop of the root
``main.py`` (synthetic folds ``:184-192``; real cohorts ``:173-244``, see
``data/cohorts.py``) -> ``trainTeachersModel`` (``trainStudentsModel`` in
student mode, ``trainMultiScaleModel`` in multiscale mode,
``trainDeformPathomicModel`` in deformpathomic mode, ``trainDistillation``
in distillation mode, ``run_training`` itself for a baseline: ``path``,
``transmil``, ``omic``, ``pathomic``, ``pathomic_original``,
``pathomic_fg``, ``pathomic_ensemble``, ``mcat``, ``cmta``) ->
``run_training`` -> the train step.

    python -m disentangled_multimodal_learning_tpu_torch.main \\
        --config config/config_mine_diag2021.yaml --synthetic_data true \\
        [--checkpoints DIR | --checkpoints '#'] [--mode student | \\
        --mode multiscale | --mode deformpathomic --attn_dim 1 | \\
        --mode distillation --checkpoints_teacher DIR/teacher_fold_1_....pt \\
        | --mode transmil | --mode pathomic --fusion_type pofusion \\
        [--skip 1] | --mode mcat ...] [--init_type xavier --init_gain 0.02] \\
        [--resume true --save_every_epochs 1] [--kfold 1] [--epochs 1] \\
        [--device cpu]
    python -m disentangled_multimodal_learning_tpu_torch.main \\
        --config config/config_mine_diag2021.yaml --synthetic_data false \\
        --dataDir D [--coTraining false] [--external_eval true] \\
        [--buckets 1600,2500] [--printDataSplit true] [--workers 4]
    DMLT_COORDINATOR=127.0.0.1:29500 DMLT_NUM_PROCESSES=2 \\
        DMLT_PROCESS_ID=<r> python -m \\
        disentangled_multimodal_learning_tpu_torch.main ... --nodes 2 \\
        [--tp_devices 2 | --branch_devices 2 | --mode distillation \\
        --pipe_devices 2 ... | --mode transmil --seq_shard_devices 2]

Distillation builds ``(student, teacher)`` and restores the teacher from
``checkpoints_teacher`` and the student from ``checkpoints_student``, where
either is set (root ``main.py:89-113``).  ``reload`` restores the full
state of the other modes from ``checkpoints_teacher`` (teacher and
uniteacher) or ``checkpoints_student`` before training (``:115-128``).
Each fold writes a metric-stamped checkpoint into ``checkpoints`` (``.pt``,
``utils/checkpoint.py``) unless that is ``"#"``, and prints its path.

It trains on the card (``cuda``) unless ``--device cpu`` asks for the CPU,
and raises where there is no card.  Without ``--config`` the in-code
diag2021 preset is used (no ``yaml`` needed).  With ``nodes > 1`` (or a
``DMLT_COORDINATOR`` rendezvous) each process is one rank of a process
group (root ``main.py:146-170``; ``parallel/mesh.py``): on the card
``cuda:<rank % local cards>`` under NCCL, on the CPU gloo; each fold
trains in the layout ``run_training`` chooses, rank 0 alone evaluates,
logs, saves and prints.  Synthetic fold ``f`` trains
on ``synthetic_train_size`` bags drawn from seed ``seed + f`` and evaluates
on ``synthetic_test_size`` bags from ``seed + 100 + f``; a real fold on the
cohorts' patient-level folds; each with a fresh seeded model, as in JAX.
The train loader is prefetched on a thread (``workers`` batches ahead, 2 at
0) and bucketed with ``buckets``, as JAX's ``_make_loaders`` does.  A
``dataDir`` without the cohort raises ``FileNotFoundError`` (JAX falls back
to synthetic bags).  Prints the final metrics of each fold.
"""

from __future__ import annotations

import sys

import numpy as np

from .config import Config
from .data.bucketing import BucketedBagLoader
from .data.cohorts import cohort_folds
from .data.loader import BagLoader, PrefetchLoader
from .data.synthetic import SyntheticBagDataset
from .models.factory import BASELINES, define_net, require_device
from .parallel import mesh
from .train.evaluation import export_dir, model_type_of
from .train.trainers import (run_training, trainDeformPathomicModel,
                             trainDistillation, trainMultiScaleModel,
                             trainStudentsModel, trainTeachersModel)
from .utils.checkpoint import load_checkpoint, restore_state
from .utils.logging import Logger

_TRAINS = {"student": trainStudentsModel,
           "multiscale": trainMultiScaleModel,
           "deformpathomic": trainDeformPathomicModel}


def _is_set(path) -> bool:
    return path not in ("#", "", None)


def dispatch_training(cfg: Config, device, loaders, logger=None):
    """``cfg.mode`` -> its trainer on fresh seeded models (root
    ``main.py:89-128``); returns the trainer's ``(model, metrics,
    checkpoint path)``."""
    if cfg.mode == "distillation":
        student, teacher = define_net(cfg, device)
        if _is_set(cfg.checkpoints_teacher):
            restore_state(teacher, None, None, cfg.checkpoints_teacher)
        state = (load_checkpoint(cfg.checkpoints_student)
                 if _is_set(cfg.checkpoints_student) else None)
        return trainDistillation(student, teacher, loaders, None, None,
                                 logger, cfg, student_state=state)
    model = define_net(cfg, device)
    ckpt = (cfg.checkpoints_teacher if cfg.mode in ("teacher", "uniteacher")
            else cfg.checkpoints_student)
    state = load_checkpoint(ckpt) if cfg.reload and _is_set(ckpt) else None
    if cfg.mode in BASELINES:
        return run_training(cfg, model, loaders, logger,
                            model_type=model_type_of(cfg.mode), state=state)
    train = _TRAINS.get(cfg.mode, trainTeachersModel)
    return train(model, loaders, None, None, logger, cfg, state=state)


def synthetic_fold_datasets(cfg: Config, fold: int):
    """The JAX entry's synthetic fold (``main.py:79-86``)."""
    kw = dict(fixdim=cfg.fixdim, path_dim=cfg.input_path_dim,
              omic_dim=cfg.input_size_omic,
              omic_tumor_dim=cfg.input_size_omic_tumor,
              omic_immune_dim=cfg.input_size_omic_immune,
              label_dim=cfg.label_dim)
    return (SyntheticBagDataset(size=cfg.synthetic_train_size,
                                seed=cfg.seed + fold, **kw),
            SyntheticBagDataset(size=cfg.synthetic_test_size,
                                seed=cfg.seed + 100 + fold, **kw))


def eval_loader(cfg: Config, test_ds):
    """Sequential eval batches, the last padded; per bucket with
    ``buckets``."""
    if cfg.buckets:
        return BucketedBagLoader(test_ds, cfg.batch_size,
                                 buckets=cfg.buckets.split(","),
                                 shuffle=False, drop_last=False,
                                 seed=cfg.seed)
    return BagLoader(test_ds, cfg.batch_size)


def make_loaders(cfg: Config, train_ds, test_ds):
    """``(train, test)`` loaders of a fold (root ``main.py:52-77``)."""
    if cfg.buckets:
        train = BucketedBagLoader(train_ds, cfg.batch_size,
                                  buckets=cfg.buckets.split(","),
                                  shuffle=True, drop_last=True, seed=cfg.seed)
    else:
        train = BagLoader(train_ds, cfg.batch_size, shuffle=True,
                          drop_last=True, seed=cfg.seed)
    return (PrefetchLoader(train, depth=max(1, cfg.workers or 2)),
            eval_loader(cfg, test_ds) if test_ds is not None else None)


def fold_datasets(cfg: Config):
    """Yield ``(fold, train dataset, test dataset)``: synthetic, or the
    cohorts' folds (with ``printDataSplit``, each fold's rows written to
    ``checkpoints``, or the working directory where that is ``"#"``)."""
    if cfg.synthetic_data:
        for fold in range(cfg.kfold):
            yield (fold, *synthetic_fold_datasets(cfg, fold))
        return
    yield from cohort_folds(cfg, export_dir(cfg) if cfg.printDataSplit
                            else None)


def main(cfg: Config, device="cuda", logger=None) -> dict:
    """Train every fold; returns ``{fold: final metrics}``.  Each cadence
    evaluation goes to ``logger``, by default a :class:`Logger` of ``cfg``
    (nothing under ``debug``, else a JSONL file in ``log_dir``; on rank 0
    alone in a process group, which this joins with ``nodes > 1``)."""
    joined = mesh.wants_process_group(cfg) and not mesh.in_group()
    if joined:
        device = mesh.init_process_group(cfg.nodes, device)
    try:
        return _train_folds(cfg, require_device(device), logger)
    finally:
        if joined:
            mesh.leave_process_group()


def _train_folds(cfg: Config, device, logger) -> dict:
    lead = mesh.world_rank()[1] == 0
    if logger is None:
        logger = Logger(cfg if lead else cfg.replace(debug=True))
    np.random.seed(cfg.seed)
    results = {}
    # rank 0 alone writes the split dumps
    for fold, train_ds, test_ds in fold_datasets(
            cfg if lead else cfg.replace(printDataSplit=False)):
        # a cohort's gene lists size the omic encoders
        sizes = {} if cfg.synthetic_data else train_ds.omic_sizes
        fold_cfg = cfg.replace(cur_fold=fold, **sizes)
        loaders = make_loaders(fold_cfg, train_ds, test_ds)
        _, metrics, ckpt = dispatch_training(fold_cfg, device, loaders,
                                             logger)
        results[fold] = metrics
        if lead:
            print(f"\n[fold {fold}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()
                if isinstance(v, float)) + f"  ckpt={ckpt}")
    return results


if __name__ == "__main__":
    cfg, args = Config.from_args(sys.argv[1:])
    main(cfg, device=args.device)

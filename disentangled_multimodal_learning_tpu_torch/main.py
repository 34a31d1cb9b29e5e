"""Training entry of the port: the k-fold training loop of the root
``main.py`` (synthetic folds, ``main.py:184-192``) -> ``trainTeachersModel``
(``trainStudentsModel`` in student mode, ``trainDeformPathomicModel`` in
deformpathomic mode, ``trainDistillation`` in distillation mode) ->
``run_training`` -> the train step.

    python -m disentangled_multimodal_learning_tpu_torch.main \\
        --config config/config_mine_diag2021.yaml --synthetic_data true \\
        [--checkpoints DIR | --checkpoints '#'] [--mode student | \\
        --mode deformpathomic --attn_dim 1 | --mode distillation \\
        --checkpoints_teacher DIR/teacher_fold_1_....pt] [--resume true \\
        --save_every_epochs 1] [--kfold 1] [--epochs 1] [--device cpu]

Distillation builds ``(student, teacher)`` and restores the teacher from
``checkpoints_teacher`` and the student from ``checkpoints_student``, where
either is set (root ``main.py:89-113``).  ``reload`` restores the full
state of the other modes from ``checkpoints_teacher`` (teacher and
uniteacher) or ``checkpoints_student`` before training (``:115-128``).
Each fold writes a metric-stamped checkpoint into ``checkpoints`` (``.pt``,
``utils/checkpoint.py``) unless that is ``"#"``, and prints its path.

It trains on the card (``cuda``) unless ``--device cpu`` asks for the CPU,
and raises where there is no card.  Without ``--config`` the in-code
diag2021 preset is used (no ``yaml`` needed).  Fold ``f`` trains on ``synthetic_train_size`` bags drawn from seed
``seed + f`` and evaluates on ``synthetic_test_size`` bags from
``seed + 100 + f``, with a fresh seeded model per fold, as in JAX.  Prints
the final metrics of each fold.
"""

from __future__ import annotations

import sys

import numpy as np

from .config import Config
from .data.loader import BagLoader
from .data.synthetic import SyntheticBagDataset
from .models.factory import define_net, require_device
from .train.trainers import (trainDeformPathomicModel, trainDistillation,
                             trainStudentsModel, trainTeachersModel)
from .utils.checkpoint import load_checkpoint, restore_state

_TRAINS = {"student": trainStudentsModel,
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


def make_loaders(cfg: Config, train_ds, test_ds):
    return (BagLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True,
                      seed=cfg.seed),
            BagLoader(test_ds, cfg.batch_size))


def main(cfg: Config, device="cuda", logger=None) -> dict:
    """Train every fold; returns ``{fold: final metrics}``."""
    if not cfg.synthetic_data:
        raise NotImplementedError(
            "the port has no real-data loaders yet (they come with the "
            "real-data loaders: datasets, splits, packing); pass "
            "--synthetic_data true")
    device = require_device(device)
    np.random.seed(cfg.seed)
    results = {}
    for fold in range(cfg.kfold):
        cfg = cfg.replace(cur_fold=fold)
        loaders = make_loaders(cfg, *synthetic_fold_datasets(cfg, fold))
        _, metrics, ckpt = dispatch_training(cfg, device, loaders, logger)
        results[fold] = metrics
        print(f"\n[fold {fold}] " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()
            if isinstance(v, float)) + f"  ckpt={ckpt}")
    return results


if __name__ == "__main__":
    cfg, args = Config.from_args(sys.argv[1:])
    main(cfg, device=args.device)

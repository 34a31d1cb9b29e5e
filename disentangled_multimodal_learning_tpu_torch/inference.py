"""Serving entry of the port: evaluate a teacher, student, distilled
student, multiscale, deformpathomic or baseline checkpoint on the fold-0
test set (counterpart of the root ``inference.py`` -> ``testTeachersModel``
/ ``testStudentsModel`` / ``testDistillation`` / ``testMultiScaleModel`` ->
``Evaluator.distill_val``, ``testDeformPathomicModel`` ->
``Evaluator.fused_val``, ``testBaselineModel`` -> ``fused_val`` for the
pathomic family, ``simple_val`` for ``path``, ``transmil``, ``omic``,
``mcat`` and ``cmta``).

    python -m disentangled_multimodal_learning_tpu_torch.inference \\
        --config config/config_mine_diag2021.yaml --synthetic_data true \\
        [--mode student | --mode distillation | --mode multiscale | \\
        --mode deformpathomic --attn_dim 1 | --mode cmta | ...] \\
        [--checkpoint model.pt | \\
        model.pth] [--save4visualization true] [--device cpu]
    python -m disentangled_multimodal_learning_tpu_torch.inference \\
        --config config/config_mine_diag2021.yaml --synthetic_data false \\
        --dataDir D [--coTraining false | --external_eval true] \\
        [--buckets 1600,2500] --checkpoint model.pt

The fold-0 test set is the synthetic one (seed ``seed + 100``) or the
cohorts' fold 0 rebuilt from the seed (``data/cohorts.py``; CPTAC's with
``external_eval``), per bucket with ``buckets``; a ``dataDir`` without the
cohort raises ``FileNotFoundError`` (JAX falls back to synthetic bags).

It runs on the card (``cuda``) unless ``--device cpu`` asks for the CPU,
and raises where there is no card.  With ``nodes > 1`` (or a
``DMLT_COORDINATOR`` rendezvous) it joins the process group as the
training entry does (``parallel/mesh.py``); rank 0 evaluates, prints and
logs, and the other ranks return empty results.  Without ``--config``
the in-code diag2021 preset is used (no ``yaml`` needed).  The weights
come from the checkpoint (the port's ``.pt`` or a reference-named ``.pth``; else
``checkpoints_teacher`` for the teachers, ``checkpoints_student`` for the
other modes, as in JAX); without one they are a seeded random init, with a
warning.  Distillation evaluates the student of ``(student, teacher)``.
Prints ``name_tag=value`` for acc, f1, auc, bac, sens, spec and prec of
tea10, tea20 and teas (stu10, stu20 and stus for the students; all five
for multiscale), or
``cindex_tag=value`` on survival; deformpathomic prints ``name=value`` for
its fused output, a baseline ``name=value`` for its one output (on
survival ``cindex=value``; ``path``, ``transmil`` and ``omic`` refuse
survival).  ``save4visualization`` writes the attention maps of the
teachers and students to ``attention_fold{k}.npz`` in ``checkpoints``
(root ``inference.py:134-145``).
"""

from __future__ import annotations

import os
import sys

from .config import Config
from .data.cohorts import cohort_folds
from .data.loader import BagLoader
from .data.synthetic import SyntheticBagDataset
from .main import eval_loader
from .models.factory import define_net, require_device
from .parallel import mesh
from .train.evaluation import (TAGS, Evaluator, export_dir,
                               headline_metrics, model_type_of)
from .train.trainers import (testBaselineModel, testDeformPathomicModel,
                             testDistillation, testMultiScaleModel,
                             testStudentsModel, testTeachersModel)
from .utils.checkpoint import restore_state
from .utils.logging import Logger

_TESTS = {"teacher": testTeachersModel, "uniteacher": testTeachersModel,
          "student": testStudentsModel, "distillation": testDistillation,
          "multiscale": testMultiScaleModel,
          "deformpathomic": testDeformPathomicModel}


def build_fold0_test_loader(cfg: Config):
    """The fold-0 test set of the JAX entry: synthetic (``seed + 100``),
    or the cohorts' fold 0."""
    if not cfg.synthetic_data:
        _, _, test_ds = next(cohort_folds(cfg))
        return eval_loader(cfg, test_ds)
    ds = SyntheticBagDataset(
        size=cfg.synthetic_test_size, fixdim=cfg.fixdim,
        path_dim=cfg.input_path_dim, omic_dim=cfg.input_size_omic,
        omic_tumor_dim=cfg.input_size_omic_tumor,
        omic_immune_dim=cfg.input_size_omic_immune, label_dim=cfg.label_dim,
        seed=cfg.seed + 100)
    return BagLoader(ds, cfg.batch_size)


def main(cfg: Config, checkpoint: str | None = None, device="cuda",
         model=None, logger=None) -> tuple[dict, dict]:
    """Evaluate, print and log ``{"inference": metrics}`` to ``logger``
    (by default a :class:`Logger` of ``cfg``: nothing under ``debug``, else
    a JSONL file in ``log_dir``).  Returns ``({f"{metric}_{tag}": value},
    {f"logits_{tag}": [M, C]})`` over the M test bags.  A ``model`` given
    here is used as it is (weights already loaded, on ``device``)."""
    joined = mesh.wants_process_group(cfg) and not mesh.in_group()
    if joined:
        device = mesh.init_process_group(cfg.nodes, device)
    try:
        if mesh.world_rank()[1] != 0:
            return {}, {}
        return _evaluate(cfg, checkpoint, require_device(device), model,
                         logger)
    finally:
        if joined:
            mesh.leave_process_group()


def _evaluate(cfg: Config, checkpoint, device, model, logger):
    if logger is None:
        logger = Logger(cfg)
    loader = build_fold0_test_loader(cfg)
    if not cfg.synthetic_data:  # a cohort's gene lists size the encoders
        cfg = cfg.replace(**loader.dataset.omic_sizes)
    if model is None:
        model = define_net(cfg, device)
        if cfg.mode == "distillation":
            model = model[0]  # the student
        ckpt = checkpoint or (
            cfg.checkpoints_teacher if cfg.mode in ("teacher", "uniteacher")
            else cfg.checkpoints_student)
        if ckpt and ckpt not in ("#", ""):
            restore_state(model, None, None, ckpt)
            print(f"[inference] loaded checkpoint: {ckpt}")
        else:
            print("[inference] WARNING: no checkpoint given, evaluating a "
                  f"random init (seed {cfg.seed})")
    metrics, logits = _TESTS.get(cfg.mode, testBaselineModel)(model, loader,
                                                              cfg)
    model_type = model_type_of(cfg.mode)
    if cfg.save4visualization and model_type in ("teacher", "student",
                                                 "scales"):
        out_dir = export_dir(cfg)
        os.makedirs(out_dir, exist_ok=True)
        path = Evaluator(model, cfg, device, model_type).export_attention_maps(
            loader, os.path.join(out_dir, f"attention_fold{cfg.cur_fold}.npz"))
        print(f"[inference] attention maps -> {path}")
    print(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    if model_type in ("fused", "simple"):  # flat already
        logger.log({"inference": metrics})
    else:
        logger.log({"inference": headline_metrics(
            TAGS[model_type], cfg.task_type == "survival", metrics)})
    return metrics, logits


if __name__ == "__main__":
    cfg, args = Config.from_args(sys.argv[1:])
    main(cfg, checkpoint=args.checkpoint, device=args.device)

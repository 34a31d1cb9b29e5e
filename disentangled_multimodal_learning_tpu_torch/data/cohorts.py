"""The real-data folds of the entries (the root ``main.py:173-244`` and
``inference.py:54-86``): CPTAC's folds under ``external_eval``; otherwise
TCGA's folds, zipped with IvYGAP's and co-trained as ``ConcatDataset([ivy,
tcga])`` with ``coTraining``.  Each cohort's folds are patient-level
(``data/splits.py``) from ``cfg.seed``, so that the serving entry rebuilds
fold 0.  A cohort directory that is not there raises ``FileNotFoundError``
naming it: unlike JAX, the port never falls back to synthetic bags.  Without
``coTraining`` the IvYGAP manifest is not read (JAX reads it and drops it).
"""

from __future__ import annotations

import os

from .datasets import (MANIFESTS, ConcatDataset, CPTAC_Dataset,
                       IvYGAP_Dataset, TCGA_Dataset)
from .manifest import Table
from .splits import dump_split_csvs, kfold_patient_split

_DATASETS = {"TCGA": TCGA_Dataset, "IvYGAP": IvYGAP_Dataset,
             "CPTAC": CPTAC_Dataset}


def read_manifest(cfg, cohort: str) -> Table:
    """``<dataDir>/<cohort>/``'s manifest."""
    root = os.path.join(cfg.dataDir, cohort)
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no cohort directory {root} (dataDir {cfg.dataDir!r}): the port "
            "reads real data from there and does not fall back to synthetic "
            "bags (ask for those with --synthetic_data true)")
    return Table.read_csv(os.path.join(root, MANIFESTS[cohort]))


def _cohort(cfg, cohort: str, dump_dir: str | None):
    """``[(fold, train dataset, test dataset)]`` of one cohort; each fold's
    rows written to ``dump_dir`` where given (``printDataSplit``)."""
    table = read_manifest(cfg, cohort)
    for fold, train, test in kfold_patient_split(table.column_at(0),
                                                 cfg.kfold, cfg.seed):
        if dump_dir is not None:
            paths = dump_split_csvs(dump_dir, cohort, fold, table, train, test)
            print(f"[main] split manifests: {paths['train']}, {paths['test']}")
        make = _DATASETS[cohort]
        yield fold, make(table.select(train), cfg), make(table.select(test), cfg)


def cohort_folds(cfg, dump_dir: str | None = None):
    """Yield ``(fold, train dataset, test dataset)`` of ``cfg``'s cohorts;
    each dataset's ``omic_sizes`` are the config fields its model needs
    (IvYGAP's under co-training, as in JAX)."""
    if cfg.external_eval:
        print("Now Training CPTAC!")
        yield from _cohort(cfg, "CPTAC", dump_dir)
        return
    print("Now is the TCGA and IvYGAP CoTraining!")
    tcga = _cohort(cfg, "TCGA", dump_dir)
    if not cfg.coTraining:
        yield from tcga
        return
    ivy = _cohort(cfg, "IvYGAP", dump_dir)
    for (fold, train_t, test_t), (_, train_i, test_i) in zip(tcga, ivy):
        yield (fold, ConcatDataset([train_i, train_t]),
               ConcatDataset([test_i, test_t]))

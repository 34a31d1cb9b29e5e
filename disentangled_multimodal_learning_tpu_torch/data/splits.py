"""K-fold patient-level splits (counterpart of
``disentangled_multimodal_learning_tpu/data/splits.py:14-70``): the unique
patient ids (column 0 of a manifest) shuffled by ``RandomState(seed)``, then
``KFold(shuffle=True, random_state=seed)`` over them (sklearn's, written
out), and each fold's rows the ones whose patient falls in its halves.  The
same seed gives the same folds, so the serving entry rebuilds fold 0.
"""

from __future__ import annotations

import os

import numpy as np


def _kfold_indices(n: int, k: int, seed: int):
    """``sklearn.model_selection.KFold(k, shuffle=True,
    random_state=seed).split(range(n))``: a seeded permutation cut into k
    runs, the first ``n % k`` one longer."""
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    fold_sizes = np.full(k, n // k, dtype=int)
    fold_sizes[: n % k] += 1
    current = 0
    for fs in fold_sizes:
        test = idx[current: current + fs]
        train = np.concatenate([idx[:current], idx[current + fs:]])
        current += fs
        yield np.sort(train), np.sort(test)


def kfold_patient_split(patient_col, k: int, seed: int):
    """Yield ``(fold, train_mask, test_mask)`` over the manifest's rows,
    ``patient_col`` its column 0 (typed as pandas types it:
    ``data/manifest.py``)."""
    col = np.asarray(patient_col)
    patients = np.unique(col)
    rng = np.random.RandomState(seed)
    rng.shuffle(patients)  # the reference shuffles the unique ids first
    for fold, (train_idx, test_idx) in enumerate(
            _kfold_indices(len(patients), k, seed)):
        train_p = set(patients[train_idx].tolist())
        test_p = set(patients[test_idx].tolist())
        yield (fold, np.array([p in train_p for p in col]),
               np.array([p in test_p for p in col]))


def dump_split_csvs(out_dir: str, cohort: str, fold: int, table,
                    train_mask, test_mask) -> dict:
    """Write a fold's train and test rows of ``table`` (a
    ``manifest.Table``) to ``split_<cohort>_fold<k>_{train,test}.csv`` in
    ``out_dir`` (``printDataSplit``); returns ``{"train": path, "test":
    path}``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for tag, mask in (("train", train_mask), ("test", test_mask)):
        path = os.path.join(
            out_dir, f"split_{cohort.lower()}_fold{fold}_{tag}.csv")
        table.select(mask).to_csv(path)
        paths[tag] = path
    return paths

"""Deterministic synthetic bags honouring the 6-tuple contract (numpy port of
``disentangled_multimodal_learning_tpu/data/synthetic.py``: the same seed
gives the same arrays).  Labels are class-conditional, so the task is
learnable."""

from __future__ import annotations

import numpy as np

from .contract import NUM_LABEL_COLUMNS, Batch, LabelCol


class SyntheticBagDataset:
    def __init__(self, size: int = 64, fixdim: int = 2500, path_dim: int = 1024,
                 omic_dim: int = 431, omic_tumor_dim: int = 59,
                 omic_immune_dim: int = 361, label_dim: int = 4,
                 seed: int = 42):
        self.size = size
        self.fixdim = fixdim
        self.path_dim = path_dim
        self.dims = (omic_dim, omic_tumor_dim, omic_immune_dim)
        self.seed = seed
        rng = np.random.default_rng(seed)
        # the draws, in the JAX dataset's order (full-length bags, the
        # signal means from the same generator, 4 survival bins)
        self._path_means = rng.normal(0, 0.5, (label_dim, path_dim)).astype(np.float32)
        self._omic_means = rng.normal(0, 0.5, (label_dim, omic_dim)).astype(np.float32)
        self._labels = rng.integers(0, label_dim, size=size)
        self._grade = rng.integers(0, 3, size=size)
        self._subtype = rng.integers(0, 3, size=size)
        self._surv_bin = rng.integers(0, 4, size=size)
        self._censor = rng.integers(0, 2, size=size)
        self._surv_time = rng.integers(30, 3000, size=size)

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        y = int(self._labels[idx])
        x10 = rng.normal(0, 1, (self.fixdim, self.path_dim)).astype(np.float32)
        x10 += self._path_means[y][None, :]
        x20 = rng.normal(0, 1, (self.fixdim, self.path_dim)).astype(np.float32)
        x20 += self._path_means[y][None, :]
        omic = rng.normal(0, 1, (self.dims[0],)).astype(np.float32) + self._omic_means[y]
        omic_tumor = omic[: self.dims[1]].copy()
        omic_immune = omic[self.dims[0] - self.dims[2]:].copy()
        label = np.zeros(NUM_LABEL_COLUMNS, dtype=np.int32)
        label[LabelCol.IDH] = y % 2
        label[LabelCol.CODEL_1P19Q] = (y // 2) % 2
        label[LabelCol.CDKN] = 0
        label[LabelCol.HIS] = y % 3
        label[LabelCol.GRADE] = self._grade[idx]
        label[LabelCol.DIAG] = y
        label[LabelCol.HIS_2CLASS] = y % 2
        label[LabelCol.SUBTYPE] = self._subtype[idx]
        label[LabelCol.SURVIVAL_BIN] = self._surv_bin[idx]
        label[LabelCol.CENSOR] = self._censor[idx]
        label[LabelCol.EVENT] = 1 - self._censor[idx]
        label[LabelCol.SURVIVAL_TIME] = self._surv_time[idx]
        return x10, x20, omic, omic_tumor, omic_immune, label

    def wsi_id(self, idx: int) -> str:
        return f"SYN-{idx:05d}"

    def batch(self, indices) -> Batch:
        items = [self[int(i)] for i in indices]
        return Batch(*[np.stack([it[j] for it in items]) for j in range(6)],
                     wsi_id=np.array([self.wsi_id(int(i)) for i in indices]))

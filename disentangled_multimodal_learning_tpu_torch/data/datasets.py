"""Cohort datasets, TCGA, IvYGAP and CPTAC (counterpart of
``disentangled_multimodal_learning_tpu/data/datasets.py:59-284``), on this
layout::

    <dataDir>/<COHORT>/
        multimodal_diag_survival_<tag>.csv   # the manifest
        feats10/<WSI_ID>.npy                 # [n, 1024] float, 10x scale
        feats20/<WSI_ID>.npy                 # [n, 1024] float, 20x scale
        feats10.dmltpack, feats20.dmltpack   # optional packs (data/packing.py),
                                             #   taken over the .npy files
        genes_tumor.txt, genes_immune.txt    # gene names, one a line

The manifest's columns are ``patient_id, WSI_ID, IDH, 1p19q, CDKN, His,
Grade, Diag, His_2class, Subtype, survival_bin, censor, event,
survival_time`` and then one column a gene (the full omic vector).  A gene
list that is missing falls back to the first 59 (tumor) or last 361
(immune) gene columns; names not among the columns are dropped.  A
dataset exposes its omic sizes as ``omic_sizes`` (the config fields
``input_size_omic{,_tumor,_immune}``), which the entries put on the fold's
config; unlike the reference's ctor it leaves the config it is given as it
is.  An empty ``Diag`` takes the WHO-2021 rule (``contract.derive_diag2021``).  A
bag is zero-padded or truncated to ``fixdim`` rows (``pad_to``: a bucket's
side squared, ``data/bucketing.py``), by the threaded C++ reader
(``data/native_io.py``) from the pack or the ``.npy`` files.

JAX quirk kept: an ``IDH`` string that is neither "WT" nor a number (for
example "Mutant") reads as wild type, as ``int(float("Mutant"))`` fails and
the value falls back to 0 (JAX ``datasets.py:148``).
"""

from __future__ import annotations

import os

import numpy as np

from .contract import NUM_LABEL_COLUMNS, Batch, LabelCol, derive_diag2021
from .native_io import read_bags
from .packing import PackFile

CLINICAL_COLS = (
    "patient_id", "WSI_ID", "IDH", "1p19q", "CDKN", "His", "Grade", "Diag",
    "His_2class", "Subtype", "survival_bin", "censor", "event",
    "survival_time")
SCALES = ("feats10", "feats20")  # the bags' directories, 10x then 20x
# each cohort's manifest under <dataDir>/<COHORT>/ (root main.py:197-221)
MANIFESTS = {"TCGA": "multimodal_diag_survival_TCGA.csv",
             "IvYGAP": "multimodal_diag_survival_IvY.csv",
             "CPTAC": "multimodal_diag_survival_CPTAC.csv"}


def _read_gene_list(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def label_row(row: dict) -> np.ndarray:
    """A manifest row -> its 12 integer label columns (JAX
    ``_CohortDataset._label_row``, quirks included)."""
    lab = np.zeros(NUM_LABEL_COLUMNS, dtype=np.int32)

    def geti(name, default=0):
        try:
            return int(float(row.get(name, default)))
        except (TypeError, ValueError):
            return default

    idh_wt = (str(row.get("IDH", 0)).strip().upper() == "WT"
              or geti("IDH") == 0)
    codel = (str(row.get("1p19q", "")).strip().lower() == "codel"
             or geti("1p19q") == 1)
    his_g4 = str(row.get("His", "")).strip().upper() == "G4"
    lab[LabelCol.IDH] = 0 if idh_wt else 1
    lab[LabelCol.CODEL_1P19Q] = 1 if codel else 0
    lab[LabelCol.CDKN] = geti("CDKN")
    lab[LabelCol.HIS] = geti("His") if not his_g4 else 4
    lab[LabelCol.GRADE] = geti("Grade")
    diag = row.get("Diag", "")
    if (diag is None or (isinstance(diag, float) and np.isnan(diag))
            or str(diag) == ""):
        lab[LabelCol.DIAG] = derive_diag2021(idh_wt, codel,
                                             lab[LabelCol.CDKN], his_g4)
    else:
        lab[LabelCol.DIAG] = geti("Diag")
    lab[LabelCol.HIS_2CLASS] = geti("His_2class")
    lab[LabelCol.SUBTYPE] = geti("Subtype")
    lab[LabelCol.SURVIVAL_BIN] = geti("survival_bin")
    lab[LabelCol.CENSOR] = geti("censor")
    lab[LabelCol.EVENT] = geti("event", 1 - lab[LabelCol.CENSOR])
    lab[LabelCol.SURVIVAL_TIME] = geti("survival_time")
    return lab


class _CohortDataset:
    """The rows ``table`` (a ``manifest.Table``) of a cohort's manifest;
    the cohorts differ only in their directory."""

    COHORT = "TCGA"

    def __init__(self, table, args):
        self.fixdim = int(args.fixdim)
        self.path_dim = int(args.input_path_dim)
        self.root = os.path.join(args.dataDir, self.COHORT)
        self.table = table
        self.gene_cols = [c for c in table.columns if c not in CLINICAL_COLS]
        tumor = _read_gene_list(os.path.join(self.root, "genes_tumor.txt"))
        immune = _read_gene_list(os.path.join(self.root, "genes_immune.txt"))
        if tumor is None:
            tumor = self.gene_cols[: min(59, len(self.gene_cols))]
        if immune is None:
            immune = self.gene_cols[max(0, len(self.gene_cols) - 361):]
        self.tumor_cols = [g for g in tumor if g in self.gene_cols]
        self.immune_cols = [g for g in immune if g in self.gene_cols]
        self.omic_sizes = dict(input_size_omic=len(self.gene_cols),
                               input_size_omic_tumor=len(self.tumor_cols),
                               input_size_omic_immune=len(self.immune_cols))
        self._omic = [table.matrix(c) for c in (
            self.gene_cols, self.tumor_cols, self.immune_cols)]
        self._labels = np.zeros((len(table), NUM_LABEL_COLUMNS), np.int32)
        for i in range(len(table)):
            self._labels[i] = label_row(table.row(i))
        self._packs: dict = {}
        self._bag_lens: dict = {}

    def __len__(self):
        return len(self.table)

    def _pack_for(self, subdir):
        """``<root>/<subdir>.dmltpack``, opened once; None when absent."""
        if subdir not in self._packs:
            path = os.path.join(self.root, f"{subdir}.dmltpack")
            self._packs[subdir] = (PackFile(path) if os.path.exists(path)
                                   else None)
        return self._packs[subdir]

    def wsi_id(self, idx: int) -> str:
        return str(self.table["WSI_ID"][idx])

    def bag_len(self, idx: int) -> int:
        """The bag's true length (the pack's index, else the ``.npy``
        header; ``fixdim`` when unreadable), for bucketing."""
        if idx not in self._bag_lens:
            wsi = self.wsi_id(idx)
            pack = self._pack_for("feats10")
            if pack is not None and pack.rows(wsi) >= 0:
                self._bag_lens[idx] = pack.rows(wsi)
            else:
                path = os.path.join(self.root, "feats10", f"{wsi}.npy")
                try:
                    self._bag_lens[idx] = int(
                        np.load(path, mmap_mode="r").shape[0])
                except (OSError, ValueError):
                    self._bag_lens[idx] = self.fixdim
        return self._bag_lens[idx]

    def read_bags(self, subdir: str, rows, out) -> None:
        """The bags of ``rows`` at the scale ``subdir`` into ``out``
        (zeroed; ``out[i]`` is ``[L, path_dim]``, each bag's first ``L``
        rows kept), from the pack when it holds them all, else from the
        ``.npy`` files."""
        ids = [self.wsi_id(int(i)) for i in rows]
        pack = self._pack_for(subdir)
        if pack is not None and all(pack.rows(w) >= 0 for w in ids):
            pack.read_bags(ids, out)
        else:
            read_bags([os.path.join(self.root, subdir, f"{w}.npy")
                       for w in ids], out)

    def fields(self, rows) -> tuple:
        """The rows' omics (all genes, tumor, immune), labels and slide
        ids."""
        rows = np.asarray(rows, dtype=np.int64)
        return (*(m[rows] for m in self._omic), self._labels[rows],
                np.array([self.wsi_id(int(i)) for i in rows]))

    def batch(self, indices, pad_to: int | None = None) -> Batch:
        """The rows ``indices``, bags padded or truncated to ``pad_to``
        (default ``fixdim``) rows, from a pack when it holds them all."""
        dim = int(pad_to) if pad_to is not None else self.fixdim
        bags = [np.zeros((len(indices), dim, self.path_dim), np.float32)
                for _ in SCALES]
        for subdir, out in zip(SCALES, bags):
            self.read_bags(subdir, indices, out)
        return Batch(*bags, *self.fields(indices))


class TCGA_Dataset(_CohortDataset):
    COHORT = "TCGA"


class IvYGAP_Dataset(_CohortDataset):
    COHORT = "IvYGAP"


class CPTAC_Dataset(_CohortDataset):
    COHORT = "CPTAC"


class ConcatDataset:
    """Datasets end to end (``torch.utils.data.ConcatDataset``, reference
    ``main.py:322``); a batch is read by each member from its own rows and
    put back in the order asked.  Its omic sizes are the first member's
    (IvYGAP's under co-training, the cohort whose sizes JAX's config ends
    with)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.omic_sizes = self.datasets[0].omic_sizes

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d], int(idx) - int(self._offsets[d])

    def wsi_id(self, idx):
        ds, j = self._locate(idx)
        return ds.wsi_id(j)

    def bag_len(self, idx):
        ds, j = self._locate(idx)
        return ds.bag_len(j)

    def batch(self, indices, pad_to: int | None = None) -> Batch:
        """As a member's ``batch``, but with JAX's reading: each bag is cut
        at ``fixdim`` first, so that rows past ``fixdim`` are zeros where
        ``pad_to`` is longer (JAX reads the samples at ``fixdim``, then pads
        or truncates them).  Each member reads its rows' bags straight into
        the batch."""
        indices = np.asarray(indices, dtype=np.int64)
        member = np.searchsorted(self._offsets, indices, side="right") - 1
        first = self.datasets[0]
        dim = first.fixdim if pad_to is None else int(pad_to)
        bags = [np.zeros((len(indices), dim, first.path_dim), np.float32)
                for _ in SCALES]
        parts = []  # (the batch's positions, the member's fields of them)
        for d in np.unique(member):
            ds, at = self.datasets[d], np.nonzero(member == d)[0]
            rows = indices[at] - self._offsets[d]
            keep = min(dim, ds.fixdim)
            for subdir, out in zip(SCALES, bags):
                ds.read_bags(subdir, rows, [out[i, :keep] for i in at])
            parts.append((at, ds.fields(rows)))
        fields = []
        for j in range(len(parts[0][1])):
            arrs = [f[j] for _, f in parts]
            out = np.empty((len(indices),) + arrs[0].shape[1:],
                           np.result_type(*arrs))
            for (at, _), a in zip(parts, arrs):
                out[at] = a
            fields.append(out)
        return Batch(*bags, *fields)

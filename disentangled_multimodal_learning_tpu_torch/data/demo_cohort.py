"""A random cohort on the layout of ``data/datasets.py``, for trying the
real-data path where no cohort is at hand: a manifest (the 14 clinical
columns, then one column a gene), the two gene lists, ``[n, feat_dim]`` f32
``.npy`` bags at both scales, and optionally packs of them.  Everything is
drawn from ``seed``; the values mean nothing.  The port's tests write
tiny cohorts with :func:`write_cohort`, and ``chip_smoke.py`` the preset's
with :func:`write_demo_cohorts`.
"""

from __future__ import annotations

import os

import numpy as np

from .datasets import CLINICAL_COLS, MANIFESTS
from .packing import pack_bags


def write_cohort(data_dir: str, cohort: str, patient_ids, bag_lens, *,
                 feat_dim: int = 1024, genes: int = 431, tumor: int = 59,
                 immune: int = 361, seed: int = 0, cells=None,
                 pack=()) -> str:
    """Write ``<data_dir>/<cohort>/``: one slide a manifest row, the rows'
    patients ``patient_ids`` (repeat an id for a patient's second slide),
    slide ``i``'s bags ``bag_lens[i]`` rows long.  ``cells``: ``{row:
    {column: cell}}``, manifest cells (strings) that replace the drawn
    ones; ``pack``: the feature directories (``"feats10"``,
    ``"feats20"``) to pack as well.  Returns the cohort's directory."""
    rng = np.random.default_rng(seed)
    root = os.path.join(data_dir, cohort)
    os.makedirs(root, exist_ok=True)
    gene_names = [f"G{j:03d}" for j in range(genes)]
    with open(os.path.join(root, "genes_tumor.txt"), "w") as f:
        f.write("\n".join(gene_names[:tumor]) + "\n")
    with open(os.path.join(root, "genes_immune.txt"), "w") as f:
        f.write("\n".join(gene_names[genes - immune:]) + "\n")
    lines = [",".join(CLINICAL_COLS + tuple(gene_names))]
    for i, (pid, n) in enumerate(zip(patient_ids, bag_lens)):
        wsi = f"{cohort}-{i:03d}"
        idh, codel = rng.integers(0, 2, size=2)
        censor = int(rng.integers(0, 2))
        row = {"patient_id": str(pid), "WSI_ID": wsi, "IDH": str(idh),
               "1p19q": str(codel), "CDKN": str(-int(rng.integers(0, 3))),
               "His": str(int(rng.integers(1, 4))),
               "Grade": str(int(rng.integers(0, 3))),
               "Diag": str(int(rng.integers(0, 4))),
               "His_2class": str(int(rng.integers(0, 2))),
               "Subtype": str(int(rng.integers(0, 3))),
               "survival_bin": str(int(rng.integers(0, 4))),
               "censor": str(censor), "event": str(1 - censor),
               "survival_time": str(int(rng.integers(30, 3000)))}
        row.update((cells or {}).get(i, {}))
        values = rng.normal(0, 1, genes)
        lines.append(",".join([row[c] for c in CLINICAL_COLS]
                              + [f"{v:.6f}" for v in values]))
        for subdir in ("feats10", "feats20"):
            os.makedirs(os.path.join(root, subdir), exist_ok=True)
            np.save(os.path.join(root, subdir, f"{wsi}.npy"),
                    rng.normal(0, 1, (n, feat_dim)).astype(np.float32))
    with open(os.path.join(root, MANIFESTS[cohort]), "w") as f:
        f.write("\n".join(lines) + "\n")
    for subdir in pack:
        pack_bags(os.path.join(root, subdir),
                  os.path.join(root, f"{subdir}.dmltpack"))
    return root


def write_demo_cohorts(data_dir: str, seed: int = 0) -> dict:
    """TCGA (10 slides of 8 patients, two of them with two slides), IvYGAP
    (6 slides, its ``feats20`` packed) and CPTAC (6 slides) at the
    preset's widths; the bags 1,600, 2,500 or 3,100 patches long, so that
    at fixdim 2,500 some are padded and some truncated.  At the preset's
    seed (42) and 2 folds, fold 0 trains on TCGA's slides 0, 3, 4 and 9,
    all 1,600 long, and IvYGAP's 2, 4 and 5, 2,500 or 3,100 long: with
    buckets 1,600 and 2,500 its train batches are one of each.  Returns
    ``{cohort: directory}``."""
    s, m, l = 1600, 2500, 3100
    layout = {"TCGA": ([0, 1, 1, 2, 3, 4, 4, 5, 6, 7],
                       [s, m, l, s, s, l, s, m, l, s]),
              "IvYGAP": ([10, 11, 12, 13, 14, 15], [s, m, l, s, m, l]),
              "CPTAC": ([20, 21, 22, 23, 24, 25], [s, m, l, s, m, l])}
    return {cohort: write_cohort(
        data_dir, cohort, pids, lens, seed=seed + k,
        pack=("feats20",) if cohort == "IvYGAP" else ())
        for k, (cohort, (pids, lens)) in enumerate(layout.items())}


"""The 6-tuple bag data contract (port of
``disentangled_multimodal_learning_tpu/data/contract.py``): batches unpack as
``(x_path10, x_path20, x_omic, x_omic_tumor, x_omic_immune, label)`` with
``label [B, 12]`` integer columns, with the slide ids (``wsi_id``) the
attention-map export writes and the dataset rows (``indices``) the
distillation teacher-output cache keys on."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class LabelCol(enum.IntEnum):
    IDH = 0
    CODEL_1P19Q = 1
    CDKN = 2
    HIS = 3
    GRADE = 4
    DIAG = 5
    HIS_2CLASS = 6
    SUBTYPE = 7
    SURVIVAL_BIN = 8
    CENSOR = 9
    EVENT = 10
    SURVIVAL_TIME = 11


NUM_LABEL_COLUMNS = len(LabelCol)


@dataclasses.dataclass
class Batch:
    """A host-side batch (numpy arrays).  ``pad`` counts the duplicated
    trailing samples of a padded final batch and ``indices`` holds the
    dataset row of each sample (both set by ``loader.BagLoader``)."""

    x_path10: np.ndarray  # [B, N, 1024] float32
    x_path20: np.ndarray  # [B, N, 1024] float32
    x_omic: np.ndarray  # [B, 431] float32
    x_omic_tumor: np.ndarray  # [B, 59] float32
    x_omic_immune: np.ndarray  # [B, 361] float32
    label: np.ndarray  # [B, 12] int32
    wsi_id: np.ndarray | None = None  # [B] str
    pad: int = 0
    indices: np.ndarray | None = None  # [B] int


def derive_diag2021(idh_wt: bool, codel: bool, cdkn: int, his_g4: bool) -> int:
    """The WHO-2021 diagnosis of a manifest row with an empty ``Diag``
    (JAX ``contract.py:70``, reference ``main.py:74-83``): IDH wild type
    0 (grade-4 GBM); IDH mutant with 1p/19q codeletion 3 (oligo); else
    CDKN2A/B loss (``cdkn`` -1 or -2) or histology G4 1 (grade-4 astro);
    else 2 (grade-2/3 astro)."""
    if idh_wt:
        return 0
    if codel:
        return 3
    if cdkn in (-1, -2) or his_g4:
        return 1
    return 2

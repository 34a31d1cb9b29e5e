"""The teacher-output cache of distillation training (counterpart of
``disentangled_multimodal_learning_tpu/train/distill_cache.py``).

The distillation teacher is frozen and runs in eval mode, so its boundary
tensors for a sample (two ``[C]`` logit rows and two ``[256]`` feature
rows, ~1 KB) are the same every time the sample comes back.  The cache
computes them at a sample's first sight and replays them afterwards: a
batch whose rows have all been seen skips the teacher's forward (its four
K1-fwd launches at the preset), so steady-state distillation runs at the
student's cost.  The store lives on the model's device, filled by index,
so a replay is an index on the card and no copy to the host.

A cached row is the teacher's output for that sample in another batch;
it equals a recompute as long as a sample's outputs do not depend on its
batch-mates (the teacher has no batch statistics).  In a parallel layout
every rank holds the whole store: a miss runs the teacher on each rank's
rows and gathers them (``steps.sharded_boundary``), keyed by the rows'
dataset indices.  A loader without
``batch.indices``, or of unknown size, makes every batch recompute: the
uncached cost, never a wrong value.

JAX's ``train/teacher_detect.py`` has no counterpart: it maps the inputs of
flax's ``init`` for a teacher-family module, and the port builds its
modules eagerly and maps the forward's inputs per mode
(``steps.MODEL_INPUTS``).
"""

from __future__ import annotations

import numpy as np
import torch

from .steps import BOUNDARY_KEYS


class TeacherBoundaryCache:
    """A per-sample store of ``boundary_fn``'s outputs for ``n_samples``
    dataset rows on ``device``; :meth:`boundary` returns a batch's boundary
    tensors, replayed when every row has been seen.  ``hits`` and
    ``misses`` count the batches of each kind."""

    def __init__(self, boundary_fn, n_samples: int, device):
        self.fn = boundary_fn
        self.n = int(n_samples)
        self.device = torch.device(device)
        self.seen = np.zeros(self.n, dtype=bool)
        self.store: dict | None = None
        self.hits = 0
        self.misses = 0

    def boundary(self, tensors: dict, indices) -> dict:
        """``{k: [B, ...]}`` for ``k`` in ``BOUNDARY_KEYS`` of the batch
        ``tensors`` whose dataset rows are ``indices`` (``None``: unknown,
        recompute)."""
        if indices is None or self.n == 0:
            self.misses += 1
            return dict(zip(BOUNDARY_KEYS, self.fn(tensors)))
        idx = np.asarray(indices)
        rows = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        if self.store is not None and bool(self.seen[idx].all()):
            self.hits += 1
            return {k: self.store[k][rows] for k in BOUNDARY_KEYS}
        self.misses += 1
        out = dict(zip(BOUNDARY_KEYS, self.fn(tensors)))
        if self.store is None:
            self.store = {k: v.new_zeros((self.n,) + v.shape[1:])
                          for k, v in out.items()}
        for k, v in out.items():
            # the duplicated rows of a padded batch hold equal values
            self.store[k][rows] = v
        self.seen[idx] = True
        return out


def loader_dataset_size(loader) -> int | None:
    """The sample count of the dataset behind ``loader`` (or behind the
    loader it wraps); None where it has none."""
    for obj in (loader, getattr(loader, "loader", None)):
        ds = getattr(obj, "dataset", None)
        if ds is not None:
            try:
                return len(ds)
            except TypeError:
                return None
    return None

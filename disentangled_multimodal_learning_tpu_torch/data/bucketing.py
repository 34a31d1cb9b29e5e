"""Bucketed bags (counterpart of
``disentangled_multimodal_learning_tpu/data/bucketing.py``): each bag is
zero-padded to the smallest perfect-square bucket that holds it (truncated
to the largest when longer, the fixdim rule) and a batch holds bags of one
bucket, so that short bags stop paying for the longest.  Zero rows take part
in the attention unmasked, as the reference's offline fixdim padding does.
The batch order for a seed and an epoch is JAX's.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_BUCKETS = (400, 900, 1600, 2500)


def validate_buckets(buckets) -> tuple:
    """Sorted bucket sizes; each a perfect square (the 2-D attention views
    a bag as a sqrt(N) x sqrt(N) grid)."""
    out = tuple(sorted(int(b) for b in buckets))
    if not out:
        raise ValueError("buckets must be non-empty")
    for b in out:
        side = math.isqrt(b)
        if side * side != b:
            raise ValueError(
                f"bucket {b} must be a perfect square: the deformable 2D "
                "attention reshapes the bag onto a sqrt(N) x sqrt(N) grid")
    return out


class BucketedBagLoader:
    """Per-bucket batches of a dataset with ``bag_len(i)`` and
    ``batch(indices, pad_to=L)``.  In an epoch the samples are shuffled
    within their bucket and the batches with each other
    (``default_rng(seed * 100003 + epoch)``).  With ``drop_last`` a bucket
    that cannot fill a batch passes its samples to the next larger one, and
    the largest pads its short batch; without it each bucket's last batch is
    padded by repeating its last sample.  ``batch.pad`` counts the repeats
    and ``batch.indices`` holds the dataset rows."""

    def __init__(self, dataset, batch_size: int, buckets=DEFAULT_BUCKETS,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.buckets = validate_buckets(buckets)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self._assign = np.array([self.bucket_of(dataset.bag_len(i))
                                 for i in range(len(dataset))])

    def bucket_of(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]  # longer bags truncate (the fixdim rule)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        bs = self.batch_size
        total, carry = 0, 0
        for bi, b in enumerate(self.buckets):
            n = int((self._assign == b).sum()) + carry
            carry = 0
            if not self.drop_last:
                total += (n + bs - 1) // bs
            elif 0 < n < bs and bi + 1 < len(self.buckets):
                carry = n  # promoted to the next larger bucket
            elif 0 < n < bs:
                total += 1  # the largest bucket pads its short batch
            else:
                total += n // bs
        return total

    def plan(self) -> list:
        """This epoch's batches as ``(bucket, indices, pad)``."""
        rng = np.random.default_rng(self.seed * 100_003 + self._epoch)
        bs = self.batch_size
        plan = []
        carry = np.zeros(0, dtype=np.int64)
        for bi, b in enumerate(self.buckets):
            idx = np.concatenate([carry, np.nonzero(self._assign == b)[0]])
            carry = np.zeros(0, dtype=np.int64)
            if len(idx) == 0:
                continue
            if self.shuffle:
                rng.shuffle(idx)
            if self.drop_last and len(idx) < bs:
                if bi + 1 < len(self.buckets):
                    carry = idx
                    continue
                pad = bs - len(idx)
                plan.append((b, np.concatenate([idx, np.repeat(idx[-1], pad)]),
                             pad))
                continue
            stop = (len(idx) // bs) * bs if self.drop_last else len(idx)
            for start in range(0, stop, bs):
                sel = idx[start: start + bs]
                pad = bs - len(sel)
                if pad:
                    sel = np.concatenate([sel, np.repeat(sel[-1], pad)])
                plan.append((b, sel, pad))
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def __iter__(self):
        for b, sel, pad in self.plan():
            batch = self.dataset.batch(sel, pad_to=b)
            batch.pad = pad
            batch.indices = sel
            yield batch

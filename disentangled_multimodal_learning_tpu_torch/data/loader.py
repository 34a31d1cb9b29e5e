"""Batches of bags (counterpart of
``disentangled_multimodal_learning_tpu/data/loader.py``).

Training: ``shuffle=True, drop_last=True, seed=cfg.seed``, with
:meth:`BagLoader.set_epoch` before each epoch; the order of an epoch is
``default_rng(seed * 100003 + epoch)``'s shuffle, as in JAX, so both
frameworks see the same batches.

Evaluation (the defaults): sequential batches, and a short final batch is
PADDED to full size by repeating its last sample; ``batch.pad`` records how
many rows are duplicates and the evaluator strips them, so the metrics cover
exactly the dataset.  Every batch therefore has the same shape.

Every batch carries its dataset rows in ``batch.indices`` (JAX
``loader.py:62``), the keys of the distillation teacher-output cache.

:class:`PrefetchLoader` (JAX ``loader.py:67-132``) builds the batches of a
loader on a thread, ``depth`` ahead of the consumer.  Unlike JAX's, whose
producer loses an exception (its ``finally`` posts the end marker and the
epoch just ends early), it hands the exception to the consumer, which
raises it.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class BagLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (the reference's DistributedSampler)."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        n, bs = len(self.dataset), self.batch_size
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed * 100_003 + self._epoch).shuffle(
                order)
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            pad = bs - len(idx)
            if pad:
                idx = np.concatenate([idx, np.repeat(idx[-1], pad)])
            batch = self.dataset.batch(idx)
            batch.pad = pad
            batch.indices = idx  # stable per-sample keys
            yield batch


class PrefetchLoader:
    """``loader``'s batches built on a thread, at most ``depth`` ahead.  A
    consumer that stops early (closes the generator) stops and joins the
    thread; an exception raised while a batch is built is raised by the
    consumer."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer
                put(_Failed(e))
                return
            put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)


class _Failed:
    def __init__(self, error: Exception):
        self.error = error

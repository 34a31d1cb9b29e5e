"""Bags from ``.npy`` files (the numpy semantics of
``disentangled_multimodal_learning_tpu/data/native_io.py:86-125``): a bag is
read as f32 and zero-padded or truncated to ``fixdim`` rows.  JAX's
threaded C++ reader (``native/dmlt_io.cpp``), a host-speed path with the
same results, is not ported.
"""

from __future__ import annotations

import numpy as np


def read_bags(paths, out) -> None:
    """Bag ``i``'s first rows into ``out[i]`` (zeroed, ``[L, feat_dim]``
    f32), as many as it holds: each kept row copied once, the file mapped
    so that only those rows are read."""
    for bag, path in zip(out, paths):
        feats = np.load(path, mmap_mode="r")
        n = min(feats.shape[0], bag.shape[0])
        bag[:n] = feats[:n]


def load_bag_batch(paths, fixdim: int, feat_dim: int) -> np.ndarray:
    """Bags -> ``[len(paths), fixdim, feat_dim]`` f32."""
    out = np.zeros((len(paths), fixdim, feat_dim), dtype=np.float32)
    read_bags(paths, out)
    return out

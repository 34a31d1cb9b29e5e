"""Packed bag shards, ``.dmltpack``: a cohort's bags of one scale in one
memory-mapped file (counterpart of
``disentangled_multimodal_learning_tpu/data/packing.py``: the same format,
so that a pack written by either package reads bitwise the same in the
other; ``pack_bags`` :46, the reader of ``NumpyPackReader`` :102).

Format v1, little-endian::

    0   magic   "DMLTPCK1"
    8   u64     n_bags
    16  u64     feat_dim
    24  u64     index_off               (absolute)
    32  u64     names_off               (absolute)
    40  u64     payload_off             (absolute, informational)
    index_off: n_bags x 32-byte records
               {u64 name_off (into names blob), u64 name_len,
                u64 data_off (absolute), u64 rows}
    names_off: concatenated utf-8 names
    payload:   per-bag f32 [rows, feat_dim] blocks, 64-byte aligned

Pack a feature directory (``<dataDir>/<COHORT>/feats10/*.npy``) next to it
as the datasets look for it::

    python -m disentangled_multimodal_learning_tpu_torch.data.packing \\
        <dataDir>/<COHORT>/feats10 <dataDir>/<COHORT>/feats10.dmltpack

The reader maps the file once: the threaded C++ reader
(``data/native_io.py``, as JAX's ``PackFile`` uses it, ``packing.py:
148-155``), or ``np.memmap`` under ``DMLT_NO_NATIVE`` (the same bytes).
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from . import native_io

MAGIC = b"DMLTPCK1"
HEADER_FMT = "<8sQQQQQ"  # magic, n_bags, feat_dim, index_off, names_off, payload_off
HEADER_SIZE = struct.calcsize(HEADER_FMT)
INDEX_REC_FMT = "<QQQQ"  # name_off, name_len, data_off, rows
INDEX_REC_SIZE = struct.calcsize(INDEX_REC_FMT)
_ALIGN = 64


def _bag(path: str, mmap: bool = False) -> np.ndarray:
    arr = np.load(path, mmap_mode="r" if mmap else None)
    return arr[:, None] if arr.ndim == 1 else arr


def pack_bags(npy_dir: str, out_path: str, feat_dim: int | None = None) -> int:
    """Pack every ``<name>.npy`` bag under ``npy_dir`` into ``out_path``,
    unpadded (the true row counts serve bucketing), as f32; returns the
    number of bags.  The bags are read twice (shapes, then data), so only
    one is in memory at a time."""
    names = sorted(fn[:-4] for fn in os.listdir(npy_dir) if fn.endswith(".npy"))
    shapes = []
    for name in names:
        shape = _bag(os.path.join(npy_dir, f"{name}.npy"), mmap=True).shape
        if feat_dim is None:
            feat_dim = int(shape[1])
        elif int(shape[1]) != feat_dim:
            raise ValueError(f"{name}: feat_dim {shape[1]} != {feat_dim}")
        shapes.append(int(shape[0]))
    if feat_dim is None:
        raise ValueError(f"no .npy bags under {npy_dir}")

    blobs = [n.encode() for n in names]
    index_off = HEADER_SIZE
    names_off = index_off + INDEX_REC_SIZE * len(names)
    payload_off = names_off + sum(map(len, blobs))
    payload_off += (-payload_off) % _ALIGN
    data_offs, cursor = [], payload_off
    for rows in shapes:
        data_offs.append(cursor)
        nbytes = rows * feat_dim * 4
        cursor += nbytes + (-nbytes) % _ALIGN

    with open(out_path, "wb") as f:
        f.write(struct.pack(HEADER_FMT, MAGIC, len(names), feat_dim,
                            index_off, names_off, payload_off))
        noff = 0
        for blob, doff, rows in zip(blobs, data_offs, shapes):
            f.write(struct.pack(INDEX_REC_FMT, noff, len(blob), doff, rows))
            noff += len(blob)
        f.write(b"".join(blobs))
        for name, doff in zip(names, data_offs):
            f.write(b"\0" * (doff - f.tell()))
            f.write(np.ascontiguousarray(
                _bag(os.path.join(npy_dir, f"{name}.npy")),
                dtype=np.float32).tobytes())
    return len(names)


class PackFile:
    """A ``.dmltpack``: ``rows(name)`` (the true length, -1 when absent) and
    ``get`` / ``get_batch`` zero-padded or truncated to ``fixdim`` rows,
    read by the C++ reader (``native``) or through ``np.memmap``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header = f.read(HEADER_SIZE)
        magic, n_bags, feat_dim, index_off, names_off, _ = struct.unpack(
            HEADER_FMT, header)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a .dmltpack file")
        self.feat_dim = int(feat_dim)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        idx = np.frombuffer(
            self._mm[index_off:index_off + n_bags * INDEX_REC_SIZE],
            dtype=np.uint64).reshape(n_bags, 4)
        self.index: dict[str, tuple[int, int]] = {}
        for noff, nlen, doff, rows in idx:
            start = names_off + int(noff)
            name = bytes(self._mm[start:start + int(nlen)]).decode()
            self.index[name] = (int(doff), int(rows))
        self._handle = native_io.pack_open(path)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def close(self) -> None:
        if self._handle is not None:
            native_io.pack_close(self._handle)
            self._handle = None

    def rows(self, name: str) -> int:
        return self.index.get(name, (0, -1))[1]

    def get(self, name: str, fixdim: int, feat_dim: int) -> np.ndarray:
        return self.get_batch([name], fixdim, feat_dim)[0]

    def get_batch(self, names, fixdim: int, feat_dim: int) -> np.ndarray:
        out = np.zeros((len(names), fixdim, feat_dim), dtype=np.float32)
        self.read_bags(names, out)
        return out

    def read_bags(self, names, out) -> None:
        """Bag ``names[i]``'s first rows into ``out[i]`` (zeroed, ``[L,
        feat_dim]`` f32), as many as it holds, each copied once."""
        for bag, name in zip(out, names):
            if bag.shape[1] != self.feat_dim or name not in self.index:
                raise KeyError(name)
        if self._handle is not None:
            native_io.pack_read(self._handle, names, out)
            return
        native_io.reads["numpy"] += len(out)
        for bag, name in zip(out, names):
            doff, rows = self.index[name]
            n = min(rows, bag.shape[0])
            bag[:n] = np.frombuffer(
                self._mm[doff:doff + n * self.feat_dim * 4],
                dtype=np.float32).reshape(n, self.feat_dim)


if __name__ == "__main__":
    npy_dir, out_path = sys.argv[1:3]
    print(f"packed {pack_bags(npy_dir, out_path)} bags -> {out_path}")

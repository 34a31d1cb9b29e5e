"""The threaded C++ bag reader, bound with ``ctypes`` (counterpart of
``disentangled_multimodal_learning_tpu/data/native_io.py`` over its
``native/dmlt_io.cpp``; the port keeps its own copy of the source,
``csrc/dmlt_io.cpp``).

The library builds at first use with ``g++ -O3 -shared -fPIC -std=c++17
-lpthread`` into ``build/native/<source hash>/`` at the root of the
checkout (git-ignored, next to the CUDA kernels' build), atomically, so
processes that start together build it once each at worst.  A failed
build raises; ``DMLT_NO_NATIVE=1`` asks for numpy instead (JAX's opt-out;
JAX also falls back to numpy without a word when its build fails, the port
does not).

A bag is a ``.npy`` file ``[n, feat_dim]`` (f32, or f64 converted) or a
packed shard's entry, read into ``[L, feat_dim]`` f32 (its first ``L`` rows,
zeros past its end), as ``np.load`` gives it.  A file the C++ parser
refuses (another dtype, Fortran order, a feat_dim mismatch) is read with
numpy instead, as JAX reads it (``native_io.py:103-104``), with the same
result or numpy's error.  :data:`reads` counts the bags read each way, as
the kernel wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dmlt_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# bags read natively and with numpy since the last reset
reads = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_S = ctypes.c_char_p
_PS = ctypes.POINTER(ctypes.c_char_p)
# the C entry points called -> (argument types, return type)
SIGNATURES = {
    "dmlt_load_into": ((_PS, _P, _I64, _I64, _I64, _I, _P), _I),
    "dmlt_pack_open": ((_S,), _I64),
    "dmlt_pack_into": ((_I64, _PS, _P, _I64, _I64, _I64, _I, _P), _I),
    "dmlt_pack_close": ((_I64,), None),
}


def enabled() -> bool:
    """False where ``DMLT_NO_NATIVE`` asks for numpy."""
    return not os.environ.get("DMLT_NO_NATIVE")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdmlt_io.so"


def build() -> Path:
    """Compile the reader unless this exact build exists; its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"the native bag reader does not build: {e} "
                           "(DMLT_NO_NATIVE=1 reads with numpy)") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("the native bag reader does not build "
                           "(DMLT_NO_NATIVE=1 reads with numpy):\n"
                           + " ".join(cmd) + "\n" + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded reader (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(args), res
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether bags are read natively (the library built on the first
    call; a failed build raises)."""
    return enabled() and library() is not None


def _numpy_read(path: str, out: np.ndarray) -> None:
    feats = np.load(path, mmap_mode="r")
    n = min(feats.shape[0], out.shape[0])
    out[:] = 0
    out[:n] = feats[:n]


def _strings(names):
    return (ctypes.c_char_p * len(names))(*[str(n).encode() for n in names])


def _pointers(out):
    return (ctypes.c_void_p * len(out))(*[o.ctypes.data for o in out])


def _check_outputs(out) -> tuple[int, int]:
    """``(rows, feat_dim)`` shared by the blocks of ``out``, each a
    C-contiguous f32 ``[rows, feat_dim]`` array."""
    shapes = {o.shape for o in out}
    if len(shapes) != 1 or any(o.dtype != np.float32 or o.ndim != 2
                               or not o.flags.c_contiguous for o in out):
        raise ValueError("bags go into C-contiguous f32 [rows, feat_dim] "
                         "blocks of one shape")
    return shapes.pop()


def read_bags(paths, out, n_threads: int = 8) -> None:
    """Bag ``paths[i]`` (``.npy``) into ``out[i]`` (``[L, feat_dim]`` f32),
    its first ``L`` rows and zeros after them; natively on ``n_threads``
    threads, a file the parser refuses (and every file under
    ``DMLT_NO_NATIVE``) with numpy."""
    paths, out = [str(p) for p in paths], list(out)
    if not paths:
        return
    codes = np.ones(len(paths), np.int32)
    if enabled():
        rows, feat = _check_outputs(out)
        library().dmlt_load_into(_strings(paths), _pointers(out), len(paths),
                                 rows, feat, n_threads, codes.ctypes.data)
    for i in np.nonzero(codes)[0]:
        _numpy_read(paths[i], out[i])
    reads["native"] += int((codes == 0).sum())
    reads["numpy"] += int((codes != 0).sum())


def load_bag(path: str, fixdim: int, feat_dim: int) -> np.ndarray:
    """One bag, zero-padded or truncated to ``[fixdim, feat_dim]``."""
    out = np.zeros((fixdim, feat_dim), np.float32)
    read_bags([path], [out], n_threads=1)
    return out


def load_bag_batch(paths, fixdim: int, feat_dim: int,
                   n_threads: int = 8) -> np.ndarray:
    """Bags -> ``[len(paths), fixdim, feat_dim]`` f32, on threads."""
    out = np.zeros((len(paths), fixdim, feat_dim), np.float32)
    read_bags(paths, out, n_threads)
    return out


# ---- packed shards (.dmltpack; the format in data/packing.py) ----

def pack_open(path: str) -> int | None:
    """A handle on the shard mapped by the C++ reader; None under
    ``DMLT_NO_NATIVE`` or where it refuses the file."""
    if not enabled():
        return None
    h = library().dmlt_pack_open(str(path).encode())
    return int(h) if h >= 0 else None


def pack_read(handle: int, names, out, n_threads: int = 8) -> None:
    """Packed bags ``names[i]`` into ``out[i]`` (as :func:`read_bags`);
    raises ``KeyError`` for a name the shard lacks."""
    names, out = list(names), list(out)
    if not names:
        return
    rows, feat = _check_outputs(out)
    codes = np.ones(len(names), np.int32)
    library().dmlt_pack_into(handle, _strings(names), _pointers(out),
                             len(names), rows, feat, n_threads,
                             codes.ctypes.data)
    if codes.any():
        raise KeyError(names[int(np.nonzero(codes)[0][0])])
    reads["native"] += len(names)


def pack_close(handle: int) -> None:
    library().dmlt_pack_close(handle)

"""Build the port's CUDA kernels (``csrc/*.cu``) at first use and bind them.

Each source compiles with its own ``nvcc`` (all started together), and the
objects link into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library
lands in ``build/torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of the sources, the headers they share (``csrc/*.cuh``) and the
flags, so an edit to a kernel rebuilds it and an unchanged tree reuses the
last build.  Each C
entry point returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on anything but 0.

Nothing here runs at import, so the package imports (and its CPU paths run)
where there is no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libdmlt_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them); each returns an int
SIGNATURES = {
    "dmlt_cpb_table_interp_fwd": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    "dmlt_cpb_table_interp_fwd_blocks": (_I, _I, _I),
    "dmlt_cpb_table_interp_bwd": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P),
    "dmlt_cpb_table_strided_fwd": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                                   _P, _P),
    "dmlt_cpb_table_strided_fwd_scratch": (_I, _I, _I),
    "dmlt_cpb_table_strided_fwd_blocks": (_I, _I),
    "dmlt_cpb_table_strided_bwd": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dmlt_fused_table_fwd": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _P, _I, _F, _P),
    "dmlt_fused_table_fwd_smem": (_I, _I, _I, _I),
    "dmlt_fused_table_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _P, _I, _F, _P),
    "dmlt_fused_table_bwd_smem": (_I, _I),
    "dmlt_cpb_exact_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _P),
    "dmlt_cpb_exact_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _P),
    "dmlt_cpb_exact_fwd_smem": (_I, _I),
    "dmlt_cpb_exact_bwd_smem": (_I,),
    "dmlt_fused_exact_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "dmlt_fused_exact_fwd_smem": (_I, _I),
    "dmlt_fused_exact_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _P),
    "dmlt_fused_exact_bwd_smem": (_I, _I),
    "dmlt_cpb_table_1d_fwd": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    "dmlt_cpb_table_1d_bwd": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _P),
    "dmlt_cpb_table_1d_bwd_blocks": (_I,),
    "dmlt_dpc_knn": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "dmlt_dpc_parent": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "dmlt_dpc_smem_bytes": (_I,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the CUDA toolkit is")


def library_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return the
    library path.  One ``nvcc -c`` per source, all running at once, then one
    link.  The ptxas report (registers, shared memory, spills) is kept
    beside the library as ``build.log``."""
    out_dir = library_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    compiles = []
    for src in sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp_dir / f"{src.stem}.o"),
               str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp_dir / LIB_NAME),
                *(str(tmp_dir / f"{src.stem}.o") for src in sources())]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    (out_dir / "build.log").write_text("".join(log))
    if failed:
        shutil.rmtree(tmp_dir)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    # atomic: a concurrent loader sees all or nothing
    os.replace(tmp_dir / LIB_NAME, lib)
    shutil.rmtree(tmp_dir)
    return lib


def build_log() -> str:
    log = library_dir() / "build.log"
    return log.read_text() if log.is_file() else ""


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.dmlt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dmlt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = kernels().dmlt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")

"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, is cached by a hash of the sources and flags under
``build/kernels/`` at the repository root, and never at import time (CPU-only
installs import every module of the package).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, so a refused launch (too much shared
memory, bad grid) never passes silently.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# plain integer launch counters, one per kernel wrapper: a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict = {}
_LOCK = threading.Lock()
LAST_BUILD_LOG: dict = {}


def reset_launches() -> None:
    for k in list(LAUNCHES):
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _start(name: str):
    """(output path, temp path, running nvcc), nvcc None when cached."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}_{_digest(src)}.so"
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, tmp: Path, proc) -> ctypes.CDLL:
    if proc is not None:
        log, _ = proc.communicate()
        LAST_BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (cached) and return the loaded library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        return _finish(name, *_start(name))


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t, name: str, dtypes, ndim: int):
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def build_all() -> list:
    """Build every kernel library of the package, one ``nvcc`` per source,
    all started together; returns their names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        try:
            for n, job in jobs.items():
                _finish(n, *job)
        finally:  # a failed build leaves no compiler running
            for *_, proc in jobs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return names

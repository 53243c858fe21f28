"""ctypes bridge to the native batch-assembly library (csrc/batchops.cpp).

The port's own copy of ``sceneverse_tpu/data/native.py``, with two
differences:

  * the library is compiled with g++ on first use from the port's own copy
    of the C++ source, ``sceneverse_tpu_torch/csrc/batchops.cpp``, into
    ``build/native/libbatchops-<source hash>.so`` (``build/`` is
    git-ignored);
  * a library that cannot be built raises ``RuntimeError`` with the
    compiler's message. The JAX package falls back to the numpy path there,
    which draws from another RNG stream; here ``data.args.native_loader``
    means the native path or an error.

The numpy path in ScanBase stays the RNG-parity reference; this path is the
throughput option for production input pipelines (enable with
``data.args.native_loader: true``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "batchops.cpp"
BUILD_DIR = REPO / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_ERROR = None


def _build() -> Path:
    """The library for the current source and flags: reused when built,
    else compiled to a temporary name and renamed into place (concurrent
    loader workers may build at once)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libbatchops-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".tmp-{os.getpid()}-{out.name}"
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library; raises ``RuntimeError`` when it cannot be built
    (the first failure is kept and raised again)."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        path = _build()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        _ERROR = f"native batchops library unavailable: {e}"
        raise RuntimeError(_ERROR) from e
    lib = ctypes.CDLL(str(path))
    lib.obj_processing_post.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # pts
        ctypes.POINTER(ctypes.c_int64),   # offsets
        ctypes.c_int64,                   # n_obj
        ctypes.c_int64,                   # C
        ctypes.c_int64,                   # num_points
        ctypes.POINTER(ctypes.c_float),   # rot (or None)
        ctypes.c_uint64,                  # seed
        ctypes.POINTER(ctypes.c_float),   # out_fts
        ctypes.POINTER(ctypes.c_float),   # out_locs
        ctypes.POINTER(ctypes.c_float),   # out_boxes
    ]
    lib.obj_processing_post.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.assemble_objects.argtypes = [
        fp,                 # pts store
        i64p, i64p, i64p,   # off, cnt, slots
        ctypes.c_int64,     # n_sel
        ctypes.c_int64,     # C
        ctypes.c_int64,     # num_points
        fp,                 # rots (n_sel, 9) or None
        ctypes.c_uint64,    # seed
        ctypes.c_int64,     # n_threads
        fp, fp, fp,         # out_fts, out_locs, out_boxes
    ]
    lib.assemble_objects.restype = None
    lib.sample_objects.argtypes = [
        fp, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        fp, ctypes.c_uint64, ctypes.c_int64, fp,
    ]
    lib.sample_objects.restype = None
    _LIB = lib
    return _LIB


def sample_objects_native(pts, off, cnt, slots, num_points, out_fts,
                          rots=None, seed=0, n_threads=1):
    """assemble_objects_native minus the full-cloud stats pass — locs/boxes
    come from offline per-object stats (data/materialized.py fast path)."""
    lib = get_lib()
    fp = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    assert pts.dtype == np.float32 and pts.flags.c_contiguous
    assert out_fts.dtype == np.float32 and out_fts.flags.c_contiguous
    off = np.ascontiguousarray(off, np.int64)
    cnt = np.ascontiguousarray(cnt, np.int64)
    slots = np.ascontiguousarray(slots, np.int64)
    rot_ptr = None
    if rots is not None:
        rots = np.ascontiguousarray(rots, np.float32)
        assert rots.shape == (len(off), 9)
        rot_ptr = rots.ctypes.data_as(fp)
    lib.sample_objects(
        pts.ctypes.data_as(fp),
        off.ctypes.data_as(i64p), cnt.ctypes.data_as(i64p),
        slots.ctypes.data_as(i64p), len(off), pts.shape[1], num_points,
        rot_ptr, int(seed), int(n_threads),
        out_fts.ctypes.data_as(fp),
    )


def assemble_objects_native(pts, off, cnt, slots, num_points, out_fts,
                            out_locs, out_boxes, rots=None, seed=0,
                            n_threads=1):
    """Scatter-assemble selected ragged objects from a flat (N, C) float32
    point store directly into preallocated batch buffers (the materialized
    input pipeline's hot op — see data/materialized.py). ``off``/``cnt`` are
    per-object start row / row count, ``slots`` the destination rows in
    ``out_fts`` (n_slots, P, C); untouched slots keep their prefill padding.
    """
    lib = get_lib()
    fp = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    assert pts.dtype == np.float32 and pts.flags.c_contiguous
    assert out_fts.dtype == np.float32 and out_fts.flags.c_contiguous
    off = np.ascontiguousarray(off, np.int64)
    cnt = np.ascontiguousarray(cnt, np.int64)
    slots = np.ascontiguousarray(slots, np.int64)
    rot_ptr = None
    if rots is not None:
        rots = np.ascontiguousarray(rots, np.float32)
        assert rots.shape == (len(off), 9)
        rot_ptr = rots.ctypes.data_as(fp)
    lib.assemble_objects(
        pts.ctypes.data_as(fp),
        off.ctypes.data_as(i64p), cnt.ctypes.data_as(i64p),
        slots.ctypes.data_as(i64p), len(off), pts.shape[1], num_points,
        rot_ptr, int(seed), int(n_threads),
        out_fts.ctypes.data_as(fp),
        out_locs.ctypes.data_as(fp),
        out_boxes.ctypes.data_as(fp),
    )


def obj_processing_post_native(obj_pcds, num_points, rot=None, seed=0):
    """Native equivalent of ScanBase._obj_processing_post for a ragged list of
    (n_i, C) float32 objects. Returns (fts (O,P,C), locs (O,6), boxes (O,6)).
    Raises RuntimeError if the library is unavailable.
    """
    lib = get_lib()
    arrs = [np.ascontiguousarray(p, np.float32) for p in obj_pcds]
    C = arrs[0].shape[1]
    pts = np.concatenate(arrs, axis=0)
    offsets = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([a.shape[0] for a in arrs], out=offsets[1:])
    n_obj = len(arrs)
    out_fts = np.empty((n_obj, num_points, C), np.float32)
    out_locs = np.empty((n_obj, 6), np.float32)
    out_boxes = np.empty((n_obj, 6), np.float32)
    rot_arr = None
    rot_ptr = None
    if rot is not None:
        rot_arr = np.ascontiguousarray(rot, np.float32)
        rot_ptr = rot_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.obj_processing_post(
        pts.ctypes.data_as(fp),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_obj, C, num_points, rot_ptr, seed,
        out_fts.ctypes.data_as(fp),
        out_locs.ctypes.data_as(fp),
        out_boxes.ctypes.data_as(fp),
    )
    return out_fts, out_locs, out_boxes

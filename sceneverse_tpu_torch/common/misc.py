"""Misc helpers (the port's copy of ``sceneverse_tpu/common/misc.py``;
reference common/misc.py): dotted getattr, directory creation and the
cross-rank sum of (value, count) metric dicts over ``torch.distributed``."""

from __future__ import annotations

import functools
import os

import numpy as np

from sceneverse_tpu_torch.parallel import mesh


def rgetattr(obj, path, default=None):
    """Recursive getattr with dotted paths (reference common/misc.py)."""
    try:
        return functools.reduce(getattr, path.split("."), obj)
    except AttributeError:
        return default


def make_dir(path):
    os.makedirs(path, exist_ok=True)


def gather_dict(metrics: dict) -> dict:
    """Sum each entry of a metric dict (a value or a (value, count) pair)
    over the ranks, as float64 arrays (one process: returned as it is)."""
    if mesh.dp_world() == 1:
        return metrics
    keys = sorted(metrics)
    arrs = [np.asarray(metrics[k], np.float64) for k in keys]
    flat = mesh.all_reduce_host(np.concatenate([a.reshape(-1) for a in arrs]))
    out, off = {}, 0
    for k, a in zip(keys, arrs):
        out[k] = flat[off:off + a.size].reshape(a.shape)
        off += a.size
    return out

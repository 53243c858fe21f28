"""Trainer checkpoints in the port's own format (the counterpart of
sceneverse_tpu/ckpt/checkpoint.py, which writes orbax directories).

A checkpoint is one ``torch.save`` file: the model's state dict under
``"model"`` (so ``ckpt/convert.py::load_torch_pretrain`` reads it), the
optimizer's state, the tracker and the step counter; every entry is a
tensor or a plain Python value, so it loads with ``weights_only=True``.

Saves are asynchronous, as orbax's are: ``save_checkpoint`` copies every
tensor to host memory before it returns (later steps update the parameters
in place and cannot clobber the copy), then a background thread writes the
file under a temporary name and ``os.replace``s it into place, the analog
of orbax's finalising rename. A new save first drains the one in flight;
loads, ``latest_checkpoint`` and process exit drain too. A failed write is
raised by the next drain, never dropped. Over a data-parallel world only
rank 0 writes (the ranks hold the same state).
"""

from __future__ import annotations

import atexit
import os
import threading
import zipfile
from pathlib import Path

import torch

from sceneverse_tpu_torch.parallel import mesh

TMP_SUFFIX = ".tmp"

_PENDING: threading.Thread | None = None
_ERROR: list = []
_LOCK = threading.Lock()


def wait_for_checkpoints() -> None:
    """Block until the save in flight is on disk; raise its error if the
    write failed."""
    global _PENDING
    with _LOCK:
        if _PENDING is not None:
            _PENDING.join()
            _PENDING = None
        if _ERROR:
            err = _ERROR.pop()
            raise RuntimeError("checkpoint write failed") from err


atexit.register(wait_for_checkpoints)


def to_host(obj):
    """A copy of ``obj`` with every tensor detached and on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _write(state: dict, path: Path) -> None:
    tmp = path.with_name(path.name + TMP_SUFFIX)
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    except BaseException as e:  # handed to the next drain, which raises it
        _ERROR.append(e)
        tmp.unlink(missing_ok=True)


def save_checkpoint(path, state: dict, block: bool = False) -> None:
    """Copy ``state`` to host memory now and write it to ``path`` in the
    background (``block`` waits for the write); on rank 0 only."""
    global _PENDING
    if mesh.rank() != 0:
        return
    wait_for_checkpoints()
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    host = to_host(state)  # a blocking copy: done when this returns
    thread = threading.Thread(target=_write, args=(host, path),
                              name=f"save {path.name}")
    with _LOCK:
        _PENDING = thread
        thread.start()
    if block:
        wait_for_checkpoints()


def load_checkpoint(path, map_location="cpu") -> dict:
    wait_for_checkpoints()
    return torch.load(Path(path), map_location=map_location,
                      weights_only=True)


def is_checkpoint(path) -> bool:
    """A finished checkpoint file (a temporary of a write in flight or of
    one that died does not count)."""
    path = Path(path)
    return (path.is_file() and not path.name.endswith(TMP_SUFFIX)
            and zipfile.is_zipfile(path))


def latest_checkpoint(ckpt_dir) -> Path | None:
    """The most recently finished checkpoint under ``ckpt_dir``."""
    wait_for_checkpoints()
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    candidates = [p for p in ckpt_dir.iterdir() if is_checkpoint(p)]
    return max(candidates, key=os.path.getmtime) if candidates else None

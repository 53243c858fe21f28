"""Processor base (reference preprocess/build.py:7-50), the port's own copy
of ``sceneverse_tpu/preprocess/build.py``: output directory layout,
config-gated outputs, and the device and random state a processor runs
with."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from sceneverse_tpu_torch.registry import Registry

PROCESSOR_REGISTRY = Registry("Processor")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (the per-vertex passes never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the preprocessing runs on CUDA unless asked for the CPU "
            "(device=cpu), and torch.cuda.is_available() is False")
    return device


class ProcessorBase:
    """``cfg.device`` (default ``cuda``) holds the per-vertex passes;
    ``cfg.seed`` seeds ``self.rng``, the processor's own
    ``np.random.RandomState`` (the 240K point cap draws from it).
    ``self.device_seconds`` sums the host-clock time of the passes on the
    device (``device_pass``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = resolve_device(cfg.get("device", "cuda"))
        self.rng = np.random.RandomState(cfg.get("seed"))
        self.device_seconds = 0.0
        self.data_root = Path(cfg.data_root)
        save_root = cfg.get("save_root")
        self.save_root = Path(save_root) if save_root else self.data_root.parent / "scan_data"
        self.num_workers = cfg.get("num_workers", 1)
        self.inst2label_path = self.save_root / "scan_data" / "instance_id_to_label"
        self.pcd_path = self.save_root / "scan_data" / "pcd_with_global_alignment"
        self.segm_path = self.save_root / "scan_data" / "segm"
        self.obj_path = self.save_root / "scan_data" / "obj"
        self.sp_path = self.save_root / "scan_data" / "super_points"
        self.output = cfg.output
        self.setup_directories()

    @contextlib.contextmanager
    def device_pass(self):
        """Adds the block's time to ``device_seconds``, the device
        synchronised at its end."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.device_seconds += time.perf_counter() - t0

    def setup_directories(self):
        if self.check_key(self.output.get("pcd")):
            self.inst2label_path.mkdir(parents=True, exist_ok=True)
            self.pcd_path.mkdir(parents=True, exist_ok=True)

    def log_starting_info(self, scan_len, e=""):
        print("=" * 50)
        print(f"Preprocessing in {type(self).__name__} with {scan_len} scans")
        kinds = [str(k) for k, v in self.output.items() if self.check_key(v)]
        assert kinds, "Please specify at least one output type"
        print(f"Output: {', '.join(kinds)}")
        if e:
            print(e)
        print("=" * 50)

    @staticmethod
    def check_key(key):
        if key is None:
            return False
        if isinstance(key, bool):
            return key
        if isinstance(key, dict):
            return key.get("enabled", True)
        return True

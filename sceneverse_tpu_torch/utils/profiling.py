"""Profiling and debugging switches (port of sceneverse_tpu/utils/profiling.py).

  * ``profile.enabled``: ``trace`` records the first ``profile.steps`` train
    steps of epoch 0 with ``torch.profiler`` (host, and the card when there
    is one) and writes a Chrome trace under ``<exp_dir>/profile``;
  * ``debug.nans``: fail fast on a non-finite value. JAX's
    ``jax_debug_nans`` checks forward and backward values; here autograd's
    anomaly detection checks the backward, and ``install_nan_checks`` adds a
    forward hook to every module of the model that raises on a non-finite
    floating output. The hooks read every output on the host (a sync per
    module), so they exist only while the switch is on;
  * ``StepTimer``: host-clock step times that end in a device synchronise.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True):
    """``torch.profiler`` over the block, written to
    ``<log_dir>/trace_<pid>_<time>.json``; no-op when disabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _non_finite(out) -> bool:
    if torch.is_tensor(out):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, dict):
        return any(_non_finite(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_non_finite(v) for v in out)
    return False


def install_nan_checks(model: torch.nn.Module) -> list:
    """A forward hook on every module of ``model`` that raises
    ``FloatingPointError`` naming the first module whose output holds a NaN
    or an infinity; returns the hook handles."""

    def hook(name):
        def check(module, args, out):
            if _non_finite(out):
                raise FloatingPointError(
                    f"debug.nans: non-finite value in the output of "
                    f"{name or type(module).__name__}")
        return check

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]


def enable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(True)


class StepTimer:
    """Wall-clock step timing that waits for the card's queued work."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self, device=None):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean_ms(self):
        return 1000.0 * self.total / max(self.count, 1)


def setup_from_config(cfg):
    """Apply the profile / debug switches (once, at trainer init); returns
    (profile enabled, profile steps)."""
    if cfg.select("debug.nans", False):
        enable_nan_debugging()
    return bool(cfg.select("profile.enabled", False)), int(
        cfg.select("profile.steps", 10) or 10)

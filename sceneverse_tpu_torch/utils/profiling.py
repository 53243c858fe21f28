"""Profiling and debugging switches (port of sceneverse_tpu/utils/profiling.py).

  * ``profile.enabled``: ``trace`` records the first ``profile.steps`` train
    steps of epoch 0 with ``torch.profiler`` (host, and the card when there
    is one) and writes a Chrome trace under ``<exp_dir>/profile``, its
    kernel events checked against the kernel launches the port counted in
    the window;
  * ``debug.nans``: fail fast on a non-finite value. JAX's
    ``jax_debug_nans`` checks forward and backward values; here autograd's
    anomaly detection checks the backward, and ``install_nan_checks`` adds a
    forward hook to every module of the model that raises on a non-finite
    floating output. The hooks read every output on the host (a sync per
    module), so they exist only while the switch is on;
  * ``StepTimer``: host-clock step times that end in a device synchronise.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from pathlib import Path

import torch


# the port's kernels a written trace is checked for: kernel name -> {the
# wrapper that launches it (an ``ops/_build.LAUNCHES`` key): kernel launches
# one wrapper launch makes}. The sa_train wrappers share their kernels in
# numbers that vary with the level and are not checked.
PROFILE_KERNELS = {
    "sv_fps_kernel": {"fps": 1},
    "sv_sa_fwd_kernel": {"sa_group_mlp_pool": 1, "sa_dense_pool": 1},
    "sv_ball_group_kernel": {"ball_group": 1},
    "sv_mha_fwd_kernel": {"mha_fwd": 1},
    "sv_mha_bwd_": {"mha_bwd": 2},  # the dq and the dk/dv kernel
    "fa_fwd_kernel": {"flash_fwd": 1},
    "fa_dq_kernel": {"flash_bwd": 1},
    "fa_dkv_kernel": {"flash_bwd": 1},
}


class TraceWindow:
    """What ``trace`` wrote: the file, the launches each of the port's
    wrappers counted in the window, and the kernel events in the trace, all
    of them (``kernels``) and those of each of PROFILE_KERNELS
    (``traced``); both None without a card."""

    def __init__(self):
        self.path, self.kernels, self.traced = None, None, None
        self.launches = collections.Counter()

    @property
    def expected(self) -> dict:
        """Kernel name -> the events the window's launches should leave."""
        return {k: sum(self.launches[w] * n for w, n in per.items())
                for k, per in PROFILE_KERNELS.items()}

    @property
    def missing(self) -> dict:
        """Kernel name -> (traced, launched) where the trace holds fewer
        events than the port launched: torch.profiler lost part of the
        window's device activity."""
        if self.traced is None:
            return {}
        return {k: (self.traced[k], n) for k, n in self.expected.items()
                if self.traced[k] < n}

    @property
    def complete(self) -> bool:
        return not self.missing


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True):
    """``torch.profiler`` over the block, written to
    ``<log_dir>/trace_<pid>_<time>.json``; yields a ``TraceWindow`` (None
    when disabled). The window opens and closes on an idle card, so it
    holds the block's device work and no other (a graph replay queued by
    the block's last step included). The written trace is checked: each
    kernel of PROFILE_KERNELS is counted in it and printed beside the
    launches that the port's wrappers and graph replays counted in the
    window (``ops/_build.LAUNCHES``); ``TraceWindow.complete`` is false
    where the trace holds fewer, which torch.profiler does late in a
    process in which trainers have come and gone (the caller traces
    again)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from sceneverse_tpu_torch.ops import _build

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    window = TraceWindow()
    before = _build.LAUNCHES.copy()
    with profile(activities=activities) as prof:
        yield window
        if cuda:
            torch.cuda.synchronize()
    window.launches = _build.LAUNCHES - before
    window.path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(window.path))
    if not cuda:
        return
    with open(window.path) as f:
        names = [e.get("name", "") for e in json.load(f).get("traceEvents", ())
                 if e.get("cat") == "kernel"]
    window.kernels = len(names)
    window.traced = {k: sum(k in n for n in names) for k in PROFILE_KERNELS}
    counts = {k: f"{window.traced[k]}/{n}"
              for k, n in window.expected.items() if n or window.traced[k]}
    print(f"[profile] {window.path.name}: {window.kernels} kernel events; "
          f"the port's kernels traced/launched {counts}"
          f"{'' if window.complete else ' (INCOMPLETE)'}", flush=True)


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

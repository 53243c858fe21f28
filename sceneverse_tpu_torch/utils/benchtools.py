"""What the port's measuring tools (``bench_*_torch.py``) share: the
device, the card's record in every output line, the clocks and the line
itself.

  * ``resolve_device``: the card unless ``--device cpu``; with no card the
    tools raise, they never fall back to the CPU;
  * ``device_record``: ``nvidia-smi``'s name, power limit and NVIDIA driver, and
    torch's and CUDA's versions (on the CPU only torch's);
  * ``blocks_ms``: device time on CUDA events, warm-up first, then R blocks
    of N calls, each block's time over N; on the CPU the host clock, and
    the record's ``clock`` says which;
  * ``StepTimer``: the same clock around each call of a method (a trainer's
    step) while it runs in its own loop;
  * ``emit``: one JSON line per measurement, with the device record.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import time

import torch


def resolve_device(name: str | None) -> torch.device:
    """``cpu`` when asked for, else a CUDA card or ``RuntimeError``."""
    if name == "cpu":
        return torch.device("cpu")
    dev = torch.device(name or "cuda")
    if dev.type != "cuda":
        raise ValueError(f"--device is cpu or a CUDA device, not {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this tool measures the CUDA card unless given --device cpu, and "
            "torch.cuda.is_available() is False")
    return dev


@functools.lru_cache(maxsize=None)
def _smi() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power, driver = (x.strip() for x in out.split(","))
    return {"name": name, "power_limit": power, "driver": driver}


def device_record(device: torch.device) -> dict:
    rec = {"platform": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        rec.update(_smi(), cuda=torch.version.cuda, clock="cuda_events")
    else:
        rec["clock"] = "host"
    return rec


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Start / stop marks on the device's stream (CUDA events) or the host
    clock on the CPU; ``ms`` synchronises."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.b.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (self.t1 - self.t0) * 1e3


def blocks_ms(fn, device: torch.device, n: int = 1, reps: int = 3,
              warmup: int = 1) -> list:
    """Milliseconds per call of ``fn()``: ``warmup`` untimed calls, then
    ``reps`` blocks of ``n`` calls, each block's time over ``n``."""
    for _ in range(warmup):
        fn()
    sync(device)
    out = []
    for _ in range(reps):
        clock = Clock(device)
        clock.start()
        for _ in range(n):
            fn()
        clock.stop()
        out.append(clock.ms() / n)
    return out


def spread(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


class StepTimer:
    """Times each call of ``obj.<name>`` on the device's clock while it
    runs, by wrapping the bound method on the instance; the marks are read
    after the loop (one synchronise), so the loop runs as it would."""

    def __init__(self, obj, name: str, device: torch.device):
        self.obj, self.name, self.device = obj, name, device
        self.clocks = []

    @contextlib.contextmanager
    def running(self):
        inner = getattr(self.obj, self.name)

        def timed(*a, **k):
            clock = Clock(self.device)
            clock.start()
            out = inner(*a, **k)
            clock.stop()
            self.clocks.append(clock)
            return out

        setattr(self.obj, self.name, timed)
        try:
            yield self
        finally:
            delattr(self.obj, self.name)

    def ms(self) -> list:
        return [c.ms() for c in self.clocks]


def launches() -> dict:
    """The port's kernel launch counts so far (0 on the CPU, where each
    wrapper runs its plain twin)."""
    from sceneverse_tpu_torch.ops import _build

    return {k: v for k, v in _build.LAUNCHES.items() if v}


def emit(record: dict, device: torch.device) -> None:
    print(json.dumps({**record, "device": device_record(device)}),
          flush=True)

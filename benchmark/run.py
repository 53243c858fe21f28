#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``sceneverse_tpu_torch``)
beside this folder, on a machine with the CUDA cards the cell asks for.

The cell's traffic names its mode (``modes/<mode>.py``), which drives the
program and checks it. A run: set-up (the program's kernels built or
loaded, the configuration's trainer, weights and a pool of batches drawn
from the seed, the mode's set-up dispatches, which the output check reads
and which build every graph the window replays); a window of ``--seconds``
of the trainer's own loop fed from the pool; with ``--trace 1`` then a
window of a few dispatches under torch.profiler, traced again until it
holds every kernel the program launched, whose per-layer metrics the
readers in ``metrics/`` take; then, with the program's state freed, the
check against the configuration's plain reference. A cell of more than one
chip starts one process a card (ranks of one process group) and checks
their snapshots here. The last line of standard output is the result, as
JSON; the numbers the check compared, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BUILD = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "sceneverse_tpu")
TRACE_TRIES = 3
TRACE_DISPATCHES = 3


def _boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float:
    """This process's start on the boot clock (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return start / os.sysconf("SC_CLK_TCK")


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library loads JAX on its own."""
    cache = BUILD / "cache"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one rank of a cell of several chips, started by this program
    for name in ("--rank", "--port"):
        p.add_argument(name, type=int, default=None, help=argparse.SUPPRESS)
    for name in ("--t0",):
        p.add_argument(name, type=float, default=None, help=argparse.SUPPRESS)
    # the tests' hooks, "module:function" names
    for name in ("--device", "--out", "--overrides", "--fault", "--bench"):
        p.add_argument(name, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _hook(name):
    if not name:
        return None
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


class Ctx:
    """What a mode gets: the cell, the seed, this rank's device and rows,
    the world, and the world's agreement (``stop``, ``all``)."""

    def __init__(self, cell, seed, device, rank=0, world=1, fault=None):
        import torch

        self.cell, self.seed, self.device = cell, seed, device
        self.rank, self.world, self.fault = rank, world, fault
        self.build = BUILD
        self.cuda = str(device).startswith("cuda")
        self.sync = ((lambda: torch.cuda.synchronize(device)) if self.cuda
                     else (lambda: None))
        b = int(cell.traffic["batch"]) // world
        self.rows = None if world == 1 else slice(rank * b, (rank + 1) * b)
        self.group = None
        if world > 1:
            import torch.distributed as dist
            self.group = dist.new_group(backend="gloo")

    def _reduce(self, flag, op):
        if self.group is None:
            return bool(flag)
        import torch
        import torch.distributed as dist
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=op, group=self.group)
        return bool(t.item())

    def stop(self, passed):
        """Whether any rank's deadline has passed."""
        import torch.distributed as dist
        return self._reduce(passed, getattr(dist.ReduceOp, "MAX", None))

    def all(self, flag):
        """Whether every rank's ``flag`` holds."""
        import torch.distributed as dist
        return self._reduce(flag, getattr(dist.ReduceOp, "MIN", None))


def rank_run(args, cell, device, t_start, rank=0, world=1, fault=None):
    """One rank's run of the program: set-up, window, trace; returns its
    part of the result, its snapshot for the check, and the modules of the
    forbidden packages loaded here, with the program's state freed."""
    import torch

    ctx = Ctx(cell, args.seed, device, rank, world, fault)
    phases = {"start": _boottime() - t_start}
    t = [_boottime()]

    def mark(name):
        now = _boottime()
        phases[name] = now - t[0]
        t[0] = now

    if ctx.cuda:
        torch.cuda.set_device(device)
        from sceneverse_tpu_torch.ops import _build
        _build.build_all()
    mark("kernel_build")
    mode = cell.mode.Mode(ctx)
    mode.setup(mark)
    setup_s = _boottime() - t_start
    _log(f"[setup] rank {rank} " + " ".join(
        f"{k}={v:.3f}s" for k, v in phases.items()) + f" total={setup_s:.3f}s")

    t0 = time.perf_counter()
    served, failed, dispatch_s = mode.window(args.seconds, t0)
    window_s = time.perf_counter() - t0
    part = {"setup_s": setup_s, "steps": len(served), "window_s": window_s,
            "failed": failed,
            "peak": torch.cuda.max_memory_allocated(device) if ctx.cuda else 0}
    if args.trace:
        part.update(traced(ctx, mode, served, window_s, dispatch_s))
    part["forbidden"] = _forbidden()
    part["snapshot"] = mode.snapshot()
    mode.close()
    del mode
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    return part


def traced(ctx, mode, served, window_s, dispatch_s):
    """The per-layer metrics (this rank's; rank 0's are reported): the
    untraced window's host timings and rates, and a window of
    ``TRACE_DISPATCHES`` dispatches under torch.profiler, traced again until
    it holds every kernel the program launched on every rank."""
    from benchmark.harness.trace import Trace
    from sceneverse_tpu_torch.utils.profiling import trace

    cell, work = ctx.cell, {}

    def work_of(j):
        if j not in work:
            b = mode.pool[j]
            if ctx.rows is not None:
                b = {k: v[ctx.rows] for k, v in b.items()}
            work[j] = cell.work.work(b, cell.config, cell.mode.TRAIN,
                                     ctx.device)
        return work[j]

    tdir = BUILD / "trace" / f"rank{ctx.rank}"
    for attempt in range(TRACE_TRIES):
        with trace(tdir) as window:
            tserved = mode.traced(TRACE_DISPATCHES)
        if ctx.all(window.complete):
            break
        os.remove(window.path)
        _log(f"[trace] rank {ctx.rank} window {attempt + 1} incomplete: "
             f"{window.missing}")
    else:
        raise SystemExit(f"{TRACE_TRIES} profiler windows in a row traced "
                         "fewer kernels than the program launched")
    tr = Trace(window.path) if ctx.cuda else None
    os.remove(window.path)
    rctx = {"trace": tr, "traced_steps": len(tserved),
            "traced_work": [work_of(j) for j in tserved],
            "window_steps": len(served), "window_s": window_s,
            "window_work": [(work_of(j), served.count(j))
                            for j in sorted(set(served))],
            "dispatch_s": list(dispatch_s), "K": mode.K}
    metrics = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"])(rctx)
        if value is not None:
            metrics[m["name"]] = (value, m["unit"])
    out = {"per_layer": metrics,
           "busy_s": tr.busy_s() if tr else 0.0,
           "trace_window_s": tr.window_s if tr else 0.0}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, cell, device, t_start):
    """The ranks of a cell of ``cell.chips`` chips, one process each, this
    program again with ``--rank``; waits for every one and returns their
    parts in rank order."""
    import torch

    world, port = cell.chips, _free_port()
    out = BUILD / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for r in range(world):
        argv = [sys.executable, str(Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--rank", str(r), "--port", str(port), "--t0", repr(t_start),
                "--out", str(out / f"rank{r}.pt")]
        for name in ("overrides", "fault", "bench"):
            if getattr(args, name):
                argv += [f"--{name}", str(getattr(args, name))]
        if device == "cpu":
            argv += ["--device", "cpu"]
        env = dict(os.environ, LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(argv, env=env))
    # a rank that fails leaves the others waiting in a collective: end them
    while any(p.poll() is None for p in procs):
        if any(p.poll() for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.2)
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"ranks exited with {codes}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_main(args) -> int:
    """A rank of a cell of several chips: joins the process group, runs,
    and writes its part to ``--out``."""
    import torch
    import torch.distributed as dist

    from benchmark.harness import spec
    cell = spec.Cell(spec.load_bench(args.bench or ROOT / "BENCHMARK.json"),
                     args.workload)
    if args.overrides:
        _hook(args.overrides)(cell)
    cpu = args.device == "cpu"
    device = "cpu" if cpu else f"cuda:{args.rank}"
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{args.port}",
                            rank=args.rank, world_size=cell.chips)
    try:
        part = rank_run(args, cell, device, args.t0, args.rank, cell.chips,
                        _hook(args.fault))
    finally:
        dist.destroy_process_group()
    torch.save(part, args.out)
    return 0


def run(args, device=None, bench_path=None, fault=None, overrides=None):
    """One run of a cell; returns the result dict. ``device`` "cpu" (tests)
    skips the look for a card; ``fault`` plants a fault in the program
    (tests); ``overrides`` replaces parts of the configuration and traffic
    (tests at a size a CPU holds). The same hooks by name (``--fault``,
    ``--overrides``) reach the ranks of a cell of several chips."""
    import torch

    from benchmark.harness import check, spec

    t_start = _process_start()
    bench = spec.load_bench(bench_path or args.bench or ROOT / "BENCHMARK.json")
    cell = spec.Cell(bench, args.workload)
    overrides = overrides or _hook(args.overrides)
    fault = fault or _hook(args.fault)
    if overrides:
        overrides(cell)
    device = device or args.device
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: torch.cuda.is_available() is "
                             "False")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{args.workload} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
        device = "cuda"
    cuda = device == "cuda"
    if cell.chips > 1:
        if bench_path:
            args.bench = str(bench_path)
        parts = spawn(args, cell, device, t_start)
    else:
        parts = [rank_run(args, cell, "cuda:0" if cuda else device, t_start,
                          fault=fault)]
    bad = sorted(set(_forbidden()).union(*(p["forbidden"] for p in parts)))
    if bad:
        _log(f"[forbidden] modules of {bad} are loaded")
        raise SystemExit(f"modules of {bad} are loaded in the run")

    head = parts[0]
    B = int(cell.traffic["batch"])
    peak = max(p["peak"] for p in parts)
    metrics = {cell.mode.RATE[0]: (head["steps"] * B / head["window_s"],
                                   cell.mode.RATE[1]),
               "peak_mem_gib": (peak / 2 ** 30, "GiB"),
               "setup_s": (max(p["setup_s"] for p in parts), "s")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        metrics = head["per_layer"]
        dev.update(busy_s=sum(p["busy_s"] for p in parts) / len(parts),
                   window_s=sum(p["trace_window_s"] for p in parts)
                   / len(parts))
    else:
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in names}

    # the check, with every rank's program state freed
    check_device = "cuda:0" if cuda else device
    got = cell.mode.check_run(cell, args.seed, check_device,
                              [p["snapshot"] for p in parts], cell.chips)
    correct, compared = check.judge(got, cell.limits)
    result = {
        "correct": bool(correct),
        "attempted": head["steps"],
        "failed": sum(p["failed"] for p in parts),
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in metrics.items()},
        "device": dev,
    }
    if args.trace and "breakdown" in head:
        result["breakdown"] = head["breakdown"]
    result["check"] = compared
    for name, c in compared.items():
        _log(f"[check] {name} {c['value']:.6g} limit {c['limit']:.6g} "
             f"({c['where']})")
    return result


def main(argv=None) -> int:
    args = parse(argv)
    _env()
    sys.path.insert(0, str(ROOT))
    if args.rank is not None:
        return rank_main(args)
    result = run(args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

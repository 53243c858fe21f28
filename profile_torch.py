"""Profile steady train steps of the PyTorch/CUDA port on one CUDA card.

    python3 profile_torch.py [key=value ...] [--fused] [--exact] [--eval]
                             [--amp no bf16] [--steps 3]

(overrides first: ``--amp`` takes every word after it.)

Builds the port's trainer from ``run_torch.load_cfg`` (by default the
full-width ``synthetic_pretrain`` slice of chip_smoke.py, batch 32; the
overrides pick another, e.g. ``model.vision.args.freeze=False`` for the
unfrozen PointNet++; with ``--fused`` as well, the trainable SA levels run
the fused ``sa_train`` kernels: ``SCENEVERSE_BN_FOLD=on`` and
``SCENEVERSE_SA_TRAIN_FUSED=on``; with ``--exact``, the JAX package's exact
mode of chip_smoke.py's ``EXACT_ENV``: no fused attention, flash attention
in eval, the batched SA2 stage), takes two warm-up steps on one fixed
batch (with ``--eval``: eval forwards on one fixed test batch), times
``--steps`` steps, then runs as many under torch.profiler, for each
``--amp`` mode (``mixed_precision``). Prints wall ms/step with and without
the profiler, device kernel time per step, the device busy share of both,
the host calls that wait on the device (synchronisations, allocations,
copies), the device time by kernel family (this port's kernels, GEMMs,
elementwise and reduction kernels (BatchNorm, ReLU, LayerNorm, GELU),
other) and, for the kernels that several entries share (``sa_train``'s,
``sv_sa_fwd_kernel``), by entry (the device span of each wrapper's
``record_function`` range); writes the torch.profiler
tables, by device and by host time, to
``profile_<frozen|unfrozen>[_fused][_exact][_eval]_<amp>.txt`` in ``OUT_DIR``;
and, for each of the port's kernels, its device time, launches per step and
time per launch.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
sys.path.insert(0, REPO)

from chip_smoke import EXACT_ENV, FUSED_ENV, SLICE_ARGS  # noqa: E402

_GEMM = ("gemm", "sgemm", "cutlass", "xmma", "nvjet")
_ELEMENTWISE = ("elementwise", "reduce_kernel", "norm", "batch_norm")
_HOST_WAITS = ("Synchronize", "cudaMalloc", "cudaFree", "cudaMemcpy")


_SA_TRAIN = ("st_reduce_kernel", "pb_rows_kernel", "pb_dw_kernel",
             "pb_cvt_kernel")
# the wrappers' profiler ranges: the sa_train entries share the kernels
# above, sa_group_mlp_pool and sa_dense_pool share sv_sa_fwd_kernel
_SA_ENTRIES = ("sa_stats", "sa_pool", "sa_stats_bwd", "sa_pool_bwd",
               "sa_group_mlp_pool", "sa_dense_pool")
_PORT = ("mha_fwd", "mha_bwd", "sa_fwd", "ball_group", "fps", "fa_fwd",
         "fa_dkv", "fa_dq")


def family(name: str) -> str:
    for k in _PORT:
        if k in name:
            return k
    if any(k in name for k in _SA_TRAIN):
        return "sa_train"
    low = name.lower()
    if any(t in low for t in _GEMM):
        return "gemm"
    return "elementwise" if any(t in low for t in _ELEMENTWISE) else "other"


def profile(amp: str, steps: int, overrides: list[str], evaluate: bool) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import run_torch
    from sceneverse_tpu_torch.trainer.build import build_trainer, to_device

    runs = os.path.join(REPO, "build", "prof")
    cfg = run_torch.load_cfg(SLICE_ARGS + [f"mixed_precision={amp}",
                                           f"exp_dir={runs}", *overrides])
    tag = "frozen" if cfg.model.vision.args.get("freeze") else "unfrozen"
    if os.environ.get("SCENEVERSE_SA_TRAIN_FUSED") == "on":
        tag += "_fused"
    if os.environ.get("SCENEVERSE_FUSED_MHA") == "off":
        tag += "_exact"
    trainer = build_trainer(cfg)
    split = "test" if evaluate else "train"
    tag += "_eval" if evaluate else ""
    batch = to_device(next(iter(trainer.data_loaders[split])), trainer.device)
    step = trainer.forward if evaluate else trainer.train_forward_backward
    for _ in range(2):  # warm-up
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the same steps without the profiler's cost
    for _ in range(steps):
        step(batch)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam, total, entries = {}, 0.0, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if (dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or "#" in e.key or e.key.startswith("ProfilerStep")):
            continue  # user-annotation ranges would count their kernels twice
        if e.key in _SA_ENTRIES:  # a wrapper's range on the device
            entries[e.key] = (dev_us, e.count)
            continue
        f = fam.setdefault(family(e.key), [0.0, [], 0])
        f[0] += dev_us
        f[1].append((dev_us, e.key))
        f[2] += e.count
        total += dev_us
    print(f"[profile {tag} {amp}] {steps} steps, "
          f"{wall / steps * 1e3:.2f} ms/step wall profiled, "
          f"{bare / steps * 1e3:.2f} without the profiler, device kernel time "
          f"{total / steps / 1e3:.2f} ms/step, busy share "
          f"{total / 1e3 / (wall * 1e3):.3f} profiled, "
          f"{min(1.0, total / 1e3 / (bare * 1e3)):.3f} without", flush=True)
    for k, (us, items, _) in sorted(fam.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile {tag} {amp}]   {k:11s} {us / steps / 1e3:8.2f} ms/step "
              f"({us / total:.3f} of device time)")
        for t, n in sorted(items, reverse=True)[:3]:
            print(f"[profile {tag} {amp}]       {t / steps / 1e3:8.2f} ms  {n[:90]}")
    for k in _PORT:  # each of the port's kernels on its own
        if k in fam:
            us, _, n = fam[k]
            print(f"[profile {tag} {amp}]   kernel {k:10s} "
                  f"{us / steps / 1e3:8.3f} ms/step, {n / steps:.0f} "
                  f"launches/step, {us / n / 1e3:.4f} ms per launch")
    for k, (us, n) in sorted(entries.items()):
        print(f"[profile {tag} {amp}]   entry {k:17s} "
              f"{us / steps / 1e3:8.2f} ms/step on the device, "
              f"{n / steps:.0f} calls/step")
    for e in prof.key_averages():  # host calls that wait on the device
        if any(t in e.key for t in _HOST_WAITS):
            print(f"[profile {tag} {amp}]   host {e.key}: "
                  f"{e.count / steps:.1f} calls/step, "
                  f"{e.self_cpu_time_total / steps / 1e3:.2f} ms/step")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{tag}_{amp}.txt"), "w") as fh:
        for key in ("self_cuda_time_total", "self_cpu_time_total"):
            fh.write(prof.key_averages().table(sort_by=key, row_limit=60))
            fh.write("\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--amp", nargs="+", default=["no", "bf16"],
                   choices=["no", "bf16"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--fused", action="store_true",
                   help="both sa_train gates on (use with freeze=False)")
    p.add_argument("--exact", action="store_true",
                   help="the exact-mode gates of chip_smoke.EXACT_ENV")
    p.add_argument("--eval", action="store_true",
                   help="eval forwards on a test batch, not train steps")
    p.add_argument("overrides", nargs="*", help="key.sub=value overrides")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.fused:
        os.environ.update(FUSED_ENV)
    if a.exact:
        os.environ.update(EXACT_ENV)
    for amp in a.amp:
        profile(amp, a.steps, a.overrides, a.eval)


if __name__ == "__main__":
    main()

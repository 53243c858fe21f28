"""Grounding latency of the PyTorch/CUDA port: p50 / p90 per request batch.

The port's counterpart of ``bench_latency.py``: the eval-mode GPS forward
(text + 80 objects x 1024 points -> og3d grounding logits, then each
request's ``argmax`` and ``max``) at serving batch sizes 1, 8 and 32 on one
CUDA card, random weights from seed 0 (``gps_inputs.gps_cfg`` at GPS
widths), bf16 through the trainer's ``torch.autocast`` policy. Each batch
size: WARMUP untimed calls, then ITERS calls, each its own block: the host
clock from the call to its fetched result (``p50_ms``, ``p90_ms``) and the
CUDA-event time of the same call on the card (``device_ms_est``, the
median, with its min and max). The JAX tool nets a dispatch floor out of
its host clock instead; the card is attached, so its events time the call
itself. The path launches the port's ``fps``, ``sa_group_mlp_pool`` and
``mha_fwd`` kernels (``launches_per_call``); the kernels run as the
trainer routes them.

    python3 bench_latency_torch.py                  # the card
    python3 bench_latency_torch.py --device cpu     # the plain twins

Prints one JSON line per batch size, each with the card's record
(``nvidia-smi`` name, power limit, NVIDIA driver version; torch and CUDA
versions).
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NUM_OBJ = 80
NUM_POINTS = 1024
SEQ_LEN = 50
WARMUP = 5
ITERS = 30
BATCHES = (1, 8, 32)


def _percentiles(ts):
    ts = sorted(ts)
    return (ts[len(ts) // 2] * 1000,
            ts[min(len(ts) - 1, int(len(ts) * 0.9))] * 1000)


def build(cfg, device, seed=0):
    """The eval-mode model of ``cfg`` from ``seed`` (the trainer's
    construction: a CPU generator, then the device)."""
    import torch

    from sceneverse_tpu_torch.model import build_model

    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def ground(model, batch, amp=True):
    """Per-request argmax and max of the og3d logits of the eval forward
    (the serving shape the JAX tool fetches), under the trainer's bf16
    autocast when ``amp``."""
    import torch

    dev = batch["obj_fts"].device.type
    with torch.no_grad(), torch.autocast(dev, dtype=torch.bfloat16,
                                         enabled=amp):
        logits = model(batch)["og3d_logits"]
    return logits.argmax(-1), logits.max(-1).values


def measure(model, batch, device, warmup=WARMUP, iters=ITERS, amp=True):
    """(host seconds per call, device ms per call, the last argmax and
    max, launches per call)."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.utils.benchtools import Clock, sync

    for _ in range(warmup):
        idx, score = ground(model, batch, amp)
        float(score.float().sum())
    sync(device)
    before = dict(_build.LAUNCHES)
    host, dev = [], []
    for _ in range(iters):
        clock = Clock(device)
        t0 = time.perf_counter()
        clock.start()
        idx, score = ground(model, batch, amp)
        clock.stop()
        float(score.float().sum())
        host.append(time.perf_counter() - t0)
        dev.append(clock.ms())
    per_call = {k: (v - before.get(k, 0)) / iters
                for k, v in _build.LAUNCHES.items() if v - before.get(k, 0)}
    return host, dev, (idx, score), per_call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--iters", type=int, default=ITERS)
    # model and batch sizes (GPS defaults; the tests shrink them)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--num-obj", type=int, default=NUM_OBJ)
    ap.add_argument("--num-points", type=int, default=NUM_POINTS)
    ap.add_argument("--seq-len", type=int, default=SEQ_LEN)
    args = ap.parse_args(argv)

    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import (emit, resolve_device,
                                                       spread)
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg

    device = resolve_device(args.device)
    cfg = gps_cfg(hidden=args.hidden, layers=args.layers, heads=args.heads,
                  vocab=args.vocab)
    model = build(cfg, device)
    for batch_size in (int(b) for b in args.batches.split(",")):
        batch = to_device(gps_batch(batch_size, args.num_obj,
                                    args.num_points, args.seq_len,
                                    vocab=args.vocab), device)
        host, dev, (idx, score), per_call = measure(
            model, batch, device, args.warmup, args.iters)
        p50, p90 = _percentiles(host)
        d = spread(dev)
        emit({
            "metric": "gps_grounding_latency",
            "batch": batch_size,
            "p50_ms": round(p50, 4),
            "p90_ms": round(p90, 4),
            "device_ms_est": round(d["median"], 4),
            "device_ms_min": round(d["min"], 4),
            "device_ms_max": round(d["max"], 4),
            "host_ms_mean": round(statistics.mean(host) * 1000, 4),
            "unit": "ms/request-batch",
            "warmup": args.warmup, "iters": args.iters,
            "precision": "bf16", "seed": 0,
            "num_obj": args.num_obj, "num_points": args.num_points,
            "seq_len": args.seq_len, "hidden": args.hidden,
            "layers": args.layers,
            "launches_per_call": per_call,
            "argmax": idx.tolist(),
            "max": [float(x) for x in score.float().tolist()],
        }, device)


if __name__ == "__main__":
    main()

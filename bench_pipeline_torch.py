"""Input pipeline and trainer loop of the PyTorch/CUDA port at GPS scale.

The port's counterpart of ``bench_pipeline.py``: what a device-resident
step time leaves out. On a fixture tree the port's ``data/fixture.py``
writes (4 scans x 75 objects x 1800 points, 5 annotations an object; kept
under ``SCENEVERSE_BENCH_FIXTURE``, default ``build/bench_fixture``) and
``bench_cfg`` (all_pretrain's shapes: batch 64, 80 objects x 1024 points,
50 tokens, caption 64, bf16, ``SCENEVERSE_PALLAS_FAST=1`` unless set):

  * ``item_build``: ScanBase items on the native C++ path, one core (host
    clock);
  * ``materialized``: the fused materialized batch assembly (host clock);
  * ``collate``: the ``DataLoader`` and its collate, no device transfer
    (host clock); with ``--workers N`` its N spawned workers, and the
    start (``start_s``: from ``iter`` to the first batch) apart from the
    steady rate;
  * ``h2d``: ``trainer/build.py::to_device`` of that GPS batch on CUDA
    events, from pageable memory as the loader hands it
    (``pin_memory=False``) and from pinned memory;
  * ``trainer_loop``: the real ``build_trainer`` epoch on two
    device-resident batches, a warm epoch and then REPS epochs on CUDA
    events, with each step's device time (``step_ms``);
  * ``eval_loop``: the val epoch (forwards and the evaluator) on a
    device-resident batch, the same way;
  * with ``--workers N`` also ``trainer_feed`` with the N-worker loader in
    the loop: the epoch on the host clock and each step's device time
    beside the workers;
  * ``--feed-sweep`` instead: the materialized feed at 1, 2 and 4 threads
    and ``trainer_feed`` with the materialized loader in the loop.

    python3 bench_pipeline_torch.py [--steps 16] [--workers N]
                                    [--feed-sweep] [--skip-trainer]
                                    [--device cpu] [key=value ...]

(``key=value`` overrides of ``bench_cfg``, e.g. smaller widths.) Prints
one JSON line per phase with the card's record. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("SCENEVERSE_PALLAS_FAST", "1")

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BATCH = 64
NUM_OBJ = 80
NUM_POINTS = 1024
SEQ_LEN = 50
CAP_LEN = 64
FIXTURE_SCANS = 4
FIXTURE_OBJECTS = 75          # leaves headroom under max_obj_len=80
PTS_PER_OBJ = 1800            # > num_points so subsampling is real work
ANNOS_PER_OBJ = 5
REPS = 3


def fixture_root(scans=FIXTURE_SCANS, objects=FIXTURE_OBJECTS,
                 pts=PTS_PER_OBJ, annos=ANNOS_PER_OBJ) -> Path:
    """The GPS-scale fixture tree, kept between runs and written again when
    its sizes change."""
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    root = Path(os.environ.get("SCENEVERSE_BENCH_FIXTURE",
                               os.path.join(REPO, "build", "bench_fixture")))
    stamp = root / ".complete"
    tag = f"{scans}-{objects}-{pts}-{annos}"
    if not (stamp.exists() and stamp.read_text() == tag):
        import shutil

        if root.exists():
            shutil.rmtree(root)
        write_synthetic_tree(root, n_scans=scans, n_objects=objects,
                             pts_per_obj=pts, annos_per_obj=annos)
        stamp.write_text(tag)
    return root


def bench_cfg(data_root, exp_dir, num_workers=0, device="cuda"):
    """The GPS config (all_pretrain.yaml's shape budget) on the fixture."""
    from sceneverse_tpu_torch.config import Config

    return Config({
        "name": "BenchGPS", "rng_seed": 42, "num_gpu": 1, "mode": "train",
        "exp_dir": str(exp_dir), "task": "Pretrain",
        "trainer": "OpenVocabTrainer",
        "mixed_precision": "bf16", "device": device,
        "debug": {"flag": False, "hard_debug": False},
        "data": {
            "train": ["ScanNetSpatialRefer"],
            "val": ["ScanNetSpatialRefer"],
            "test": ["ScanNetSpatialRefer"],
            "scan_family_base": str(data_root),
            "args": {
                "max_obj_len": NUM_OBJ, "max_seq_len": SEQ_LEN,
                "num_points": NUM_POINTS, "pc_type": "gt", "sem_type": "607",
                "filter_lang": False, "txt_mask_ratio": 0.15,
                "pc_mask_ratio": 0.1, "rot_aug": True,
                "mask_strategy": "random", "use_scene_cap": True,
                "max_scene_cap_len": CAP_LEN, "native_loader": True,
            },
            "ScanNetSpatialRefer": {
                "train": {"sources": ["scanrefer"]},
                "val": {"sources": ["scanrefer"]},
                "test": {"sources": ["scanrefer"]},
            },
        },
        "data_wrapper": {"train": "MaskDatasetWrapper",
                         "val": "ScanFamilyDatasetWrapperOld",
                         "test": "ScanFamilyDatasetWrapperOld"},
        "dataloader": {"batchsize": BATCH, "num_workers": num_workers},
        "solver": {
            "gradient_accumulation_steps": 1, "epochs_per_eval": 0,
            "epochs_per_save": 0, "log_every": 10,
            "lr": 5e-4, "grad_norm": 5.0, "epochs": 3,
            "optim": {"name": "AdamW", "args": {"betas": [0.9, 0.98]}},
            "sched": {"name": "warmup_cosine",
                      "args": {"warmup_steps": 500, "minimum_ratio": 0.1}},
        },
        "eval": {"train": {"name": "PretrainEval"},
                 "val": {"name": "ScanReferEval"}, "save": False},
        "model": {
            "name": "OpenVocab", "inter": "before",
            "language": {"name": "BERTLanguageEncoder", "lr": 1e-5,
                         "args": {"hidden_size": 768, "num_hidden_layers": 4,
                                  "num_attention_heads": 12}},
            "vision": {"name": "PointOpenVocabEncoder", "lr": 1e-4,
                       "args": {"hidden_size": 768, "freeze": True,
                                "num_attention_heads": 12, "num_layers": 4,
                                "dim_feedforward": 2048, "spatial_dim": 5,
                                "dim_loc": 6, "attn_type": "spatial",
                                "pairwise_rel_type": "center"}},
            "grounding": {"name": "UnifiedSpatialCrossEncoderV2", "lr": 1e-4,
                          "args": {"hidden_size": 768, "num_attention_heads": 12,
                                   "num_layers": 4, "dim_feedforward": 2048,
                                   "dim_loc": 6}},
            "heads": {"head_list": ["pretrain_head"],
                      "pretrain_head": {"name": "OVPretrainHead",
                                        "args": {"hidden_size": 768,
                                                 "vocab_size": 30522}}},
            "loss_list": ["lm_cls_loss", "TextObjWithinBatch",
                          "TextSceneBetweenBatch"],
            "vis_loss_list": ["lm_cls_loss", "TextObjWithinBatch",
                              "TextSceneBetweenBatch"],
        },
    })


class Emitter:
    """One JSON line per phase: the JAX tool's metric, value and unit, and
    the card's record."""

    def __init__(self, device):
        self.device = device

    def __call__(self, metric, value, unit="scenes/s", **extra):
        from sceneverse_tpu_torch.utils.benchtools import emit

        emit({"metric": metric, "value": round(value, 4), "unit": unit,
              **extra}, self.device)


def _spread_fields(ms, prefix="") -> dict:
    from sceneverse_tpu_torch.utils.benchtools import spread

    return {f"{prefix}{k}_ms": round(v, 4) for k, v in spread(ms).items()}


def bench_item_build(cfg, emit, n=24):
    from sceneverse_tpu_torch.data.build import get_dataset

    ds = get_dataset(cfg, "train")
    n = min(n, len(ds))
    ds[0]  # warm (opens .pth, builds caches)
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    rate = n / (time.perf_counter() - t0)
    emit("item_build_scenes_per_sec_per_core", rate, items=n,
         native_loader=bool(cfg.data.args.native_loader))
    return ds, rate


def drain(it, loader):
    """A loader with workers is read to its epoch's end: a worker shut down
    while its batches in shared memory wait unread aborts (torch's)."""
    if getattr(loader, "num_workers", 0):
        for _ in it:
            pass


def bench_collate(cfg, emit, steps=6):
    from sceneverse_tpu_torch.data import build_dataloader

    loader = build_dataloader(cfg, split="train")
    workers = int(cfg.dataloader.num_workers)
    t0 = time.perf_counter()
    it = iter(loader)
    next(it)  # warm: with workers, their start
    start_s = time.perf_counter() - t0
    steps = min(steps, len(loader) - 1)
    t0, n = time.perf_counter(), 0
    for _ in range(steps):
        batch = next(it)
        n += batch["obj_fts"].shape[0]
    rate = n / (time.perf_counter() - t0)
    drain(it, loader)
    emit("loader_collate_scenes_per_sec", rate, workers=workers,
         steps=steps, start_s=round(start_s, 4))
    return batch, rate


def _materialized_loader(cfg, n_threads):
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.data.materialized import (
        MaterializedBatchLoader, ensure_materialized)

    cfg = Config(cfg.to_dict())
    cfg.data.args["materialized"] = "fast"
    store = ensure_materialized(cfg, "ScanNetSpatialRefer", "train")
    return cfg, MaterializedBatchLoader(cfg, [store], n_threads=n_threads)


def bench_materialized(cfg, emit, steps=10, n_threads=1):
    """The fused materialized batch assembly (data/materialized.py), the
    production train feed."""
    _, loader = _materialized_loader(cfg, n_threads)
    it = iter(loader)
    batch = next(it)  # warm (faults the mmap pages)
    n, t0 = 0, time.perf_counter()
    for _ in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        n += batch["obj_fts"].shape[0]
    rate = n / (time.perf_counter() - t0)
    emit("materialized_feed_scenes_per_sec", rate, threads=n_threads,
         steps=steps)
    return batch, rate


def bench_h2d(batch, device, emit, iters=4, reps=REPS):
    """``to_device`` of the host batch on CUDA events: from the loader's
    pageable numpy arrays, and from pinned copies of them."""
    import torch

    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import blocks_ms, spread

    arrays = {k: v for k, v in batch.items() if hasattr(v, "ndim")}
    nbytes = sum(v.nbytes for v in arrays.values())
    pinned = None
    if device.type == "cuda":
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in arrays.items() if v.dtype != object}
    out = {}
    for name, host in (("pageable", arrays), ("pinned", pinned)):
        if host is None:
            continue
        ms = blocks_ms(lambda: to_device(host, device), device, n=iters,
                       reps=reps)
        med = spread(ms)["median"]
        emit("h2d_batch_transfer_mb_per_sec", nbytes / (med / 1e3) / 1e6,
             unit="MB/s", batch_mb=round(nbytes / 1e6, 1), memory=name,
             iters=iters, reps=reps, **_spread_fields(ms))
        out[name] = med
    return out


class DeviceBatchLoader:
    """A fixed ring of device-resident batches: the trainer loop without the
    host build and the copy."""

    def __init__(self, batches, length):
        self.batches = batches
        self.length = length

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            yield dict(self.batches[i % len(self.batches)])


class BoundedLoader:
    """Any host-batch loader bound to ``steps`` batches an epoch."""

    def __init__(self, loader, steps):
        self.loader, self.steps = loader, steps

    def __len__(self):
        return self.steps

    def __iter__(self):
        it = iter(self.loader)
        for _ in range(self.steps):
            try:
                yield next(it)
            except StopIteration:
                it = iter(self.loader)
                try:
                    yield next(it)
                except StopIteration:
                    raise RuntimeError(
                        "BoundedLoader: the wrapped loader yields no batches "
                        "(empty split?)") from None
        drain(it, self.loader)


def _epochs(trainer, steps, device, reps, clock="device"):
    """A warm epoch, then ``reps`` epochs of ``train_step``: each epoch's ms
    (CUDA events, or the host clock for a loader in the loop) and every
    timed step's device ms."""
    from sceneverse_tpu_torch.utils.benchtools import StepTimer, Clock

    trainer.total_steps = steps * (reps + 1)
    trainer.train_step(0)                      # warm epoch
    timer = StepTimer(trainer, "train_forward_backward", device)
    epoch_ms = []
    with timer.running():
        for e in range(reps):
            if clock == "device":
                c = Clock(device)
                c.start()
                trainer.train_step(1 + e)
                c.stop()
                epoch_ms.append(c.ms())
            else:
                t0 = time.perf_counter()
                trainer.train_step(1 + e)      # ends in a fetch of the logs
                epoch_ms.append((time.perf_counter() - t0) * 1e3)
    return epoch_ms, timer.ms()


def bench_trainer_loop(cfg, device_batches, steps, device, emit, reps=REPS):
    from sceneverse_tpu_torch.trainer import build_trainer
    from sceneverse_tpu_torch.utils.benchtools import launches, spread

    trainer = build_trainer(cfg)
    trainer.data_loaders["train"] = DeviceBatchLoader(device_batches, steps)
    epoch_ms, step_ms = _epochs(trainer, steps, device, reps)
    batch = int(cfg.dataloader.batchsize)
    rate = steps * batch / (spread(epoch_ms)["median"] / 1e3)
    emit("trainer_loop_scenes_per_sec", rate, steps=steps, reps=reps,
         log_every=int(cfg.solver.log_every), batch=batch,
         **_spread_fields(epoch_ms, "epoch_"),
         **_spread_fields(step_ms, "step_"), launches=launches())
    return trainer, rate


def bench_trainer_feed(cfg, steps, device, emit, n_threads=1, workers=0,
                       reps=REPS):
    """The train throughput with the loader in the loop: the materialized
    feed at ``n_threads``, or (``workers`` > 0) the spawned DataLoader,
    on the host clock per epoch, with each step's device time beside it."""
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.data import build_dataloader
    from sceneverse_tpu_torch.trainer import build_trainer
    from sceneverse_tpu_torch.utils.benchtools import spread

    if workers:
        cfg = Config(cfg.to_dict())
        cfg.dataloader["num_workers"] = workers
        loader, extra = build_dataloader(cfg, "train"), {"workers": workers}
    else:
        cfg, loader = _materialized_loader(cfg, n_threads)
        extra = {"threads": n_threads}
    trainer = build_trainer(cfg)
    trainer.data_loaders["train"] = BoundedLoader(loader, steps)
    t0 = time.perf_counter()
    epoch_ms, step_ms = _epochs(trainer, steps, device, reps, clock="host")
    warm_s = time.perf_counter() - t0 - sum(epoch_ms) / 1e3
    batch = int(cfg.dataloader.batchsize)
    rate = steps * batch / (spread(epoch_ms)["median"] / 1e3)
    emit("trainer_feed_scenes_per_sec", rate, steps=steps, reps=reps,
         loader="dataloader" if workers else "materialized",
         warm_epoch_s=round(warm_s, 4), **extra,
         **_spread_fields(epoch_ms, "epoch_"),
         **_spread_fields(step_ms, "step_"))
    return rate


def bench_eval_loop(cfg, trainer, device, emit, steps=12, reps=REPS):
    """The val epoch: forwards and the evaluator's host update per batch
    (the reference runs it every epoch), on a device-resident batch."""
    from sceneverse_tpu_torch.data import build_dataloader
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import Clock, spread

    loader = build_dataloader(cfg, split="val")
    loader = loader[0] if isinstance(loader, list) else loader
    raw = next(iter(loader))
    aux = {k: v for k, v in raw.items() if not hasattr(v, "ndim")}
    device_batch = {**to_device(raw, device), **aux}
    trainer.data_loaders["val"] = DeviceBatchLoader([device_batch], steps)
    trainer._eval_loop("val", "val")       # warm
    epoch_ms = []
    for _ in range(reps):
        trainer.data_loaders["val"] = DeviceBatchLoader([device_batch], steps)
        c = Clock(device)
        c.start()
        trainer._eval_loop("val", "val")
        c.stop()
        epoch_ms.append(c.ms())
    rate = steps * raw["obj_fts"].shape[0] / (
        spread(epoch_ms)["median"] / 1e3)
    emit("eval_loop_scenes_per_sec", rate, steps=steps, reps=reps,
         **_spread_fields(epoch_ms, "epoch_"))
    return rate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--workers", type=int, default=0,
                    help="DataLoader workers (spawned); 0: none")
    ap.add_argument("--skip-trainer", action="store_true")
    ap.add_argument("--feed-sweep", action="store_true",
                    help="the materialized feed at 1, 2 and 4 threads and "
                         "the train loop with it in the loop")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--fixture-scans", type=int, default=FIXTURE_SCANS)
    ap.add_argument("--fixture-objects", type=int, default=FIXTURE_OBJECTS)
    ap.add_argument("--fixture-points", type=int, default=PTS_PER_OBJ)
    ap.add_argument("overrides", nargs="*", help="key=value of bench_cfg")
    args = ap.parse_args(argv)

    import numpy as np

    from sceneverse_tpu_torch.config import apply_overrides
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import resolve_device

    device = resolve_device(args.device)
    emit = Emitter(device)
    root = fixture_root(args.fixture_scans, args.fixture_objects,
                        args.fixture_points)
    exp = root.parent / "bench_pipeline_exp"  # the trainers' logs
    exp.mkdir(parents=True, exist_ok=True)
    cfg = apply_overrides(
        bench_cfg(root, exp, num_workers=args.workers, device=str(device)),
        args.overrides)

    if args.feed_sweep:
        for nt in (1, 2, 4):
            bench_materialized(cfg, emit, steps=16, n_threads=nt)
        bench_trainer_feed(cfg, args.steps, device, emit,
                           n_threads=max(1, args.workers), reps=args.reps)
        return
    bench_item_build(cfg, emit)
    bench_materialized(cfg, emit, n_threads=max(1, args.workers))
    batch, _ = bench_collate(cfg, emit)
    arrays = {k: v for k, v in batch.items()
              if hasattr(v, "ndim") and v.dtype != object}
    if args.workers:  # the workers' batches are CPU tensors already
        arrays = {k: v.numpy() for k, v in arrays.items()}
    bench_h2d(arrays, device, emit, reps=args.reps)

    if not args.skip_trainer:
        # two distinct device-resident batches (a ring) so that steps are
        # not value-degenerate, placed once before timing
        b2 = {k: np.ascontiguousarray(v[::-1]) if v.ndim else v
              for k, v in arrays.items()}
        device_batches = [to_device(arrays, device), to_device(b2, device)]
        trainer, _ = bench_trainer_loop(cfg, device_batches, args.steps,
                                        device, emit, reps=args.reps)
        bench_eval_loop(cfg, trainer, device, emit, reps=args.reps)
        del trainer, device_batches
        if args.workers:
            bench_trainer_feed(cfg, args.steps, device, emit,
                               workers=args.workers, reps=args.reps)


if __name__ == "__main__":
    main()

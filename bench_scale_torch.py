"""Production-scale host path of the PyTorch/CUDA port's data pipeline.

The port's counterpart of ``bench_scale.py``. SceneVerse is about 68K scans
and 2.5M vision-language pairs. The reference loads every scan into RAM up
front in each worker process (reference data/datasets/base.py:65-142);
the materialized store does not need to. This drill measures the costs at
that scan and item count on a metadata-scale fixture (6 objects of 24
points a scan: the axis under test is the tables, not the point volume;
each batch still writes full-size objects, as assembly subsamples every
object to 1024 points):

  * ``fixture``: the synthetic tree's write time and disk size;
  * ``materialize``: the live ScanBase init (the reference-style full
    up-front load: seconds and RSS high-water) and the one-time store
    build on top of it (data/materialized.py);
  * ``feed``: the store-backed start (mmap open and loader preparation:
    seconds and RSS) and the fused batch assembly rate;
  * ``feed_mesh``: what one dp rank of 8 loads: each global batch
    assembled (as every rank assembles it), rank 0's rows of it at dp 8
    (``parallel/mesh.py::rank_rows``) taken and copied to the card by
    ``trainer/build.py::to_device`` (the copy on CUDA events, ``h2d_ms``).

Each phase runs in its own subprocess and reports its RAM high-water as
``VmHWM`` (``/proc/self/status``: the high-water of the process's own
memory since its ``exec``) where the kernel reports it, else as
``ru_maxrss``, which the JAX tool reads: on Linux a child's ``ru_maxrss``
also keeps the high-water of the memory it held before its ``exec``, a
copy of its parent's. Either includes the process's own floor, the
import of torch among it. Host work is on the host clock.

    python3 bench_scale_torch.py [--scans 68000] [--annos-per-obj 12]
                                 [--batch 128] [--steps 40]
                                 [--root build/scale] [--device cpu]

Prints one JSON line per measurement with the card's record. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NUM_OBJ = 80        # max_obj_len (GPS consumption shape)
NUM_POINTS = 1024
SEQ_LEN = 50
CAP_LEN = 64
FIX_OBJECTS = 6     # objects a scan in the fixture (3 foreground)
FIX_PTS = 24        # points an object: a metadata drill, not point volume
DP = 8              # the dp size whose rank 0 feed_mesh stands for


def emit(args, metric, value, unit, **extra):
    from sceneverse_tpu_torch.utils.benchtools import (emit as _emit,
                                                       resolve_device)

    _emit({"metric": metric, "value": round(value, 4), "unit": unit,
           **extra}, resolve_device(args.device))


def rss_gib() -> float:
    """This process's RAM high-water since its ``exec``: ``VmHWM`` where
    ``/proc`` has it, else ``ru_maxrss`` (KiB on Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2**20  # kB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def tree_gib(path) -> float:
    total = 0
    for p in Path(path).rglob("*"):
        if p.is_file():
            total += p.stat().st_size
    return total / 2**30


def drill_cfg(root, batch):
    from sceneverse_tpu_torch.config import Config

    return Config({
        "name": "ScaleDrill", "rng_seed": 42, "num_gpu": 1, "mode": "train",
        "exp_dir": str(Path(root) / "exp"), "task": "Pretrain",
        "debug": {"flag": False, "hard_debug": False},
        "data": {
            "train": ["ScanNetSpatialRefer"],
            "scan_family_base": str(root),
            "args": {
                "max_obj_len": NUM_OBJ, "max_seq_len": SEQ_LEN,
                "num_points": NUM_POINTS, "pc_type": "gt", "sem_type": "607",
                "filter_lang": False, "txt_mask_ratio": 0.15,
                "pc_mask_ratio": 0.1, "rot_aug": True,
                "mask_strategy": "random", "use_scene_cap": True,
                "max_scene_cap_len": CAP_LEN, "native_loader": True,
            },
            "ScanNetSpatialRefer": {"train": {"sources": ["scanrefer"]}},
        },
        "data_wrapper": {"train": "MaskDatasetWrapper"},
        "dataloader": {"batchsize": batch, "num_workers": 0},
    })


# ------------------------------------------------------------------ phases
def phase_fixture(args):
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    root = Path(args.root)
    stamp = root / ".complete"
    tag = f"{args.scans}-{FIX_OBJECTS}-{FIX_PTS}-{args.annos_per_obj}"
    if stamp.exists() and stamp.read_text() == tag:
        emit(args, "scale_fixture_write", 0.0, "s", cached=True,
             scans=args.scans, disk_gib=round(tree_gib(root), 4))
        return
    import shutil

    if root.exists():
        shutil.rmtree(root)
    t0 = time.perf_counter()
    write_synthetic_tree(root, n_scans=args.scans, n_objects=FIX_OBJECTS,
                         pts_per_obj=FIX_PTS,
                         annos_per_obj=args.annos_per_obj)
    dt = time.perf_counter() - t0
    stamp.write_text(tag)
    emit(args, "scale_fixture_write", dt, "s", scans=args.scans,
         disk_gib=round(tree_gib(root), 4), rss_gib=round(rss_gib(), 4))


def phase_materialize(args):
    import sceneverse_tpu_torch.data  # noqa: F401 (registry population)
    from sceneverse_tpu_torch.data.build import DATASET_REGISTRY
    from sceneverse_tpu_torch.data.materialized import (_fingerprint,
                                                        materialize_dataset)

    cfg = drill_cfg(args.root, args.batch)
    t0 = time.perf_counter()
    live = DATASET_REGISTRY.get("ScanNetSpatialRefer")(cfg, "train")
    init_s = time.perf_counter() - t0
    init_rss = rss_gib()  # the reference-style all-scans-up-front high-water
    n_items = len(live)

    out = Path(args.root) / "materialized" / "ScanNetSpatialRefer_train"
    t0 = time.perf_counter()
    materialize_dataset(live, out,
                        _fingerprint(cfg, "ScanNetSpatialRefer", "train"))
    build_s = time.perf_counter() - t0
    emit(args, "scale_scanbase_full_load", init_s, "s", scans=args.scans,
         items=n_items, rss_gib=round(init_rss, 4))
    emit(args, "scale_store_build", build_s, "s",
         store_gib=round(tree_gib(out), 4), rss_gib=round(rss_gib(), 4))


def _loader(args):
    from sceneverse_tpu_torch.data.materialized import MaterializedBatchLoader

    cfg = drill_cfg(args.root, args.batch)
    store = Path(args.root) / "materialized" / "ScanNetSpatialRefer_train"
    t0 = time.perf_counter()
    loader = MaterializedBatchLoader(cfg, [store], n_threads=1)
    return loader, time.perf_counter() - t0


def phase_feed(args):
    loader, open_s = _loader(args)
    emit(args, "scale_store_open", open_s, "s", items=loader.n_items,
         rss_gib=round(rss_gib(), 4))  # against the full load's RSS
    it = iter(loader)
    next(it)  # warm: faults mmap pages, allocates the ring buffer
    n, t0 = 0, time.perf_counter()
    for _ in range(args.steps):
        n += next(it)["obj_fts"].shape[0]
    emit(args, "scale_feed_scenes_per_sec", n / (time.perf_counter() - t0),
         "scenes/s", batch=args.batch, steps=args.steps,
         rss_gib=round(rss_gib(), 4))


def phase_feed_mesh(args):
    from sceneverse_tpu_torch.parallel.mesh import rank_rows
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import (Clock,
                                                       resolve_device, spread,
                                                       sync)

    device = resolve_device(args.device)
    rows = rank_rows(args.batch, DP, 0)
    loader, _ = _loader(args)
    it = iter(loader)
    h2d = []

    def place(batch):
        arrays = {k: v[rows] for k, v in batch.items() if hasattr(v, "ndim")}
        clock = Clock(device)
        clock.start()
        placed = to_device(arrays, device)
        clock.stop()
        h2d.append(clock)
        return placed

    placed = place(next(it))  # warm
    sync(device)
    h2d.clear()
    n, t0 = 0, time.perf_counter()
    for _ in range(args.steps):
        placed = place(next(it))
        n += args.batch
    sync(device)
    dt = time.perf_counter() - t0
    ms = spread([c.ms() for c in h2d])
    emit(args, "scale_feed_dp8_scenes_per_sec", n / dt, "scenes/s",
         batch=args.batch, steps=args.steps, dp=DP, rank=0,
         rows_per_rank=rows.stop - rows.start,
         rank_scenes_per_sec=round(n / DP / dt, 4),
         rank_batch_mb=round(sum(v.numel() * v.element_size()
                                 for v in placed.values()) / 1e6, 4),
         **{f"h2d_{k}_ms": round(v, 4) for k, v in ms.items()},
         rss_gib=round(rss_gib(), 4))


PHASES = ["fixture", "materialize", "feed", "feed_mesh"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=68000)
    ap.add_argument("--annos-per-obj", type=int, default=12,
                    help="12 x 3 foreground objects x 68K scans ~= 2.5M items")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--root", default=os.path.join(REPO, "build", "scale"))
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--phase", choices=PHASES)
    args = ap.parse_args(argv)

    from sceneverse_tpu_torch.utils.benchtools import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    if args.phase:
        globals()[f"phase_{args.phase}"](args)
        return
    base = [os.path.abspath(__file__), "--scans", str(args.scans),
            "--annos-per-obj", str(args.annos_per_obj), "--batch",
            str(args.batch), "--steps", str(args.steps), "--root",
            args.root]
    if args.device:
        base += ["--device", args.device]
    for phase in PHASES:
        r = subprocess.run([sys.executable, *base, "--phase", phase])
        if r.returncode != 0:
            raise SystemExit(f"phase {phase} failed rc={r.returncode}")


if __name__ == "__main__":
    main()

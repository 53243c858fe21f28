"""Per-tower device time of the PyTorch/CUDA port at GPS train shapes.

The port's counterpart of ``bench_towers.py``: at batch 64 and caption 64,
the device ms per call of each tower of the eval-mode GPS model (random
weights from seed 0, bf16 through the trainer's ``torch.autocast`` policy,
``SCENEVERSE_PALLAS_FAST=1`` unless set, as the JAX tool sets it), under
the JAX tool's names:

  * ``lang_fused_2B``: the language tower on the utterances (padded to 64)
    and the captions in one (2B, 64) call; ``lang_txt_only`` and
    ``lang_cap_only``: the two separate calls;
  * ``vision_tower``: the point encoder (frozen PointNet++ and spatial
    transformer); ``pointnet_backbone``: the PointNet++ alone on the
    B x 80 objects;
  * ``unified_encoder`` and ``pretrain_head`` (LM 30522 + object logits)
    on standard-normal tokens.

Each is timed as the JAX tool times it: ``iters`` dependent calls chained
(each call's inputs take a zero-weighted sum of the previous call's first
floating output, so no call overlaps the next) make one block; after one
warm-up block, ``reps`` blocks on CUDA events, each over ``iters``. A
tower's value is the median block, with the min and max beside it.

    python3 bench_towers_torch.py [--batch 64]      # the card
    python3 bench_towers_torch.py --device cpu ...  # the plain twins

Prints one JSON line, with the card's record. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("SCENEVERSE_PALLAS_FAST", "1")

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

REPS = 3
CAP_LEN = 64


def _first_float(out):
    import torch

    leaves = out if isinstance(out, (tuple, list)) else [out]
    return next(x for x in leaves
                if torch.is_tensor(x) and x.is_floating_point())


def timed_chain(fn, args, device, iters=8, reps=REPS):
    """Device ms per call of ``fn(*args)``, one per block of ``iters``
    dependent calls."""
    import torch

    from sceneverse_tpu_torch.utils.benchtools import blocks_ms

    def chained():
        acc = torch.zeros((), device=device)
        a = args
        for _ in range(iters):
            out = fn(*a)
            acc = acc + _first_float(out).float().sum() * 1e-12
            # the next call depends on this one (no overlap)
            a = tuple(x + (acc * 0).to(x.dtype)
                      if torch.is_tensor(x) and x.is_floating_point() else x
                      for x in a)
        return acc

    return [ms / iters for ms in blocks_ms(chained, device, n=1, reps=reps)]


def measure(model, batch, device, reps=REPS):
    """``{tower: [ms per call of each block]}`` under the JAX tool's
    names."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    B, L = batch["txt_ids"].shape
    num_obj = batch["obj_fts"].shape[1]
    hidden = int(model.cfg.model.grounding.args.hidden_size)
    cap = batch["scene_txt_ids"].shape[1]
    results = {}
    pad = lambda x: F.pad(x, (0, max(cap - L, 0)))
    ids = torch.cat([pad(batch["txt_ids"]), batch["scene_txt_ids"]], 0)
    masks = torch.cat([pad(batch["txt_masks"]), batch["scene_txt_masks"]], 0)
    lang = model.lang_encoder
    results["lang_fused_2B"] = timed_chain(
        lambda i, m: lang(i, m), (ids, masks), device, reps=reps)
    results["lang_txt_only"] = timed_chain(
        lambda i, m: lang(i, m), (batch["txt_ids"], batch["txt_masks"]),
        device, reps=reps)
    results["lang_cap_only"] = timed_chain(
        lambda i, m: lang(i, m),
        (batch["scene_txt_ids"], batch["scene_txt_masks"]), device,
        reps=reps)
    pe = model.point_encoder
    results["vision_tower"] = timed_chain(
        lambda f, l, m, s: pe(f, l, m, s, None)[0],
        (batch["obj_fts"].float(), batch["obj_locs"], batch["obj_masks"],
         batch["obj_sem_masks"]), device, iters=4, reps=reps)
    rng = np.random.RandomState(0)
    obj_tokens = torch.from_numpy(
        rng.randn(B, num_obj, hidden).astype(np.float32)).to(device)
    flat = batch["obj_fts"].float().reshape(
        B * num_obj, *batch["obj_fts"].shape[2:])
    results["pointnet_backbone"] = timed_chain(
        lambda f: pe.point_feature_extractor(f), (flat,), device, iters=4,
        reps=reps)
    lang_tokens = torch.from_numpy(
        rng.randn(B, L, hidden).astype(np.float32)).to(device)
    results["unified_encoder"] = timed_chain(
        lambda lt, lm, ot, ol, om: model.unified_encoder(
            lt, lm, ot, ol, om)[0],
        (lang_tokens, batch["txt_masks"], obj_tokens, batch["obj_locs"],
         batch["obj_masks"]), device, reps=reps)
    if getattr(model, "pretrain_head", None) is not None:
        results["pretrain_head"] = timed_chain(
            lambda lt, ot: model.pretrain_head(lt, ot),
            (lang_tokens, obj_tokens), device, reps=reps)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--reps", type=int, default=REPS)
    # model and batch sizes (GPS defaults; the tests shrink them)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--num-obj", type=int, default=80)
    ap.add_argument("--num-points", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    from bench_latency_torch import build
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.benchtools import (emit, launches,
                                                       resolve_device,
                                                       spread)
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg

    device = resolve_device(args.device)
    cfg = gps_cfg(hidden=args.hidden, layers=args.layers, heads=args.heads,
                  vocab=args.vocab)
    model = build(cfg, device)
    batch = to_device(gps_batch(args.batch, args.num_obj, args.num_points,
                                args.seq_len, vocab=args.vocab,
                                cap_len=CAP_LEN), device)
    with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16):
        blocks = measure(model, batch, device, args.reps)
    stats = {k: spread(v) for k, v in blocks.items()}
    emit({
        "metric": "gps_tower_device_ms",
        **{k: round(s["median"], 4) for k, s in stats.items()},
        "min_ms": {k: round(s["min"], 4) for k, s in stats.items()},
        "max_ms": {k: round(s["max"], 4) for k, s in stats.items()},
        "unit": "ms/call", "reps": args.reps,
        "iters": {k: 4 if k in ("vision_tower", "pointnet_backbone") else 8
                  for k in blocks},
        "batch": args.batch, "cap_len": CAP_LEN, "precision": "bf16",
        "pallas_fast": os.environ.get("SCENEVERSE_PALLAS_FAST"),
        "launches": launches(),
    }, device)


if __name__ == "__main__":
    main()

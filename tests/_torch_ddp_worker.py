"""Data-parallel runs of the port, shared by ``tests/test_torch_ddp.py`` and
the ranks it spawns: each function runs the same code in a world of 1 (the
test process, no process group) and in each rank of a gloo world of 2
(``run``, a spawned process). Imports no JAX, so that a rank starts fast.

Setup: ``synthetic_pretrain.yaml`` at hidden 64, 1 layer, 4 heads, 4
objects x 64 points, 16 + 16 tokens, global batch 4 (2 a rank), AdamW eps
1e-6, no warmup, dropout off, ``SCENEVERSE_FUSED_MHA=off`` on both sides.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CFG = os.path.join(REPO, "configs", "final", "synthetic_pretrain.yaml")
BATCH = 4
TINY = [
    "model.language.args.hidden_size=64",
    "model.language.args.num_hidden_layers=1",
    "model.language.args.num_attention_heads=4",
    "model.vision.args.hidden_size=64", "model.vision.args.num_layers=1",
    "model.vision.args.num_attention_heads=4",
    "model.vision.args.dim_feedforward=128",
    "model.grounding.args.hidden_size=64", "model.grounding.args.num_layers=1",
    "model.grounding.args.num_attention_heads=4",
    "model.grounding.args.dim_feedforward=128",
    "model.heads.pretrain_head.args.hidden_size=64",
    "data.args.max_obj_len=4", "data.args.num_points=64",
    "data.args.max_seq_len=16", "data.args.max_scene_cap_len=16",
    "model.lm_max_predictions=4", "model.split_scene_cap_tower=True",
    f"dataloader.batchsize={BATCH}", "solver.sched.args.warmup_steps=0",
    "solver.optim.args.eps=1e-6", "device=cpu",
]
STEP = TINY + [f"data.synthetic_size={BATCH}", "solver.epochs=1"]
# route: (overrides, environment for the route alone)
FUSED_ENV = {"SCENEVERSE_BN_FOLD": "on", "SCENEVERSE_SA_TRAIN_FUSED": "on"}
ROUTES = {
    "frozen": ([], {}),
    "unfrozen": (["model.vision.args.freeze=False"], {}),
    "unfrozen_folded": (["model.vision.args.freeze=False"],
                        {"SCENEVERSE_BN_FOLD": "on"}),
    "unfrozen_fused": (["model.vision.args.freeze=False"], FUSED_ENV),
}
N_EVAL = 7  # items of the evaluator case: shards of 4 and 3 over 2 ranks


@contextlib.contextmanager
def gates(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def no_dropout(model):
    from sceneverse_tpu_torch.modules.utils import Dropout

    for m in model.modules():
        if isinstance(m, (Dropout, torch.nn.Dropout)):
            m.p = 0.0


def _cfg(over):
    from sceneverse_tpu_torch.config import load_config

    return load_config(CFG, list(over))


# ------------------------------------------------------------------ routes
def route_step(name, exp_dir, weights=None):
    """One train step of ``DefaultTrainer.train_step`` on the route: the
    logged (global) losses and metrics, the gradients the optimizer took
    (summed over the ranks, then clipped), the parameters after the AdamW
    step and the buffers (BatchNorm running statistics)."""
    from sceneverse_tpu_torch.ckpt.convert import apply_state_dict
    from sceneverse_tpu_torch.trainer.build import build_trainer

    over, env = ROUTES[name]
    with gates(env):
        t = build_trainer(_cfg(STEP + over + [f"exp_dir={exp_dir}"]))
        if weights is not None:
            _, missing, unexpected = apply_state_dict(
                t.model, torch.load(weights, weights_only=True))
            assert not unexpected and all(
                k.endswith("num_batches_tracked") for k in missing)
        no_dropout(t.model)
        t.train_step(0)
    assert t.global_step == 1
    lrs = {id(p): g["base_lr"] for g in t.optimizer.opt.param_groups
           for p in g["params"]}
    return {"row": t.history["train"][0],
            "lr": {n: lrs.get(id(p)) for n, p in t.model.named_parameters()},
            "grad": {n: p.grad.clone() for n, p in t.model.named_parameters()
                     if p.grad is not None},
            "param": {n: p.detach().clone()
                      for n, p in t.model.named_parameters()},
            "buffer": {n: b.clone() for n, b in t.model.named_buffers()}}


# ------------------------------------------------------------------ losses
def _loss_inputs():
    """A global batch of 4 whose rows 0-1 (rank 0) mask many tokens and
    objects and rows 2-3 (rank 1) few."""
    rng = np.random.RandomState(3)
    B, L, V, O, C, D = BATCH, 12, 50, 6, 9, 8
    lm = np.where(rng.rand(B, L) < np.array([[0.8], [0.7], [0.1], [0.2]]),
                  rng.randint(0, V, (B, L)), -1)
    lm[3, :] = -1
    lm[3, 0] = 5
    obj_masks = rng.rand(B, O) < np.array([[0.9], [1.0], [0.2], [0.3]])
    obj_masks[:, :3] = True  # the targets' slots
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return {
        "masked_lm_labels": lm, "txt_lm_cls_logits": f(B, L, V),
        "obj_labels": np.where(obj_masks, rng.randint(0, C, (B, O)), -100),
        "obj_masks": obj_masks, "obj_sem_masks": rng.rand(B, O) < 0.5,
        "obj_cls_raw_logits": f(B, O, C), "obj_cls_post_logits": f(B, O, C),
        "og3d_logits": f(B, O), "tgt_object_id": rng.randint(0, 3, (B, 1)),
        "intra_obj_embeds": f(B, O, D), "intra_text_embed": f(B, D),
        "inter_obj_embeds": f(B, O, D), "inter_text_embed": f(B, D),
        "scene_embed": f(B, D), "scene_text_embed": f(B, D),
        "answer_scores": f(B, 5),
        "answer_label": (rng.rand(B, 5) < 0.3).astype(np.float32),
    }


LOSSES = ["lm_cls_loss", "obj_cls_raw_loss", "obj_cls_post_loss_mask",
          "og3d_loss", "answer_loss", "TextObjWithinBatch",
          "TextObjBetweenBatch", "TextSceneBetweenBatch"]


def loss_cases():
    """Per loss: (the sum of the ranks' shares, the gradient of this rank's
    rows of each float input)."""
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.optim.loss import contra_loss
    from sceneverse_tpu_torch.optim.loss import loss as L
    from sceneverse_tpu_torch.parallel import mesh

    rows = mesh.rank_rows(BATCH, mesh.world(), mesh.rank())
    out = {}
    for name in LOSSES:
        d = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).requires_grad_(
                v.dtype == np.float32 and not k.startswith("answer_label"))
             for k, v in _loss_inputs().items()}
        fn = L._FUNCTIONAL.get(name) or getattr(contra_loss, name)(
            Config({"task": "Pretrain"}))
        share = fn(d)
        share.backward()
        out[name] = (float(mesh.all_reduce_sum(share.detach())),
                     {k: v.grad for k, v in d.items() if v.grad is not None})
    return out


# -------------------------------------------------------------- evaluators
def _eval_items():
    rng = np.random.RandomState(5)
    n, O, C, L, V = N_EVAL, 5, 4, 6, 7
    masks = rng.rand(n, O) < 0.8
    masks[:, 0] = True
    return {
        "og3d_logits": rng.randn(n, O).astype(np.float32),
        "tgt_object_id": rng.randint(0, O, (n, 1)),
        "tgt_object_id_iou25": (rng.rand(n, O) < 0.5).astype(np.int64),
        "tgt_object_id_iou50": (rng.rand(n, O) < 0.3).astype(np.int64),
        "is_multiple": rng.rand(n) < 0.4,
        "obj_labels": np.where(masks, rng.randint(0, C, (n, O)), -100),
        "obj_masks": masks, "obj_sem_masks": rng.rand(n, O) < 0.5,
        "obj_boxes": rng.randn(n, O, 6).astype(np.float32),
        "obj_cls_raw_logits": rng.randn(n, O, C).astype(np.float32),
        "obj_cls_post_logits": rng.randn(n, O, C).astype(np.float32),
        "masked_lm_labels": np.where(rng.rand(n, L) < 0.4,
                                     rng.randint(0, V, (n, L)), -1),
        "txt_lm_cls_logits": rng.randn(n, L, V).astype(np.float32),
        "data_idx": np.arange(100, 100 + n),
    }


def eval_batches(n_world, r):
    """Rank r's shard of the evaluator items in batches of 2."""
    from sceneverse_tpu_torch.data.sharding import shard_indices

    idx, _ = shard_indices(N_EVAL, n_world, r)
    return [idx[i:i + 2] for i in range(0, len(idx), 2)]


def eval_record(batches, exp_dir):
    """``record()`` of PretrainEval and ScanReferEval (with ``eval.save``)
    after ``update`` on ``batches``; and the rows rank 0 saved."""
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.evaluator.build import get_eval
    from sceneverse_tpu_torch.parallel import mesh

    cfg = Config({"eval": {"save": True}, "exp_dir": str(exp_dir)})
    items = _eval_items()
    out = {}
    for name in ("PretrainEval", "ScanReferEval"):
        ev = get_eval(name, cfg)
        for idx in batches:
            ev.update({k: torch.from_numpy(v[idx]) for k, v in items.items()})
        out[name] = ev.record()[1]
    path = Path(exp_dir) / "eval_results" / "ScanReferEval" / "results.json"
    out["rows"] = json.loads(path.read_text()) if mesh.rank() == 0 else None
    return out


# ----------------------------------------------------------------- loaders
def loader_batches(over=()):
    """data_idx and obj_fts of the two train batches of an epoch of 8
    items, and the data_idx of the val loader (7 items)."""
    from sceneverse_tpu_torch.data.build import build_dataloader

    cfg = _cfg(TINY + ["data.synthetic_size=8", *over])
    train = [(b["data_idx"], b["obj_fts"])
             for b in build_dataloader(cfg, "train")]
    cfg = _cfg(TINY + [f"data.synthetic_size={N_EVAL}", *over])
    val = [b["data_idx"] for b in build_dataloader(cfg, "val")]
    return {"train": train, "val": val}


def materialized_cfg(root, store_root):
    """A fixture tree's ScanNet refer family through the materialized
    batch loader (``data.args.materialized: fast``)."""
    from sceneverse_tpu_torch.config import Config

    src = {"sources": ["anno", "rel2_template", "relm_gpt"]}
    data = {"args": {"max_obj_len": 5, "max_seq_len": 16, "num_points": 32,
                     "pc_type": "gt", "sem_type": "607", "filter_lang": False,
                     "txt_mask_ratio": 0.15, "pc_mask_ratio": 0.1,
                     "rot_aug": True, "mask_strategy": "random",
                     "use_scene_cap": True, "max_scene_cap_len": 24,
                     "materialized": "fast",
                     "materialized_root": str(store_root)},
            "scan_family_base": str(root), "train": ["ScanNetSpatialRefer"],
            "ScanNetSpatialRefer": {"train": src}}
    return Config({"rng_seed": 7, "num_gpu": 1,
                   "debug": {"flag": False, "debug_size": -1}, "data": data,
                   "data_wrapper": {"train": "MaskDatasetWrapper"},
                   "dataloader": {"batchsize": BATCH, "num_workers": 0}})


def materialized_batches(root, store_root, n=2):
    from sceneverse_tpu_torch.data.build import build_dataloader

    out = []
    for b in build_dataloader(materialized_cfg(root, store_root), "train"):
        out.append({k: np.array(v) for k, v in b.items()})
        if len(out) == n:
            break
    return out


# ------------------------------------------------------------- entry point
ENTRY = TINY + ["data.synthetic_size=8", "solver.epochs_per_save=1",
                "solver.log_every=1"]


def entry_runs(exp_dir):
    """``run_torch.main`` for epoch 1 (2 steps, ``ckpt_1.pth``), then again
    with ``resume=True`` for epoch 2; this rank's checkpoint writes and its
    resumed state."""
    import run_torch
    from sceneverse_tpu_torch.ckpt import checkpoint

    writes = []
    real = checkpoint._write
    checkpoint._write = lambda state, path: (writes.append(path.name),
                                             real(state, path))
    try:
        args = ["--config-path", os.path.dirname(CFG), "--config-name",
                "synthetic_pretrain", *ENTRY, f"exp_dir={exp_dir}"]
        first = run_torch.main(args + ["solver.epochs=1"])["trainer"]
        second = run_torch.main(args + ["solver.epochs=2", "resume=True"])
    finally:
        checkpoint._write = real
    t = second["trainer"]
    return {"writes": writes, "resumed_from": str(t.resumed_from),
            "steps": [len(first.history["train"]),
                      len(t.history["train"])],
            "state": {k: v.clone() for k, v in t.model.state_dict().items()},
            "step_count": t.optimizer.step_count}


# ------------------------------------------------------------------ a rank
def run(r, n_world, init_file, spec):
    """Rank ``r`` of a gloo world of ``n_world``: every case above; the
    results go to ``<out>/rank<r>.pt``."""
    os.environ.update({"RANK": str(r), "WORLD_SIZE": str(n_world),
                       "LOCAL_RANK": str(r), "SCENEVERSE_FUSED_MHA": "off"})
    torch.set_num_threads(2)
    from sceneverse_tpu_torch.parallel import mesh

    assert mesh.init_from_env("gloo", init_method=f"file://{init_file}")
    out = Path(spec["out"])
    res = {"world": mesh.world(), "rank": mesh.rank(), "routes": {}}
    res["losses"] = loss_cases()
    res["eval"] = eval_record(eval_batches(n_world, r), out / "eval")
    res["loaders"] = loader_batches()
    res["materialized"] = materialized_batches(spec["tree"],
                                               out / "stores")
    res["entry"] = entry_runs(out / "entry")
    for name in ("unfrozen", "unfrozen_folded", "unfrozen_fused", "frozen"):
        # the frozen route takes the JAX model's weights, which the test
        # process writes while the cases above run
        weights = Path(spec["weights"]) if name == "frozen" else None
        while weights is not None and not weights.exists():
            time.sleep(0.1)
        res["routes"][name] = route_step(name, out / f"route_{name}",
                                         weights)
    torch.save(res, out / f"rank{r}.pt")
    mesh.shutdown()

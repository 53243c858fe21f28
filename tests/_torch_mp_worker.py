"""Runs of the port over a dp x mp grid, shared by ``tests/test_torch_mp.py``
and the four ranks it spawns: each function runs the same code in a world
of 1 (the test process, no process group) and in each rank of a gloo world
of 4 (``run``, a spawned process). Imports no JAX, so that a rank starts
fast.

Setup: ``synthetic_pretrain.yaml`` at ``tests/test_multichip.py::_small_cfg``'s
widths (hidden 96, 2 layers, 4 heads, feed-forward 128, V = 1024), 8
objects x 128 points, 16 + 16 tokens, global batch 8, AdamW eps 1e-6, no
warmup, ``solver.grad_norm`` = CLIP (the clip engages), the frozen
PointNet++, the JAX model's weights through ``pretrain_ckpt_path``,
dropout off unless a case says otherwise, ``SCENEVERSE_FUSED_MHA=off``.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from _torch_ddp_worker import CFG, _cfg, no_dropout  # noqa: E402,F401

WORLD = 4
BATCH = 8
VOCAB = 1024
# below the step's gradient norm (0.49992 with the JAX weights), so the
# clip engages
CLIP = 0.1
SMALL = [
    "model.language.args.hidden_size=96",
    "model.language.args.num_hidden_layers=2",
    "model.language.args.num_attention_heads=4",
    "model.vision.args.hidden_size=96", "model.vision.args.num_layers=2",
    "model.vision.args.num_attention_heads=4",
    "model.vision.args.dim_feedforward=128",
    "model.grounding.args.hidden_size=96",
    "model.grounding.args.num_layers=2",
    "model.grounding.args.num_attention_heads=4",
    "model.grounding.args.dim_feedforward=128",
    "model.heads.pretrain_head.args.hidden_size=96",
    f"model.heads.pretrain_head.args.vocab_size={VOCAB}",
    "data.args.max_obj_len=8", "data.args.num_points=128",
    "data.args.max_seq_len=16", "data.args.max_scene_cap_len=16",
    "model.lm_max_predictions=16", "model.split_scene_cap_tower=True",
    f"dataloader.batchsize={BATCH}", f"data.synthetic_size={BATCH}",
    "solver.epochs=1", "solver.sched.args.warmup_steps=0",
    "solver.optim.args.eps=1e-6", f"solver.grad_norm={CLIP}", "device=cpu",
]
# case: (mp, overrides); "v1023" has a vocabulary that mp = 2 does not
# divide (its head stays whole), "dropout" keeps every dropout on
CASES = {
    "dp2_mp2": (2, []),
    "dp1_mp4": (4, []),
    "v1023": (2, ["model.heads.pretrain_head.args.vocab_size=1023"]),
    "dropout": (2, []),
}
HEAD = "pretrain_head.lm_pred_head."


def overrides(case, mp, exp_dir, weights):
    return SMALL + CASES[case][1] + [
        f"parallel.mp={mp}", f"exp_dir={exp_dir}",
        f"pretrain_ckpt_path={weights}"]


def step(case, mp, exp_dir, weights, eval_val=True):
    """One ``train_step`` (and the val pass) of the case at ``mp``: the
    logged losses, the clipped gradients and the parameters after AdamW
    with the split head gathered whole, this rank's rows of the head, the
    replicated gradients the mp broadcast was handed, the dropout streams'
    states and the val metrics; and the trainer."""
    from sceneverse_tpu_torch.parallel import mesh, vocab
    from sceneverse_tpu_torch.trainer.build import build_trainer

    t = build_trainer(_cfg(overrides(case, mp, exp_dir, weights)))
    if case != "dropout":
        no_dropout(t.model)
    handed = {}
    bcast = mesh.broadcast_flat_mp

    def keep(tensors):
        handed["grads"] = [g.clone() for g in tensors]
        bcast(tensors)

    mesh.broadcast_flat_mp = keep
    try:
        t.train_step(0)
    finally:
        mesh.broadcast_flat_mp = bcast
    assert t.global_step == 1

    def whole(x, p):  # gathered whole when p is split
        return vocab.full_tensor(x) if vocab.is_split(p) else x.detach()

    named = list(t.model.named_parameters())
    lrs = {id(p): g["base_lr"] for g in t.optimizer.opt.param_groups
           for p in g["params"]}
    out = {
        "row": t.history["train"][0],
        "lr": {n: lrs.get(id(p)) for n, p in named},
        "moments": {n: {k: whole(v, p).clone() for k, v in m.items()}
                    for n, (p, m) in moments(t).items()},
        "grad": {n: whole(p.grad, p).clone() for n, p in named
                 if p.grad is not None},
        "param": {n: whole(p, p).clone() for n, p in named},
        "shard": {n: p.detach().clone() for n, p in named
                  if vocab.is_split(p)},
        "split": list(t.vocab_split),
        "handed": handed.get("grads"),
        "gens": [g.get_state() for g in _generators(t.model)],
        "grid": (mesh.dp_world(), mesh.mp_world(), mesh.dp_rank(),
                 mesh.mp_rank()),
    }
    if eval_val:
        out["val"] = t._eval_loop("val", "val")[1]
    return out, t


def moments(t) -> dict:
    """``{name: (parameter, its AdamW moments)}`` (a split parameter's
    rows)."""
    names = {id(p): n for n, p in t.model.named_parameters()}
    return {names[id(p)]: (p, {k: v for k, v in s.items()
                               if torch.is_tensor(v) and v.dim()})
            for p, s in t.optimizer.opt.state.items()}


def _generators(model):
    from sceneverse_tpu_torch.modules.utils import _streams

    return _streams(model)


def checkpoint_state(path) -> dict:
    from sceneverse_tpu_torch.ckpt.checkpoint import load_checkpoint

    return load_checkpoint(path)


def resumed(mp, exp_dir, weights, ckpt):
    """A trainer at ``mp`` resumed from ``ckpt``: its parameters (this
    rank's rows of a split one), its AdamW moments by parameter name, and
    the checkpoint it writes back at once."""
    from sceneverse_tpu_torch.trainer.build import build_trainer

    cfg = _cfg(overrides("dp2_mp2", mp, exp_dir, weights)
               + ["resume=True", f"ckpt_path={ckpt}"])
    t = build_trainer(cfg)
    assert t.resumed_from is not None
    held = {n: {k: v.clone() for k, v in m.items()}
            for n, (_, m) in moments(t).items()}
    t.ckpt_path = Path(exp_dir)
    t.save("again.pth")
    return {"param": {n: p.detach().clone()
                      for n, p in t.model.named_parameters()},
            "moments": held, "split": list(t.vocab_split)}


ACCUM = ["solver.gradient_accumulation_steps=2"]


def accumulated(mp, exp_dir, weights):
    """One micro-step of two at ``mp`` (dropout off), then a checkpoint
    (``accum.pth``) with the running gradient mean in it; this rank's
    mean."""
    from sceneverse_tpu_torch.trainer.build import build_trainer

    t = build_trainer(_cfg(overrides("dp2_mp2", mp, exp_dir, weights)
                           + ACCUM))
    no_dropout(t.model)
    t.train_step(0)
    assert t.optimizer.mini_step == 1
    t.ckpt_path = Path(exp_dir)
    t.save("accum.pth")
    return [a.clone() for a in t.optimizer.acc]


def _wait(path):
    while not Path(path).exists():
        time.sleep(0.1)


def run(r, n_world, init_file, spec):
    """Rank ``r`` of a gloo world of ``n_world``: every case above, at
    (dp 2, mp 2) and (dp 1, mp 4) in the same world; the results go to
    ``<out>/rank<r>.pt``."""
    os.environ.update({"RANK": str(r), "WORLD_SIZE": str(n_world),
                       "LOCAL_RANK": str(r), "SCENEVERSE_FUSED_MHA": "off"})
    torch.set_num_threads(1)
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.parallel import mesh

    assert mesh.init_from_env("gloo", init_method=f"file://{init_file}")
    out = Path(spec["out"])
    _wait(spec["weights"])
    res = {"world": mesh.world(), "rank": mesh.rank(), "cases": {}}
    for case, (mp, _) in CASES.items():
        got, t = step(case, mp, out / f"{case}_w4", spec["weights"],
                      eval_val=case != "dropout")
        res["cases"][case] = got
        if case == "dp2_mp2":
            t.ckpt_path = out / "mp2_ckpt"
            t.save("mp2.pth")  # read back at mp 1 by the test process
        del t
    # dp 1 x mp 4: every rank's running mean is the global batch's
    res["accum"] = accumulated(4, out / "accum_w4", spec["weights"])
    try:
        mesh.setup_grid(Config({"parallel": {"mp": 3}}))
    except ValueError as e:
        res["mp3_error"] = str(e)
    _wait(spec["mp1_ckpt"])  # written at mp 1 by the test process
    res["resumed"] = resumed(2, out / "resume_w4", spec["weights"],
                             spec["mp1_ckpt"])
    torch.save(res, out / f"rank{r}.pt")
    mesh.shutdown()

"""Gradient accumulation over a dp group, saved inside a group and resumed:
the run shared by ``tests/test_torch_trainer_accum.py`` (a world of 1, in
the test process) and the two gloo ranks it spawns (``run``). Imports no
JAX, so that a rank starts fast.

Setup: ``_torch_ddp_worker``'s tiny ``synthetic_pretrain.yaml`` (hidden 64,
1 layer, global batch 4: 2 rows a rank), k = 2, 12 items (3 micro-steps an
epoch), dropout off, ``SCENEVERSE_FUSED_MHA=off``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from _torch_ddp_worker import BATCH, TINY, _cfg, no_dropout  # noqa: E402

WORLD = 2
OVER = TINY + ["solver.gradient_accumulation_steps=2", "solver.epochs=2",
               f"data.synthetic_size={3 * BATCH}"]


def interrupted(exp_dir) -> dict:
    """Trainer ``a`` takes 3 micro-steps (one update, then half a group)
    and saves ``latest.pth``; trainer ``b`` resumes from it. Both take the
    group's second micro-step on the same batch. Returns a's running mean
    before the save, the saved mean, and both trainers' parameters and
    counters at the save and after the group."""
    from sceneverse_tpu_torch.ckpt.checkpoint import load_checkpoint
    from sceneverse_tpu_torch.trainer.build import build_trainer, to_device

    over = OVER + [f"exp_dir={exp_dir}"]
    a = build_trainer(_cfg(over))
    no_dropout(a.model)
    a.train_step(0)
    assert (a.optimizer.step_count, a.optimizer.mini_step) == (1, 1)
    own = [x.clone() for x in a.optimizer.acc]
    a.exp_tracker.step()
    a.save("latest.pth")
    saved = load_checkpoint(a.ckpt_path / "latest.pth")["optimizer"]["acc"]

    b = build_trainer(_cfg(over + ["resume=True"]))
    no_dropout(b.model)
    assert b.resumed_from == a.ckpt_path / "latest.pth"

    def params(t):
        return {n: p.detach().clone() for n, p in t.model.named_parameters()}

    before = params(a)
    batch = next(iter(a.data_loaders["train"]))
    for t in (a, b):
        t.train_forward_backward(to_device(batch, "cpu"))
    return {"own": own, "saved": saved, "before": before, "a": params(a),
            "b": params(b),
            "steps": [(t.optimizer.step_count, t.optimizer.mini_step)
                      for t in (a, b)]}


def run(r, n_world, init_file, out_dir):
    """Rank ``r`` of a gloo world of ``n_world``; its results go to
    ``<out_dir>/rank<r>.pt``."""
    os.environ.update({"RANK": str(r), "WORLD_SIZE": str(n_world),
                       "LOCAL_RANK": str(r), "SCENEVERSE_FUSED_MHA": "off"})
    torch.set_num_threads(1)
    from sceneverse_tpu_torch.parallel import mesh

    assert mesh.init_from_env("gloo", init_method=f"file://{init_file}")
    res = interrupted(Path(out_dir) / "w2")
    res["world"] = (mesh.world(), mesh.rank())
    torch.save(res, Path(out_dir) / f"rank{r}.pt")
    mesh.shutdown()

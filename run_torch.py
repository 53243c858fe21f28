"""Experiment entry point of the PyTorch/CUDA port (sceneverse_tpu_torch),
with run.py's surface.

Usage:
    python run_torch.py --config-path configs/final \
        --config-name synthetic_pretrain [key.sub=value ...]
    torchrun --nproc_per_node=N run_torch.py --config-path configs/final \
        --config-name all_pretrain [key.sub=value ...]

Loads the YAML config with dotted overrides (with ``resume=True`` and an
``exp_dir``, the config snapshotted there, as run.py does), names and
creates the experiment directory from ``naming_keywords``, snapshots the
resolved config, builds the port's trainer, runs it and waits for its
checkpoint writes. The trainer runs on the CUDA
card, and raises when there is none, unless ``device=cpu`` asks for the CPU.
Imports nothing of JAX or of the JAX package.

Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) each process joins one process group
and runs one trainer on ``cuda:LOCAL_RANK`` over its rows of the global
batch ``dataloader.batchsize`` (``sceneverse_tpu_torch/parallel/mesh.py``).
The backend is ``nccl`` on CUDA and ``gloo`` with ``device=cpu``;
``dist_backend=`` names another (``gloo`` runs several ranks on one card,
which NCCL refuses). A failed init raises; nothing falls back. The ranks
take rank 0's ``exp_dir``, rank 0 writes the config snapshot, and the
process group ends with the run. A process group made by the caller is
used as it is and left open.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="sceneverse_tpu_torch runner")
    parser.add_argument("--config-path", default="configs")
    parser.add_argument("--config-name", default="default")
    parser.add_argument("overrides", nargs="*", help="key.sub=value overrides")
    return parser.parse_args(argv)


def compose_exp_name(cfg) -> str:
    parts = [str(cfg.get("name", "exp"))]
    for kw in cfg.get("naming_keywords", []) or []:
        if kw == "time":
            parts.append(datetime.now().strftime("%Y%m%d-%H%M%S"))
        elif kw == "task":
            parts.append(str(cfg.get("task", "")))
        else:
            val = cfg.select(kw)
            if val is not None:
                parts.append(f"{kw.split('.')[-1]}{val}")
    return "_".join(p for p in parts if p)


def load_cfg(argv=None):
    """The resolved config of a command line (YAML + overrides), with
    ``exp_dir`` named from ``naming_keywords`` unless given."""
    from sceneverse_tpu_torch.config import load_config

    args = parse_args(argv)
    name = args.config_name
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    cfg_file = Path(args.config_path) / name
    if not cfg_file.exists():
        raise FileNotFoundError(f"{cfg_file} not found")
    cfg = load_config(str(cfg_file), args.overrides)
    if cfg.get("resume", False) and cfg.get("exp_dir"):
        saved = Path(cfg.exp_dir) / "config.yaml"
        if saved.exists():  # the run's own config (reference run.py:14-18)
            cfg = load_config(str(saved), args.overrides)
            cfg.resume = True
    if not cfg.get("exp_dir"):
        base = cfg.get("base_dir") or "outputs"
        cfg.exp_dir = str(Path(base) / compose_exp_name(cfg))
    return cfg


def dist_backend(cfg) -> str:
    if cfg.get("dist_backend"):
        return str(cfg.dist_backend)
    return "gloo" if str(cfg.get("device") or "cuda").startswith(
        "cpu") else "nccl"


def main(argv=None):
    from sceneverse_tpu_torch.config import save_config
    from sceneverse_tpu_torch.parallel import mesh

    cfg = load_cfg(argv)
    made = mesh.init_from_env(dist_backend(cfg))
    try:
        cfg.exp_dir = mesh.all_gather_objects(cfg.exp_dir, "world")[0]
        if mesh.rank() == 0:
            os.makedirs(cfg.exp_dir, exist_ok=True)
            save_config(cfg, str(Path(cfg.exp_dir) / "config.yaml"))

        from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints
        from sceneverse_tpu_torch.trainer.build import build_trainer

        trainer = build_trainer(cfg)
        print(f"[run_torch] trainer {type(trainer).__name__} on "
              f"{trainer.device}, rank {mesh.rank()} of {mesh.world()}, "
              f"exp_dir {cfg.exp_dir}", flush=True)
        results = trainer.run()
        wait_for_checkpoints()
    finally:
        if made:
            mesh.shutdown()
    return {"results": results, "trainer": trainer}


if __name__ == "__main__":
    out = main()
    print({k: round(float(v), 6) for k, v in out["results"].items()})

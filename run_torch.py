"""Experiment entry point of the PyTorch/CUDA port (sceneverse_tpu_torch),
with run.py's surface.

Usage:
    python run_torch.py --config-path configs/final \
        --config-name synthetic_pretrain [key.sub=value ...]

Loads the YAML config with dotted overrides, names and creates the
experiment directory from ``naming_keywords``, snapshots the resolved
config, builds the port's trainer and runs it. The trainer runs on the CUDA
card, and raises when there is none, unless ``device=cpu`` asks for the CPU.
Imports nothing of JAX or of the JAX package.
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
    if not cfg.get("exp_dir"):
        base = cfg.get("base_dir") or "outputs"
        cfg.exp_dir = str(Path(base) / compose_exp_name(cfg))
    return cfg


def main(argv=None):
    from sceneverse_tpu_torch.config import save_config

    cfg = load_cfg(argv)
    os.makedirs(cfg.exp_dir, exist_ok=True)
    save_config(cfg, str(Path(cfg.exp_dir) / "config.yaml"))

    from sceneverse_tpu_torch.trainer.build import build_trainer

    trainer = build_trainer(cfg)
    print(f"[run_torch] trainer {type(trainer).__name__} on {trainer.device}, "
          f"exp_dir {cfg.exp_dir}", flush=True)
    results = trainer.run()
    return {"results": results, "trainer": trainer}


if __name__ == "__main__":
    out = main()
    print({k: round(float(v), 6) for k, v in out["results"].items()})

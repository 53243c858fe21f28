"""Metrics logging: one JSON line per ``log`` call in
``<exp_dir>/metrics.jsonl``, and wandb as well when it is importable and
``logger.name`` is ``wandb``.

The port's own copy of ``sceneverse_tpu/utils/logger.py::MetricsLogger``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, cfg, exp_name: str = ""):
        self.enabled = not bool(cfg.select("debug.hard_debug", False))
        exp_dir = cfg.get("exp_dir") or "."
        self.path = Path(exp_dir) / "metrics.jsonl"
        self._fh = None
        self._wandb = None
        if self.enabled:
            os.makedirs(exp_dir, exist_ok=True)
            self._fh = self.path.open("a")
            if cfg.select("logger.name") == "wandb":
                try:
                    import wandb

                    self._wandb = wandb.init(
                        project=cfg.get("name", "sceneverse_tpu"),
                        name=exp_name or None,
                        config=cfg.to_dict(),
                        resume=bool(cfg.get("resume", False)),
                    )
                except Exception:
                    self._wandb = None

    def log(self, metrics: dict, step: int | None = None):
        if not self.enabled:
            return
        row = {"_ts": time.time()}
        if step is not None:
            row["_step"] = step
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._fh:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()

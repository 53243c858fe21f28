"""Evaluator protocol (port of sceneverse_tpu/evaluator/build.py):
``batch_metrics`` returns ``{name: (value, count)}`` with ``include_count``
(device tensors, no host sync), ``update`` accumulates, ``record``
ratio-reduces on the host once and tracks the best ``target_metric``.
With ``eval.save`` an evaluator gathers per-item rows in ``eval_results``
and ``record`` writes them to
``<exp_dir>/eval_results/<Evaluator>/results.json`` (JAX
``evaluator/build.py:64-73,109-111``)."""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from sceneverse_tpu_torch.registry import Registry

EVALUATOR_REGISTRY = Registry("EVALUATOR")


def ratio_metrics(metrics: dict, floor: float = 1.0) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32)
            / torch.as_tensor(c, dtype=torch.float32).clamp_min(floor)
            for k, (v, c) in metrics.items()}


class BaseEvaluator:
    target_metric = "target_metric"

    def __init__(self, cfg, **kwargs):
        self.cfg = cfg
        self.best_result = -math.inf
        self.save = bool(cfg.select("eval.save", False))
        exp_dir = cfg.get("exp_dir") or "."
        self.save_dir = Path(exp_dir) / "eval_results" / type(self).__name__
        if self.save:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.reset()

    def reset(self):
        self.eval_results = []
        self.eval_dict = {}

    def batch_metrics(self, data_dict, include_count=False):
        raise NotImplementedError

    def update(self, data_dict):
        for key, (value, count) in self.batch_metrics(
                data_dict, include_count=True).items():
            acc = self.eval_dict.setdefault(key, [0.0, 0.0])
            acc[0] = acc[0] + value
            acc[1] = acc[1] + count

    def record(self):
        out = {k: float(v) / max(float(c), 1.0)
               for k, (v, c) in self.eval_dict.items()}
        if self.save:
            with (self.save_dir / "results.json").open("w") as f:
                json.dump(self.eval_results, f)
        out["target_metric"] = out[self.target_metric]
        is_best = out["target_metric"] > self.best_result
        if is_best:
            self.best_result = out["target_metric"]
        out["best_result"] = self.best_result
        self.eval_dict = out
        return is_best, out


def get_eval(name, cfg, **kwargs):
    from sceneverse_tpu_torch.evaluator import pretrain_eval, scanrefer_eval

    del pretrain_eval, scanrefer_eval
    return EVALUATOR_REGISTRY.get(name)(cfg, **kwargs)


def build_eval(cfg, **kwargs):
    """JAX ``evaluator/build.py:128-140``: the {"train", "val"} dict or one
    evaluator by ``eval.name`` (the per-val-dataset form is not ported)."""
    if cfg.select("eval.train") is not None:
        return {"train": get_eval(cfg.eval.train.name, cfg, **kwargs),
                "val": get_eval(cfg.eval.val.name, cfg, **kwargs)}
    if cfg.select("eval.name") is not None:
        return get_eval(cfg.eval.name, cfg, **kwargs)
    raise NotImplementedError(
        "the per-val-dataset evaluators are not ported yet")

"""Evaluator protocol (port of sceneverse_tpu/evaluator/build.py):
``batch_metrics`` returns ``{name: (value, count)}`` with ``include_count``
(device tensors, no host sync), ``update`` accumulates, ``record``
ratio-reduces on the host once and tracks the best ``target_metric``."""

from __future__ import annotations

import numpy as np
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
        self.best_result = -np.inf
        if cfg.select("eval.save", False):
            raise NotImplementedError("eval.save is not ported yet")
        self.reset()

    def reset(self):
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
        out["target_metric"] = out[self.target_metric]
        is_best = out["target_metric"] > self.best_result
        if is_best:
            self.best_result = out["target_metric"]
        out["best_result"] = self.best_result
        self.eval_dict = out
        return is_best, out


def build_eval(cfg, **kwargs):
    if cfg.select("eval.train") is None:
        raise NotImplementedError("only the train/val evaluator dict is ported")
    from sceneverse_tpu_torch.evaluator import pretrain_eval, scanrefer_eval

    del pretrain_eval, scanrefer_eval
    return {"train": EVALUATOR_REGISTRY.get(cfg.eval.train.name)(cfg),
            "val": EVALUATOR_REGISTRY.get(cfg.eval.val.name)(cfg)}

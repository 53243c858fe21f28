"""Evaluator protocol (port of sceneverse_tpu/evaluator/build.py):
``batch_metrics`` returns ``{name: (value, count)}`` with ``include_count``
(device tensors, no host sync), ``update`` accumulates, ``record``
sums every (value, count) over the dp group of a data-parallel world
(JAX ``evaluator/build.py:48-53,105-107``: each dp rank evaluated its own
shard, ``data/sharding.py``; its mp peers the same one), ratio-reduces on
the host once and tracks the best ``target_metric``. ``update_sums``
takes (value, count) sums already reduced over a group of batches (the
trainer's fused eval, ``trainer/build.py::eval_fused``). ``JIT_METRICS``
marks an evaluator whose ``batch_metrics`` is tensor math with no host
read, which the trainer may run inside a CUDA graph of its train step or
eval group (JAX ``evaluator/build.py:60-63``); with ``eval.save`` it is not
fused either, as in JAX. With ``eval.save``
an evaluator gathers per-item rows in ``eval_results`` and ``record``
writes every dp rank's, in dp order (the shards' order), to ``<exp_dir>/eval_results/<Evaluator>/results.json`` on
rank 0 (JAX ``evaluator/build.py:64-73,109-111``)."""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from sceneverse_tpu_torch.common.misc import gather_dict
from sceneverse_tpu_torch.parallel import mesh
from sceneverse_tpu_torch.registry import Registry

EVALUATOR_REGISTRY = Registry("EVALUATOR")


def ratio_metrics(metrics: dict, floor: float = 1.0) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32)
            / torch.as_tensor(c, dtype=torch.float32).clamp_min(floor)
            for k, (v, c) in metrics.items()}


class BaseEvaluator:
    target_metric = "target_metric"
    JIT_METRICS = False

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
        self.update_sums(self.batch_metrics(data_dict, include_count=True))

    def update_sums(self, metrics):
        """Accumulate (value, count) pairs: one batch's, or the sums of a
        fused eval group (JAX ``evaluator/build.py:94-101``)."""
        for key, (value, count) in metrics.items():
            acc = self.eval_dict.setdefault(key, [0.0, 0.0])
            acc[0] = acc[0] + value
            acc[1] = acc[1] + count

    def record(self):
        keys = list(self.eval_dict)
        host = _fetch([x for k in keys for x in self.eval_dict[k]])
        sums = gather_dict({k: [host[2 * i], host[2 * i + 1]]
                            for i, k in enumerate(keys)})
        out = {k: float(sums[k][0]) / max(float(sums[k][1]), 1.0)
               for k in self.eval_dict}
        if self.save:
            rows = mesh.all_gather_objects(self.eval_results)
            if mesh.rank() == 0:
                with (self.save_dir / "results.json").open("w") as f:
                    json.dump([r for part in rows for r in part], f)
        out["target_metric"] = out[self.target_metric]
        is_best = out["target_metric"] > self.best_result
        if is_best:
            self.best_result = out["target_metric"]
        out["best_result"] = self.best_result
        self.eval_dict = out
        return is_best, out


def _fetch(values) -> list:
    """Host floats of a list of device scalars and numbers, in one copy."""
    dev = [v for v in values if torch.is_tensor(v)]
    if not dev:
        return [float(v) for v in values]
    got = iter(torch.stack([v.detach().double().reshape(())
                            for v in dev]).cpu().tolist())
    return [next(got) if torch.is_tensor(v) else float(v) for v in values]


def get_eval(name, cfg, **kwargs):
    """One evaluator, or a list for a list of names (JAX
    ``evaluator/build.py:119-124``; the package's ``__init__`` registers
    every evaluator)."""
    if isinstance(name, str):
        return EVALUATOR_REGISTRY.get(name)(cfg, **kwargs)
    return [EVALUATOR_REGISTRY.get(n)(cfg, **kwargs) for n in name]


def build_eval(cfg, **kwargs):
    """JAX ``evaluator/build.py:128-139``: the {"train", "val"} dict, one
    evaluator by ``eval.name``, or one per val dataset
    (``data.<dataset>.evaluator``)."""
    if cfg.select("eval.train") is not None:
        return {"train": get_eval(cfg.eval.train.name, cfg, **kwargs),
                "val": get_eval(cfg.eval.val.name, cfg, **kwargs)}
    if cfg.select("eval.name") is not None:
        return get_eval(cfg.eval.name, cfg, **kwargs)
    names = [cfg.data[dataset].evaluator for dataset in cfg.data.val]
    return get_eval(names, cfg, **kwargs)

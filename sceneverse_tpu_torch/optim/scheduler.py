"""LR schedule ratios (port of sceneverse_tpu/optim/scheduler.py); the
warmup is scaled by ``num_gpu`` as in the reference (optim/scheduler.py:21)."""

from __future__ import annotations

import math


def warmup_cosine(step, warmup_step, total_step, minimum_ratio=1e-5, **kw):
    if warmup_step > 0 and step <= warmup_step:
        return step / max(warmup_step, 1)
    denom = max(total_step - warmup_step, 1)
    cos = 0.5 * (1 + math.cos((step - warmup_step) / denom * math.pi))
    return max(cos, minimum_ratio)


def warmup_exp(step, warmup_step, total_step, gamma=0.1, **kw):
    """Linear warmup, then ``gamma ** (step / (total - warmup))``: the
    exponent counts from step 0, not from the warmup's end, as in the
    reference and the JAX package."""
    if warmup_step > 0 and step <= warmup_step:
        return step / max(warmup_step, 1)
    return gamma ** (step * 1.0 / max(total_step - warmup_step, 1))


_SCHEDULES = {"warmup_cosine": warmup_cosine, "warmup_exp": warmup_exp}


def get_schedule_fn(cfg, total_steps):
    """ratio(step) -> LR multiplier."""
    name = cfg.solver.sched.name
    args = dict(cfg.solver.sched.get("args", {}) or {})
    warmup = args.pop("warmup_steps", 0) * cfg.get("num_gpu", 1)
    fn = _SCHEDULES[name]
    return lambda step: fn(step, warmup, total_steps, **args)

"""LR schedule ratios (port of sceneverse_tpu/optim/scheduler.py); the
warmup is scaled by ``num_gpu`` as in the reference (optim/scheduler.py:21)."""

from __future__ import annotations

import math

import torch


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


def warmup_cosine_t(step, warmup_step, total_step, minimum_ratio=1e-5, **kw):
    """``warmup_cosine`` of a float64 step tensor, as tensor ops: the ratio
    stays on the step's device, so an optimizer step reads no host value
    (a CUDA graph replays it with the step it holds)."""
    warm = step / max(warmup_step, 1) if warmup_step > 0 else step * 0.0
    denom = max(total_step - warmup_step, 1)
    cos = 0.5 * (1 + torch.cos((step - warmup_step) / denom * math.pi))
    return torch.where((step <= warmup_step) & (warmup_step > 0), warm,
                       cos.clamp_min(minimum_ratio))


def warmup_exp_t(step, warmup_step, total_step, gamma=0.1, **kw):
    """``warmup_exp`` of a float64 step tensor, as tensor ops."""
    warm = step / max(warmup_step, 1)
    decay = torch.pow(gamma, step / max(total_step - warmup_step, 1))
    return torch.where((step <= warmup_step) & (warmup_step > 0), warm, decay)


_SCHEDULES = {"warmup_cosine": (warmup_cosine, warmup_cosine_t),
              "warmup_exp": (warmup_exp, warmup_exp_t)}


def get_schedule_fn(cfg, total_steps, on_device=False):
    """ratio(step) -> LR multiplier: of a host int (the log rows), or with
    ``on_device`` of a float64 step tensor (the optimizer)."""
    name = cfg.solver.sched.name
    args = dict(cfg.solver.sched.get("args", {}) or {})
    warmup = args.pop("warmup_steps", 0) * cfg.get("num_gpu", 1)
    fn = _SCHEDULES[name][int(on_device)]
    return lambda step: fn(step, warmup, total_steps, **args)

"""Model registry, base and factory (port of sceneverse_tpu/model/build.py;
reference model/build.py:5-18)."""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.registry import Registry

MODEL_REGISTRY = Registry("model")


class BaseModel(nn.Module):
    """Base of the task models.

    ``get_opt_params()`` returns the optimizer group specs
    (``optim/build.py``): ``{"prefix": (attr, ...), "lr": float}``, with an
    optional ``weight_decay`` and ``no_decay_split``; ``frozen_prefixes()``
    the parameter prefixes left out of the optimizer."""

    def get_opt_params(self):
        raise NotImplementedError(
            "Function to obtain all default parameters for optimization")

    def frozen_prefixes(self):
        return []


def build_model(cfg, generator: torch.Generator | None = None) -> nn.Module:
    return MODEL_REGISTRY.get(cfg.model.name)(cfg, generator=generator)

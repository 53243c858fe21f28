"""Mixed-precision output types of LayerNorm and Embedding (the port's
counterpart of ``sceneverse_tpu/utils/precision.py``).

Under ``mixed_precision: bf16`` the JAX package's ``set_compute_dtype``
computes every ``nnx.Embed`` in bf16 and returns every ``nnx.LayerNorm``
output in bf16 (``SCENEVERSE_LN_BF16``, default on), its statistics and
normalisation in f32. ``torch.autocast`` instead runs ``layer_norm`` in f32
and returns f32, and ``nn.Embedding`` returns its weight's f32. The two
subclasses below keep the torch modules' parameters, names and
``isinstance`` identity and apply the JAX rule only under a bf16 autocast
on the input's device; anywhere else they are the torch modules, bit for
bit.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn


def ln_bf16_enabled() -> bool:
    """``SCENEVERSE_LN_BF16`` (default on), read at call time."""
    return os.environ.get("SCENEVERSE_LN_BF16", "on").lower() in (
        "1", "on", "true")


def bf16_autocast(device_type: str) -> bool:
    return (torch.is_autocast_enabled(device_type)
            and torch.get_autocast_dtype(device_type) == torch.bfloat16)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; under a bf16 autocast: statistics and the
    normalisation in f32, output bf16 when ``SCENEVERSE_LN_BF16`` is on."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        if not bf16_autocast(dev):
            return super().forward(x)
        with torch.autocast(dev, enabled=False):
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                             self.bias, self.eps)
        return y.to(torch.bfloat16) if ln_bf16_enabled() else y


class Embedding(nn.Embedding):
    """``nn.Embedding``; under a bf16 autocast it returns bf16(table[ids])."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = super().forward(ids)
        return out.to(torch.bfloat16) if bf16_autocast(ids.device.type) else out

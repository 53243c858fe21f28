"""Memory-lean attention softmax (port of sceneverse_tpu/ops/softmax.py).

``softmax_lowp(logits, out_dtype)`` takes a float32 softmax over the last
axis and returns it cast to ``out_dtype``. Its backward keeps only those
``out_dtype`` probabilities, not a float32 copy: the gradient
``p * (g - <p, g>)`` needs nothing else, and under bf16 the probability
residual is half the size. The cotangent comes back in the logits' dtype.
In float32 the forward is ``torch.softmax`` and the backward the standard
softmax VJP.
"""

from __future__ import annotations

import torch


class _SoftmaxLowp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, out_dtype):
        with torch.autocast(logits.device.type, enabled=False):
            p = torch.softmax(logits.float(), dim=-1).to(out_dtype)
        ctx.save_for_backward(p)
        ctx.in_dtype = logits.dtype
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        with torch.autocast(p.device.type, enabled=False):
            pf, gf = p.float(), g.float()
            s = (pf * gf).sum(dim=-1, keepdim=True)
            return (pf * (gf - s)).to(ctx.in_dtype), None


def softmax_lowp(logits: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """f32 softmax over the last axis, result cast to ``out_dtype``; the
    backward keeps only the ``out_dtype`` probabilities."""
    return _SoftmaxLowp.apply(logits, out_dtype)

"""Losses of the GPS pretrain path and the aggregator (port of
sceneverse_tpu/optim/loss/loss.py). Cross entropy is the JAX package's
``lse - picked`` form with clamped labels (callers mask)."""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.registry import Registry

LOSS_REGISTRY = Registry("loss")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE, no reduction; out-of-range labels are clamped."""
    lf = logits.float()
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    lse = torch.logsumexp(lf, dim=-1)
    return lse - torch.gather(lf, -1, safe[..., None])[..., 0]


def lm_cls_loss(data_dict):
    labels = data_dict["masked_lm_labels"]
    if labels.dim() == 3:
        labels = labels.reshape(-1, labels.shape[-1])
    ce = cross_entropy(data_dict["txt_lm_cls_logits"], labels)
    valid = (labels != -1).float()
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


_FUNCTIONAL = {"lm_cls_loss": lm_cls_loss}


class Loss(nn.Module):
    """Sums ``loss_list`` into total_loss; ``vis_loss_list`` entries are
    computed for logging (reference optim/loss/loss.py:111-148)."""

    def __init__(self, cfg):
        super().__init__()
        from sceneverse_tpu_torch.optim.loss import contra_loss  # registers

        del contra_loss
        self.selected_keys = list(cfg.model.loss_list)
        self.loss_names = list(dict.fromkeys(
            list(cfg.model.get("vis_loss_list", [])) + self.selected_keys))
        for k in self.loss_names:
            if k not in _FUNCTIONAL:
                self.add_module(k, LOSS_REGISTRY.get(k)(cfg))

    def forward(self, data_dict: dict):
        losses = {}
        for k in self.loss_names:
            fn = _FUNCTIONAL.get(k) or getattr(self, k)
            losses[k] = fn(data_dict)
        total = sum(losses[k] for k in self.selected_keys)
        losses["total_loss"] = total
        return total, losses

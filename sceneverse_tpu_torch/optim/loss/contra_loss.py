"""Contrastive losses (port of sceneverse_tpu/optim/loss/contra_loss.py).

On one card the reference's global-batch all-gather is the identity.
``logit_scale`` is a buffer: the reference never optimises it (its optimizer
is built from ``get_opt_params`` only), a quirk kept on purpose."""

from __future__ import annotations

import math

import torch
from torch import nn

from sceneverse_tpu_torch.optim.loss.loss import (LOSS_REGISTRY,
                                                  bce_with_logits,
                                                  cross_entropy)


def _l2norm(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@LOSS_REGISTRY.register()
class TextObjWithinBatch(nn.Module):
    """In-scene object InfoNCE: [CLS] text vs this scene's objects
    (reference contra_loss.py:11-39). Per-scene rows (B * L texts over B
    scenes) repeat each scene's masks and take one target per row, as JAX
    ``contra_loss.py:47-51``.

    ``task: ScanQA`` takes the reference's BCE branch: BCE with logits of
    the cosine logits against the ``(B, O)`` multi-hot of target objects,
    weighted by ``obj_masks``, summed and divided by B. The JAX package
    reduces the labels with ``[..., -1]`` first and so meets ``(B, O)``
    logits with ``(B,)`` labels: it raises a broadcasting error (or, at
    B = O, broadcasts to a wrong loss). The port follows the reference."""

    def __init__(self, cfg):
        super().__init__()
        self.bce = cfg.get("task") in ["ScanQA"]

    def forward(self, data_dict):
        obj = _l2norm(data_dict["intra_obj_embeds"].float())
        txt = _l2norm(data_dict["intra_text_embed"].float())
        labels = data_dict["tgt_object_id"]
        masks = data_dict["obj_masks"]
        if obj.shape[0] != masks.shape[0]:  # per-scene: B * L rows
            rep = obj.shape[0] // masks.shape[0]
            masks = masks.repeat_interleave(rep, dim=0)
            labels = labels.reshape(-1, 1)
        logits = torch.einsum("bod,bd->bo", obj, txt)
        if self.bce:
            if labels.shape != logits.shape:
                raise ValueError(
                    f"the ScanQA branch takes a (B, O) multi-hot of target "
                    f"objects, got labels {tuple(labels.shape)} for logits "
                    f"{tuple(logits.shape)}")
            return bce_with_logits(logits, labels.float(),
                                   weight=masks.float()).sum() / \
                labels.shape[0]
        labels = labels[..., -1] if labels.dim() > 1 else labels
        logits = logits.masked_fill(~masks.bool(), float("-inf"))
        return cross_entropy(logits, labels).mean()


class _BetweenBatchBase(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("logit_scale", torch.tensor(
            math.exp(math.log(1.0 / 0.07)), dtype=torch.float32))

    def _symmetric_infonce(self, a, b):
        scale = self.logit_scale.clamp(max=100.0)
        labels = torch.arange(a.shape[0], device=a.device)
        ab = scale * (b @ a.t())
        ba = scale * (a @ b.t())
        return (cross_entropy(ab, labels).mean()
                + cross_entropy(ba, labels).mean()) / 2


@LOSS_REGISTRY.register()
class TextObjBetweenBatch(_BetweenBatchBase):
    """Target object vs text [CLS] symmetric InfoNCE (reference :42-71)."""

    def __init__(self, cfg):
        super().__init__()

    def forward(self, data_dict):
        obj = data_dict["inter_obj_embeds"]  # (B, O, D)
        labels = data_dict["tgt_object_id"]
        if obj.shape[0] != labels.shape[0]:  # per-scene: B * L rows
            labels = labels.reshape(-1, 1)
        idx = labels[:, :1, None].long().expand(-1, 1, obj.shape[-1])
        tgt = torch.gather(obj, 1, idx)[:, 0]
        return self._symmetric_infonce(
            _l2norm(tgt.float()),
            _l2norm(data_dict["inter_text_embed"].float()))


@LOSS_REGISTRY.register()
class TextSceneBetweenBatch(_BetweenBatchBase):
    """Scene-pooled embed vs scene-caption embed InfoNCE (reference :74-98)."""

    def __init__(self, cfg):
        super().__init__()

    def forward(self, data_dict):
        return self._symmetric_infonce(
            _l2norm(data_dict["scene_embed"].float()),
            _l2norm(data_dict["scene_text_embed"].float()))

"""Functional losses and the aggregator (port of
sceneverse_tpu/optim/loss/loss.py; reference optim/loss/loss.py).

Cross entropy is the JAX package's ``lse - picked`` form with clamped
labels: callers mask out-of-range labels (pad labels -100 carry mask 0 and
count nothing). BCE is torch's ``binary_cross_entropy_with_logits``
formula, summed and divided by the batch where the reference does."""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.registry import Registry

LOSS_REGISTRY = Registry("loss")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-position CE, no reduction; out-of-range labels are clamped.
    With ``label_smoothing`` s: (1 - s) * nll + s * (lse - mean(logits))."""
    lf = logits.float()
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - torch.gather(lf, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = lse - lf.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (torch's formula)."""
    lf = logits.float()
    loss = lf.clamp_min(0) - lf * targets + torch.log1p(torch.exp(-lf.abs()))
    return loss if weight is None else loss * weight


def og3d_loss(d):
    return cross_entropy(d["og3d_logits"], d["tgt_object_id"][..., 0]).mean()


def og3d_multi_loss(d):
    tgt = d["tgt_object_id"].float()
    return bce_with_logits(d["og3d_logits"], tgt).sum() / tgt.shape[0]


def txt_cls_multi_loss(d):
    tgt = d["tgt_object_label"].float()
    return bce_with_logits(d["txt_cls_logits"], tgt).sum() / tgt.shape[0]


def _masked_obj_ce(logits, labels, mask, smoothing=0.0):
    ce = cross_entropy(logits, labels, smoothing) * (labels >= 0)
    m = mask.float()
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def obj_cls_raw_loss(d):
    return _masked_obj_ce(d["obj_cls_raw_logits"], d["obj_labels"],
                          d["obj_masks"])


def obj_cls_pre_loss(d):
    return _masked_obj_ce(d["obj_cls_pre_logits"], d["obj_labels"],
                          d["obj_masks"])


def obj_cls_post_loss(d):
    return _masked_obj_ce(d["obj_cls_post_logits"], d["obj_labels"],
                          d["obj_masks"])


def answer_loss(d):
    tgt = d["answer_label"].float()
    scores = d["answer_scores"]
    return bce_with_logits(scores, tgt).sum() / scores.shape[0]


def lm_cls_loss(d):
    labels = d["masked_lm_labels"]
    if labels.dim() == 3:
        labels = labels.reshape(-1, labels.shape[-1])
    ce = cross_entropy(d["txt_lm_cls_logits"], labels)
    valid = (labels != -1).float()
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


def _sem_mask_obj_ce(d, key, unmask: bool):
    """Object CE over the objects whose semantic mask is set (``unmask``)
    or cleared."""
    sem = d["obj_sem_masks"].bool()
    return _masked_obj_ce(d[key], d["obj_labels"],
                          d["obj_masks"].bool() & (sem if unmask else ~sem))


def obj_cls_pre_loss_mask(d):
    return _sem_mask_obj_ce(d, "obj_cls_pre_logits", unmask=False)


def obj_cls_pre_loss_unmask(d):
    return _sem_mask_obj_ce(d, "obj_cls_pre_logits", unmask=True)


def obj_cls_post_loss_mask(d):
    return _sem_mask_obj_ce(d, "obj_cls_post_logits", unmask=False)


def obj_cls_post_loss_unmask(d):
    return _sem_mask_obj_ce(d, "obj_cls_post_logits", unmask=True)


def obj_cls_loss(d, smoothing=0.3):
    return _masked_obj_ce(d["obj_logits"], d["obj_labels"], d["obj_masks"],
                          smoothing)


def mse_loss(d):
    return (d["pred_images"] - d["target_images"]).square().mean()


_FUNCTIONAL = {
    fn.__name__: fn
    for fn in (
        og3d_loss, og3d_multi_loss, txt_cls_multi_loss,
        obj_cls_raw_loss, obj_cls_pre_loss, obj_cls_post_loss,
        answer_loss, lm_cls_loss,
        obj_cls_pre_loss_mask, obj_cls_pre_loss_unmask,
        obj_cls_post_loss_mask, obj_cls_post_loss_unmask,
        obj_cls_loss, mse_loss,
    )
}


class Loss(nn.Module):
    """Sums ``loss_list`` into total_loss; ``vis_loss_list`` entries are
    computed for logging (reference optim/loss/loss.py:111-148). A name
    resolves in the functional table, else in ``LOSS_REGISTRY`` (the
    contrastive losses)."""

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
            d = data_dict
            if k == "txt_cls_loss" and "txt_cls_label" not in data_dict:
                # JAX loss.py:253-255; neither package registers a loss of
                # that name, so the name fails at build in both
                d = {**data_dict,
                     "txt_cls_label": data_dict["tgt_object_label"][..., 0]}
            losses[k] = fn(d)
        total = sum(losses[k] for k in self.selected_keys)
        losses["total_loss"] = total
        return total, losses

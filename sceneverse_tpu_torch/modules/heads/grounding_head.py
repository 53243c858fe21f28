"""Grounding heads (port of sceneverse_tpu/modules/heads/grounding_head.py;
reference modules/heads/grounding_head.py:7-55)."""

from __future__ import annotations

from torch import nn

from sceneverse_tpu_torch.modules.build import HEADS_REGISTRY
from sceneverse_tpu_torch.modules.utils import get_mlp_head


def _mask_pads(og3d_logits, obj_masks):
    """Pad objects' logits to -inf, so no argmax or softmax picks one."""
    return og3d_logits.masked_fill(~obj_masks.bool(), float("-inf"))


@HEADS_REGISTRY.register()
class GroundHeadV1(nn.Module):
    """og3d logit per object (pads -inf) and the three auxiliary class
    heads: text [CLS], fused objects, pre-fusion objects; with
    ``detach_all_aux_loss`` the auxiliary heads get detached inputs."""

    def __init__(self, cfg=None, input_size=768, hidden_size=768,
                 sem_cls_size=607, dropout=0.3, detach_all_aux_loss=False):
        super().__init__()
        self.og3d_head = get_mlp_head(input_size, hidden_size, 1, dropout)
        self.txt_clf_head = get_mlp_head(input_size, hidden_size,
                                         sem_cls_size, dropout)
        self.obj3d_clf_head = get_mlp_head(input_size, hidden_size,
                                           sem_cls_size, dropout)
        self.obj3d_clf_pre_head = get_mlp_head(input_size, hidden_size,
                                               sem_cls_size, dropout)
        self.detach_all_aux_loss = detach_all_aux_loss

    def forward(self, txt_embeds, obj_embeds, obj_pre_embeds, obj_masks,
                **kwargs):
        og3d_logits = _mask_pads(self.og3d_head(obj_embeds)[..., 0],
                                 obj_masks)
        if self.detach_all_aux_loss:
            txt_embeds = txt_embeds.detach()
            obj_embeds = obj_embeds.detach()
            obj_pre_embeds = obj_pre_embeds.detach()
        txt_cls_logits = self.txt_clf_head(txt_embeds[:, 0])
        obj_cls_logits = self.obj3d_clf_head(obj_embeds)
        obj_cls_pre_logits = self.obj3d_clf_pre_head(obj_pre_embeds)
        return txt_cls_logits, obj_cls_logits, obj_cls_pre_logits, og3d_logits


@HEADS_REGISTRY.register()
class GroundHead(nn.Module):
    """The og3d logit alone (pads -inf when ``obj_masks`` is given)."""

    def __init__(self, cfg=None, input_size=768, hidden_size=768, dropout=0.3):
        super().__init__()
        self.og3d_head = get_mlp_head(input_size, hidden_size, 1, dropout)

    def forward(self, obj_embeds, obj_masks=None, **kwargs):
        og3d_logits = self.og3d_head(obj_embeds)[..., 0]
        if obj_masks is not None:
            og3d_logits = _mask_pads(og3d_logits, obj_masks)
        return og3d_logits

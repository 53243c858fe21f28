"""MLP classification head over precomputed object features (port of
sceneverse_tpu/modules/vision/obj_cls_encoder.py; reference
modules/vision/obj_cls_encoder.py:5-14)."""

from __future__ import annotations

from torch import nn

from sceneverse_tpu_torch.modules.build import VISION_REGISTRY
from sceneverse_tpu_torch.modules.utils import get_mlp_head


@VISION_REGISTRY.register()
class ObjClsEncoder(nn.Module):
    def __init__(self, cfg=None, input_feat_size=768, hidden_size=768,
                 tgt_cls_num=607):
        super().__init__()
        self.vis_cls_head = get_mlp_head(input_feat_size, hidden_size // 2,
                                         tgt_cls_num, dropout=0.3)

    def forward(self, obj_feats, **kwargs):
        return self.vis_cls_head(obj_feats)

"""MCAN-style QA head (port of sceneverse_tpu/modules/heads/qa_head.py;
reference modules/heads/qa_head.py:8-91). The modules carry the
reference's names (``attflat_*.mlp.fc.linear``, ``answer_cls.{0,3}``,
``fusion_norm``), which the checkpoint converters map to JAX's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sceneverse_tpu_torch.modules.build import HEADS_REGISTRY
from sceneverse_tpu_torch.modules.utils import Dropout
from sceneverse_tpu_torch.utils.precision import LayerNorm


class FC(nn.Module):
    """Linear -> GELU -> Dropout (reference :9-24)."""

    def __init__(self, in_size, out_size, pdrop=0.0):
        super().__init__()
        self.linear = nn.Linear(in_size, out_size)
        self.dropout = Dropout(pdrop)

    def forward(self, x):
        return self.dropout(F.gelu(self.linear(x), approximate="none"))


class MLP(nn.Module):
    """FC -> Linear (reference :27-37)."""

    def __init__(self, in_size, mid_size, out_size, pdrop=0.0):
        super().__init__()
        self.fc = FC(in_size, mid_size, pdrop)
        self.linear = nn.Linear(mid_size, out_size)

    def forward(self, x):
        return self.linear(self.fc(x))


class AttFlat(nn.Module):
    """Attention-flatten pooling over a sequence (reference :40-69)."""

    def __init__(self, hidden_size, flat_mlp_size=512, flat_glimpses=1,
                 flat_out_size=1024, pdrop=0.1):
        super().__init__()
        self.mlp = MLP(hidden_size, flat_mlp_size, flat_glimpses, pdrop)
        self.flat_glimpses = flat_glimpses
        self.linear_merge = nn.Linear(hidden_size * flat_glimpses,
                                      flat_out_size)

    def forward(self, x, x_mask):
        """x: (B, T, D); x_mask: (B, T), True at pads."""
        att = self.mlp(x)  # (B, T, glimpses)
        if x_mask is not None:
            att = att.masked_fill(x_mask[..., None], -1e9)
        att = torch.softmax(att, dim=1)
        pooled = [(att[:, :, i:i + 1] * x).sum(dim=1)
                  for i in range(self.flat_glimpses)]
        return self.linear_merge(torch.cat(pooled, dim=1))


@HEADS_REGISTRY.register()
class QAHeadV1(nn.Module):
    """Both sequences pooled by AttFlat, summed, LayerNorm, then
    Linear -> exact GELU -> Dropout(0.3) -> Linear to the answer scores."""

    def __init__(self, cfg=None, hidden_size=768, mlp_size=256, glimpse=1,
                 flat_out_size=512, num_answers=8864):
        super().__init__()
        self.attflat_visual = AttFlat(hidden_size, mlp_size, glimpse,
                                      flat_out_size, 0.1)
        self.attflat_lang = AttFlat(hidden_size, mlp_size, glimpse,
                                    flat_out_size, 0.1)
        self.answer_cls = nn.Sequential(
            nn.Linear(flat_out_size, hidden_size), nn.GELU(), Dropout(0.3),
            nn.Linear(hidden_size, num_answers))
        self.fusion_norm = LayerNorm(flat_out_size, eps=1e-5)

    def forward(self, obj_embeds, obj_masks, txt_embeds, txt_masks, **kwargs):
        object_feat = self.attflat_visual(obj_embeds, ~obj_masks.bool())
        lang_feat = self.attflat_lang(txt_embeds, ~txt_masks.bool())
        return self.answer_cls(self.fusion_norm(lang_feat + object_feat))

"""GPS fusion encoder ``UnifiedSpatialCrossEncoderV2`` (port of
sceneverse_tpu/modules/grounding/unified_encoder.py:118-160): text and object
tokens concatenated (L = 50 + 80 at GPS shapes) with token-type and loc
embeddings re-added before every shared self-attention layer."""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.modules.build import GROUNDING_REGISTRY
from sceneverse_tpu_torch.modules.layers.transformers import (
    TransformerEncoderLayer)
from sceneverse_tpu_torch.modules.vision.pcd_openvocab_encoder import (
    loc_layer)
from sceneverse_tpu_torch.utils.precision import Embedding


@GROUNDING_REGISTRY.register()
class UnifiedSpatialCrossEncoderV2(nn.Module):
    def __init__(self, cfg=None, hidden_size=768, dim_feedforward=2048,
                 num_attention_heads=12, num_layers=4, dim_loc=6):
        super().__init__()
        self.unified_encoder = nn.ModuleList([
            TransformerEncoderLayer(hidden_size, num_attention_heads,
                                    dim_feedforward=dim_feedforward)
            for _ in range(num_layers)])
        self.loc_layers = nn.ModuleList([loc_layer(dim_loc, hidden_size)])
        self.token_type_embeddings = Embedding(2, hidden_size)

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                **kwargs):
        txt_len = txt_embeds.shape[1]
        joint_pad = ~torch.cat([txt_masks.bool(), obj_masks.bool()], dim=1)
        type_ids = torch.cat([
            torch.zeros(txt_embeds.shape[:2], dtype=torch.long,
                        device=txt_embeds.device),
            torch.ones(obj_embeds.shape[:2], dtype=torch.long,
                       device=txt_embeds.device)], dim=1)
        type_embeds = self.token_type_embeddings(type_ids)
        for layer in self.unified_encoder:
            obj_embeds = obj_embeds + self.loc_layers[0](obj_locs)
            joint = torch.cat([txt_embeds, obj_embeds], dim=1) + type_embeds
            joint, _ = layer(joint, tgt_key_padding_mask=joint_pad)
            txt_embeds, obj_embeds = joint[:, :txt_len], joint[:, txt_len:]
        return txt_embeds, obj_embeds

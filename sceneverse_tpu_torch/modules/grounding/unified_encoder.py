"""Cross-modal fusion encoders (port of
sceneverse_tpu/modules/grounding/unified_encoder.py; reference
modules/grounding/unified_encoder.py):
  * ``EntitySpatialCrossEncoder``: object tokens through spatial decoder
    layers ('cond' self-attention over the objects, cross-attention to the
    text: 80 object queries over 50 text keys at GPS shapes);
  * ``UnifiedSpatialCrossEncoderV1``: an object stream as above and a text
    stream of decoder layers (self-attention over the text, cross-attention
    to the objects: 50 queries over 80 keys), side by side, each layer
    reading the other stream's previous output;
  * ``UnifiedSpatialCrossEncoderV2`` (the GPS encoder): text and object
    tokens concatenated (L = 50 + 80) with token-type and loc embeddings
    re-added before every shared self-attention layer."""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.modules.build import GROUNDING_REGISTRY
from sceneverse_tpu_torch.modules.layers.transformers import (
    TransformerDecoderLayer, TransformerEncoderLayer,
    TransformerSpatialDecoderLayer)
from sceneverse_tpu_torch.modules.vision.pcd_openvocab_encoder import (
    loc_layer)
from sceneverse_tpu_torch.ops.geometry import calc_pairwise_locs
from sceneverse_tpu_torch.utils.precision import Embedding


def _spatial_decoders(hidden_size, num_attention_heads, spatial_dim,
                      num_layers):
    return nn.ModuleList([
        TransformerSpatialDecoderLayer(
            hidden_size, num_attention_heads, dim_feedforward=2048,
            dropout=0.1, activation="gelu", spatial_dim=spatial_dim,
            spatial_multihead=True, spatial_attn_fusion="cond")
        for _ in range(num_layers)])


class _SpatialCross(nn.Module):
    """What the two spatial cross encoders share: the loc layer and the
    pairwise locations of the objects."""

    def _init_spatial(self, hidden_size, dim_loc, pairwise_rel_type,
                      spatial_dim):
        self.loc_layers = nn.ModuleList([loc_layer(dim_loc, hidden_size)])
        self.pairwise_rel_type = pairwise_rel_type
        self.spatial_dim = spatial_dim

    def _pairwise(self, obj_locs):
        return calc_pairwise_locs(obj_locs[:, :, :3], obj_locs[:, :, 3:],
                                  pairwise_rel_type=self.pairwise_rel_type)


@GROUNDING_REGISTRY.register()
class EntitySpatialCrossEncoder(_SpatialCross):
    def __init__(self, cfg=None, hidden_size=768, num_attention_heads=12,
                 spatial_dim=5, num_layers=4, dim_loc=6,
                 pairwise_rel_type="center"):
        super().__init__()
        self.layers = _spatial_decoders(hidden_size, num_attention_heads,
                                        spatial_dim, num_layers)
        self._init_spatial(hidden_size, dim_loc, pairwise_rel_type,
                           spatial_dim)

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                **kwargs):
        pairwise_locs = self._pairwise(obj_locs)
        obj_pad, txt_pad = ~obj_masks.bool(), ~txt_masks.bool()
        for layer in self.layers:
            obj_embeds = obj_embeds + self.loc_layers[0](obj_locs)
            obj_embeds, _, _ = layer(
                obj_embeds, txt_embeds, pairwise_locs,
                tgt_key_padding_mask=obj_pad,
                memory_key_padding_mask=txt_pad)
        return txt_embeds, obj_embeds


@GROUNDING_REGISTRY.register()
class UnifiedSpatialCrossEncoderV1(_SpatialCross):
    def __init__(self, cfg=None, hidden_size=768, num_attention_heads=12,
                 spatial_dim=5, num_layers=4, dim_loc=6,
                 pairwise_rel_type="center"):
        super().__init__()
        self.pc_encoder = _spatial_decoders(hidden_size, num_attention_heads,
                                            spatial_dim, num_layers)
        self.lang_encoder = nn.ModuleList([
            TransformerDecoderLayer(hidden_size, num_attention_heads)
            for _ in range(num_layers)])
        self._init_spatial(hidden_size, dim_loc, pairwise_rel_type,
                           spatial_dim)

    def forward(self, txt_embeds, txt_masks, obj_embeds, obj_locs, obj_masks,
                **kwargs):
        pairwise_locs = self._pairwise(obj_locs)
        obj_pad, txt_pad = ~obj_masks.bool(), ~txt_masks.bool()
        for pc_layer, lang_layer in zip(self.pc_encoder, self.lang_encoder):
            obj_embeds = obj_embeds + self.loc_layers[0](obj_locs)
            obj_out, _, _ = pc_layer(
                obj_embeds, txt_embeds, pairwise_locs,
                tgt_key_padding_mask=obj_pad,
                memory_key_padding_mask=txt_pad)
            txt_embeds, _, _ = lang_layer(
                txt_embeds, obj_embeds, tgt_key_padding_mask=txt_pad,
                memory_key_padding_mask=obj_pad)
            obj_embeds = obj_out
        return txt_embeds, obj_embeds


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

"""GPS vision tower: PointNet++ (frozen or trainable, ``freeze``) + 4-layer
spatial 'cond' transformer (port of
sceneverse_tpu/modules/vision/pcd_openvocab_encoder.py; reference
modules/vision/pcd_openvocab_encoder.py:16-184). Returns
(post_embeds, pre_embeds, softmax obj_sem_cls)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from sceneverse_tpu_torch.modules.build import VISION_REGISTRY
from sceneverse_tpu_torch.modules.layers.pointnet import PointNetPP
from sceneverse_tpu_torch.modules.layers.transformers import (
    TransformerSpatialEncoderLayer)
from sceneverse_tpu_torch.modules.utils import Dropout
from sceneverse_tpu_torch.ops.geometry import calc_pairwise_locs
from sceneverse_tpu_torch.utils.precision import Embedding, LayerNorm


def _load_text_features(lang_path: Optional[str], lang_type: str,
                        hidden_size: int) -> np.ndarray:
    """607-class text embedding table, or the deterministic RandomState(0)
    placeholder the JAX package uses when no table is on disk (:36-52)."""
    dim = hidden_size if lang_type == "bert" else 512
    if lang_path:
        stem = "bert-base-uncased" if lang_type == "bert" else "clip-ViT-B16"
        for cand in (os.path.join(lang_path, f"scannet_607_{stem}_id.pth"),
                     lang_path):
            if os.path.isfile(cand):
                return torch.load(cand, map_location="cpu").float().numpy()
    rng = np.random.RandomState(0)
    return rng.normal(0, 0.02, size=(607, dim)).astype(np.float32)


def loc_layer(dim_loc: int, hidden_size: int) -> nn.Sequential:
    """Linear(dim_loc -> hidden) + LayerNorm(eps 1e-5) (reference :84-87)."""
    return nn.Sequential(nn.Linear(dim_loc, hidden_size),
                         LayerNorm(hidden_size, eps=1e-5))


@VISION_REGISTRY.register()
class PointOpenVocabEncoder(nn.Module):
    def __init__(self, cfg=None, backbone="pointnet++", hidden_size=768,
                 path=None, freeze=False, dim_feedforward=2048,
                 num_attention_heads=12, spatial_dim=5, num_layers=4,
                 dim_loc=6, pairwise_rel_type="center", use_matmul_label=False,
                 mixup_strategy=None, mixup_stage1=None, mixup_stage2=None,
                 lang_type="bert", lang_path=None, attn_type="spatial"):
        super().__init__()
        if backbone != "pointnet++":
            raise NotImplementedError(f"backbone {backbone!r}")
        if attn_type != "spatial":
            raise NotImplementedError(f"attn_type {attn_type!r}")
        self.point_feature_extractor = PointNetPP(
            sa_n_points=[32, 16, None], sa_n_samples=[32, 32, None],
            sa_radii=[0.2, 0.4, None],
            sa_mlps=[[3, 64, 64, 128], [128, 128, 128, 256],
                     [256, 256, 512, hidden_size]])
        self.register_buffer("text_features", torch.from_numpy(
            _load_text_features(lang_path, lang_type, hidden_size)))
        self.dropout = Dropout(0.1)
        self.freeze = freeze
        if freeze:
            # frozen backbone: eval BatchNorm, no gradients, fused kernels
            # (the JAX encoder's :98-101)
            self.point_feature_extractor.requires_grad_(False)
            self.point_feature_extractor.set_fused_frozen()
        # built for checkpoint parity; unused by the reference forward
        self.sem_cls_embed_layer = nn.Sequential(
            nn.Linear(hidden_size, hidden_size),
            LayerNorm(hidden_size, eps=1e-5), nn.Dropout(0.1))
        self.sem_mask_embeddings = Embedding(1, 768)
        self.spatial_encoder = nn.ModuleList([
            TransformerSpatialEncoderLayer(
                hidden_size, num_attention_heads,
                dim_feedforward=dim_feedforward, dropout=0.1,
                activation="gelu", spatial_dim=spatial_dim,
                spatial_multihead=True, spatial_attn_fusion="cond")
            for _ in range(num_layers)])
        self.loc_layers = nn.ModuleList([loc_layer(dim_loc, hidden_size)])
        self.pairwise_rel_type = pairwise_rel_type
        self.spatial_dim = spatial_dim

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze:
            self.point_feature_extractor.eval()  # frozen BN statistics
        return self

    def forward(self, obj_pcds, obj_locs, obj_masks, obj_sem_masks=None,
                obj_labels=None, **kwargs):
        B, O = obj_pcds.shape[:2]
        flat = obj_pcds.reshape(B * O, *obj_pcds.shape[2:])
        obj_embeds = self.point_feature_extractor(flat).reshape(B, O, -1)
        obj_embeds = self.dropout(obj_embeds)
        if self.freeze:
            obj_embeds = obj_embeds.detach()
        logits = obj_embeds @ self.text_features.t().to(obj_embeds.dtype)
        obj_sem_cls = torch.softmax(logits.float(), dim=2).detach()
        obj_embeds_pre = obj_embeds
        pairwise_locs = calc_pairwise_locs(
            obj_locs[:, :, :3], obj_locs[:, :, 3:],
            pairwise_rel_type=self.pairwise_rel_type, spatial_dist_norm=True,
            spatial_dim=self.spatial_dim)
        pad = ~obj_masks.bool()
        for layer in self.spatial_encoder:
            obj_embeds = obj_embeds + self.loc_layers[0](obj_locs)
            obj_embeds, _ = layer(obj_embeds, pairwise_locs,
                                  tgt_key_padding_mask=pad)
        return obj_embeds, obj_embeds_pre, obj_sem_cls

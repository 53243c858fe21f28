"""Standalone object classifier: the PointNet++ encoder's pretraining model
(port of sceneverse_tpu/model/objcls.py; reference model/objcls.py:16-97).

The PointNet++ ends at 512 channels (``language_type: clip``, the default)
or 768 (``bert``). Closed vocabulary: an MLP head to ``num_classes``. Open
vocabulary: the logits are the dot products with a frozen 607-row text
table, a buffer (``pre_extract_path``, or the deterministic placeholder
both packages make without a file). Train-mode BatchNorm sums its moments
over every rank of a data-parallel world (``modules/layers/pointnet.py``),
the reference's SyncBatchNorm (:33-34)."""

from __future__ import annotations

import torch

from sceneverse_tpu_torch.model.build import MODEL_REGISTRY, BaseModel
from sceneverse_tpu_torch.modules.layers.pointnet import (
    PointNetPP, init_pointnet_weights)
from sceneverse_tpu_torch.modules.utils import (Dropout, get_mlp_head,
                                               init_bert_weights)
from sceneverse_tpu_torch.modules.vision.pcd_openvocab_encoder import \
    _load_text_features


@MODEL_REGISTRY.register()
class ObjCls(BaseModel):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.model_name = cfg.model.get("model_name", "pointnet++")
        self.language_type = cfg.model.get("language_type", "clip")
        self.open_vocab = cfg.model.get("open_vocab", False)
        cls_in = 512 if self.language_type == "clip" else 768
        self.point_feature_extractor = PointNetPP(
            sa_n_points=[32, 16, None], sa_n_samples=[32, 32, None],
            sa_radii=[0.2, 0.4, None],
            sa_mlps=[[3, 64, 64, 128], [128, 128, 128, 256],
                     [256, 256, 512, cls_in]])
        if not self.open_vocab:
            self.cls_head = get_mlp_head(cls_in,
                                         cfg.model.get("cls_hidden", 1024),
                                         cfg.model.num_classes)
        else:
            self.register_buffer("text_embeds", torch.from_numpy(
                _load_text_features(cfg.model.get("pre_extract_path"),
                                    self.language_type, cls_in)))
        self.dropout = Dropout(0.1)
        if generator is None:
            generator = torch.Generator().manual_seed(
                int(cfg.get("rng_seed", 42)))
        init_pointnet_weights(self.point_feature_extractor, generator)
        if not self.open_vocab:
            init_bert_weights(self.cls_head, generator)

    def forward(self, data_dict: dict) -> dict:
        out = dict(data_dict)
        obj_pcds = data_dict["obj_fts"]
        B, O = obj_pcds.shape[:2]
        flat = obj_pcds.reshape(B * O, *obj_pcds.shape[2:])
        obj_embeds = self.dropout(self.point_feature_extractor(flat))
        if self.open_vocab:
            logits = obj_embeds @ self.text_embeds.t().to(obj_embeds.dtype)
        else:
            logits = self.cls_head(obj_embeds)
        out["obj_logits"] = logits.reshape(B, O, -1)
        return out

    def get_opt_params(self):
        # reference :89-96: one group at solver.lr with solver.weight_decay
        # (default 0) and no decay / no-decay split
        return [{"prefix": (), "lr": self.cfg.solver.lr,
                 "weight_decay": self.cfg.solver.get("weight_decay", 0.0),
                 "no_decay_split": False}]

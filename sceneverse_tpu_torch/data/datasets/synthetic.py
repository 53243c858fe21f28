"""Synthetic GPS pretrain/grounding data: deterministic random items in the
batch schema of the real pipeline, for runs without the SceneVerse data
release.

The port's own copies of ``SyntheticObjDataset`` and
``SyntheticReferDataset`` from ``sceneverse_tpu/data/datasets/synthetic.py``:
the same seed gives byte-identical items (``tests/test_torch_standalone.py``,
``tests/test_torch_objcls.py``).
"""

from __future__ import annotations

import numpy as np

from sceneverse_tpu_torch.data.build import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SyntheticObjDataset:
    """Object-classification samples (the ObjCls schema obj_fts /
    obj_labels / obj_masks, reference base.py:263-322); pad objects are
    labelled -100."""

    def __init__(self, cfg, split="train"):
        args = cfg.data.args
        self.length = int(cfg.data.get("synthetic_size", 64))
        self.num_obj = int(args.get("max_obj_len", 8))
        self.num_points = int(args.get("num_points", 128))
        self.num_classes = int(cfg.model.get("num_classes", 607))
        self.seed = 1234 if split == "train" else 4321

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n_valid = rng.randint(1, self.num_obj + 1)
        obj_fts = rng.randn(self.num_obj, self.num_points, 6).astype(np.float32)
        labels = rng.randint(0, self.num_classes, self.num_obj).astype(np.int64)
        labels[n_valid:] = -100
        masks = np.zeros(self.num_obj, bool)
        masks[:n_valid] = True
        return {
            "obj_fts": obj_fts,
            "obj_labels": labels,
            "obj_masks": masks,
            "data_idx": idx,
        }


@DATASET_REGISTRY.register()
class SyntheticReferDataset:
    """GPS grounding/pretrain samples in the MaskDatasetWrapper output
    schema (reference dataset_wrapper.py:38-111)."""

    def __init__(self, cfg, split="train"):
        args = cfg.data.args
        self.length = int(cfg.data.get("synthetic_size", 64))
        self.num_obj = int(args.get("max_obj_len", 8))
        self.num_points = int(args.get("num_points", 128))
        self.max_seq_len = int(args.get("max_seq_len", 12))
        self.vocab = int(cfg.model.heads.pretrain_head.args.get("vocab_size", 30522)) \
            if cfg.select("model.heads.pretrain_head") else 30522
        self.use_scene_cap = bool(args.get("use_scene_cap", False))
        self.max_scene_cap_len = int(args.get("max_scene_cap_len", 16))
        self.seed = 1234 if split == "train" else 4321

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        O, P, L = self.num_obj, self.num_points, self.max_seq_len
        n_valid = rng.randint(2, O + 1)
        tgt = rng.randint(0, n_valid)
        masks = np.zeros(O, bool)
        masks[:n_valid] = True
        lm_labels = np.where(
            rng.rand(L) < 0.15, rng.randint(0, self.vocab, L), -1
        ).astype(np.int64)
        item = {
            "txt_ids": rng.randint(0, self.vocab, L).astype(np.int64),
            "txt_masks": np.ones(L, np.int64),
            "masked_lm_labels": lm_labels,
            "obj_fts": rng.randn(O, P, 6).astype(np.float32),
            "obj_locs": rng.randn(O, 6).astype(np.float32),
            "obj_masks": masks,
            "obj_sem_masks": (rng.rand(O) > 0.1).astype(np.int64),
            "obj_labels": np.where(masks, rng.randint(0, 607, O), -100).astype(np.int64),
            "obj_boxes": rng.randn(O, 6).astype(np.float32),
            "tgt_object_id": np.asarray([tgt], np.int64),
            "tgt_object_label": np.asarray([rng.randint(0, 607)], np.int64),
            "tgt_object_id_iou25": (rng.rand(O) > 0.5).astype(np.int64),
            "tgt_object_id_iou50": (rng.rand(O) > 0.7).astype(np.int64),
            "is_multiple": rng.rand() > 0.5,
            "is_hard": rng.rand() > 0.5,
            "is_view_dependent": rng.rand() > 0.5,
            "data_idx": idx,
        }
        if self.use_scene_cap:
            item["scene_txt_ids"] = rng.randint(
                0, self.vocab, self.max_scene_cap_len
            ).astype(np.int64)
            item["scene_txt_masks"] = np.ones(self.max_scene_cap_len, np.int64)
        return item

"""Dataset wrappers (reference data/datasets/dataset_wrapper.py:15-221): the
port's own copy of ``sceneverse_tpu/data/datasets/dataset_wrapper.py``.

Wrappers convert raw dataset items into the static-shape batch schema the
model consumes: tokenize to max_seq_len, BERT 15%/80-10-10 masking
(train), pad objects to max_obj_len (fts pad 1.0, locs 0.0, labels -100),
random point-cloud semantic masks.
"""

from __future__ import annotations

import numpy as np

from sceneverse_tpu_torch.data.data_utils import pad_array, random_point_cloud, random_word
from sceneverse_tpu_torch.data.tokenizer import get_tokenizer
from sceneverse_tpu_torch.registry import Registry

DATASETWRAPPER_REGISTRY = Registry("dataset_wrapper")


@DATASETWRAPPER_REGISTRY.register()
class MaskDatasetWrapper:
    """Train/pretrain wrapper (reference :15-115): tokenize + mask + pad.

    Output keys restricted to the reference's key_list (:95-110) — notably
    obj_boxes / iou lists / is_* flags are dropped in the train path.
    """

    def __init__(self, cfg, dataset, split="train"):
        assert cfg.data.args.get("mask_strategy", "random") in ["random"]
        self.dataset = dataset
        self.tokenizer = get_tokenizer(cfg)
        self.max_seq_length = cfg.data.args.max_seq_len
        self.max_obj_len = cfg.data.args.max_obj_len
        self.txt_mask_ratio = cfg.data.args.txt_mask_ratio
        self.pc_mask_ratio = cfg.data.args.pc_mask_ratio
        self.use_scene_cap = cfg.data.args.get("use_scene_cap", False)
        self.max_scene_cap_len = cfg.data.args.get(
            "max_scene_cap_len", self.max_seq_length
        )

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        data_dict = dict(self.dataset[idx])
        sentence = data_dict["sentence"]
        txt_ids, txt_masks = self.tokenizer.encode(sentence, self.max_seq_length)
        if self.use_scene_cap:
            scene_cap = data_dict.get("scene_cap", "This is a scene.") + " " + sentence
            sc_ids, sc_masks = self.tokenizer.encode(scene_cap, self.max_scene_cap_len)
            data_dict["scene_txt_ids"] = sc_ids
            data_dict["scene_txt_masks"] = sc_masks

        masked_ids, lm_labels = random_word(
            txt_ids, txt_masks, self.tokenizer, self.txt_mask_ratio
        )
        data_dict["txt_ids"] = masked_ids
        data_dict["txt_masks"] = txt_masks
        data_dict["masked_lm_labels"] = lm_labels

        n_obj = len(data_dict["obj_locs"])
        data_dict["obj_masks"] = np.arange(self.max_obj_len) < n_obj
        if "obj_fts" in data_dict:
            data_dict["obj_fts"] = pad_array(
                data_dict["obj_fts"], self.max_obj_len, pad=1.0, dtype=np.float32
            )
        if "obj_pcds_masks" in data_dict:
            data_dict["obj_pcds_masks"] = pad_array(
                data_dict["obj_pcds_masks"], self.max_obj_len, pad=1
            )
        data_dict["obj_locs"] = pad_array(
            data_dict["obj_locs"], self.max_obj_len, pad=0.0, dtype=np.float32
        )
        data_dict["obj_labels"] = pad_array(
            data_dict["obj_labels"], self.max_obj_len, pad=-100, dtype=np.int64
        )
        data_dict["obj_sem_masks"] = random_point_cloud(
            data_dict["obj_masks"], self.pc_mask_ratio
        ).astype(np.int64)
        if "tgt_object_id" in data_dict:
            data_dict["tgt_object_id"] = np.asarray(
                data_dict["tgt_object_id"], np.int64
            )

        key_list = [
            "txt_ids", "txt_masks", "masked_lm_labels", "obj_masks", "obj_fts",
            "obj_locs", "obj_labels", "obj_sem_masks", "tgt_object_id",
            "obj_pcds_masks", "scene_pcds", "scene_txt_ids", "scene_txt_masks",
        ]
        return {k: v for k, v in data_dict.items() if k in key_list and v is not None}


@DATASETWRAPPER_REGISTRY.register()
class ScanFamilyDatasetWrapperOld:
    """Eval/finetune wrapper (reference :118-199): tokenize + pad, no masking,
    sem_mask = valid, iou25/50 padding; keeps boxes/flags for evaluators."""

    def __init__(self, cfg, dataset, split="train"):
        self.dataset = dataset
        self.tokenizer = get_tokenizer(cfg)
        self.max_seq_length = cfg.data.args.max_seq_len
        self.max_obj_len = cfg.data.args.max_obj_len
        self.use_scene_cap = cfg.data.args.get("use_scene_cap", False)
        self.max_scene_cap_len = cfg.data.args.get(
            "max_scene_cap_len", self.max_seq_length
        )

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        data_dict = dict(self.dataset[idx])
        sentence = data_dict["sentence"]
        txt_ids, txt_masks = self.tokenizer.encode(sentence, self.max_seq_length)
        data_dict["txt_ids"] = txt_ids
        data_dict["txt_masks"] = txt_masks
        if self.use_scene_cap:
            scene_cap = data_dict.get("scene_cap", "This is a scene.") + " " + sentence
            sc_ids, sc_masks = self.tokenizer.encode(scene_cap, self.max_scene_cap_len)
            data_dict["scene_txt_ids"] = sc_ids
            data_dict["scene_txt_masks"] = sc_masks

        n_obj = len(data_dict["obj_locs"])
        data_dict["obj_masks"] = np.arange(self.max_obj_len) < n_obj
        if "obj_fts" in data_dict:
            data_dict["obj_fts"] = pad_array(
                data_dict["obj_fts"], self.max_obj_len, pad=1.0, dtype=np.float32
            )
        if "obj_pcds_masks" in data_dict:
            data_dict["obj_pcds_masks"] = pad_array(
                data_dict["obj_pcds_masks"], self.max_obj_len, pad=1
            )
        data_dict["obj_locs"] = pad_array(
            data_dict["obj_locs"], self.max_obj_len, pad=0.0, dtype=np.float32
        )
        data_dict["obj_boxes"] = pad_array(
            data_dict["obj_boxes"], self.max_obj_len, pad=0.0, dtype=np.float32
        )
        data_dict["obj_labels"] = pad_array(
            data_dict["obj_labels"], self.max_obj_len, pad=-100, dtype=np.int64
        )
        data_dict["obj_sem_masks"] = (
            np.arange(self.max_obj_len) < n_obj
        ).astype(np.int64)
        data_dict["tgt_object_label"] = np.asarray(
            data_dict["tgt_object_label"], np.int64
        )
        tgt = np.asarray(data_dict["tgt_object_id"], np.int64)
        if tgt.ndim >= 1 and tgt.shape[0] > 1:
            tgt = pad_array(tgt, self.max_obj_len, pad=0, dtype=np.int64)
        data_dict["tgt_object_id"] = tgt
        for key in ("tgt_object_id_iou25", "tgt_object_id_iou50"):
            if data_dict.get(key) is not None:
                data_dict[key] = pad_array(
                    data_dict[key], self.max_obj_len, pad=0, dtype=np.int64
                )
        if "answer_label" in data_dict:
            data_dict["answer_label"] = np.asarray(
                data_dict["answer_label"], np.int64
            )
        # bool flags -> arrays for clean collation
        for key in ("is_multiple", "is_view_dependent", "is_hard"):
            if key in data_dict:
                data_dict[key] = bool(data_dict[key])
        return data_dict


@DATASETWRAPPER_REGISTRY.register()
class VisualizeDatasetWrapper:
    """reference :202-221."""

    def __init__(self, cfg, dataset, split="train"):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        data_dict = self.dataset[idx]
        return {
            "scene_pcds": data_dict["scene_pcds"],
            "item_id": data_dict["data_idx"],
        }

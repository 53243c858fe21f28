"""ScanNet QA benchmark datasets: the port's own copy of
``sceneverse_tpu/data/datasets/scannet_qa.py``, the same numpy and
``random`` calls in the same order, so a seed gives the same items
(reference data/datasets/scannet_old.py:22-513 over scannet_base.py):
ScanNetSQA3D (situation+question concat, random alternative situation at
train, answer vocab from answer_dict.json) and ScanNetScanQAOld
(multi-target ids, ScanQA train-json answer vocab, multi-hot BCE answer
labels). Scans are cached module-wide (scannet_base.py:20 SCAN_DATA) so
SQA3D/ScanQA/SpatialRefer runs share loads.
"""

from __future__ import annotations

import collections
import json
import os
import random

import numpy as np

from sceneverse_tpu_torch.data.build import DATASET_REGISTRY
from sceneverse_tpu_torch.data.data_utils import (
    ScanQAAnswer,
    SQA3DAnswer,
    boxes_iou_matrix,
    convert_pc_to_box,
    get_sqa_question_type,
)
from sceneverse_tpu_torch.data.datasets.base import BG_NAMES, ScanBase

SCAN_DATA: dict = {}  # module-level scan cache (reference scannet_base.py:20)


class _ScanNetQABase(ScanBase):
    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.base_dir = cfg.data.scan_family_base
        self.sem_type = cfg.data.args.sem_type
        self.max_obj_len = cfg.data.args.max_obj_len - 1
        assert self.pc_type in ["gt", "pred"]
        assert self.sem_type in ["607"]

    def _load_scannet_cached(self, scan_ids):
        missing = [s for s in scan_ids if s not in SCAN_DATA]
        SCAN_DATA.update(self._load_scan(missing))
        return {s: SCAN_DATA[s] for s in scan_ids if s in SCAN_DATA}

    def __len__(self):
        return len(self.lang_data)

    def _qa_common(self, scan_id, sentence_for_filter, tgt_object_id_list,
                   tgt_object_name_list, rng):
        """Shared QA object pipeline: select fg, match targets, crop.

        Returns (obj_pcds, obj_labels, tgt_id_list, tgt_label_list)."""
        obj_pcds, obj_labels = self._scan_objects(scan_id)
        data = self.scan_data[scan_id]

        if self.pc_type == "pred" and not getattr(self, "is_test", False) \
                and "inst_labels" in data and "obj_center_pred" in data:
            obj_labels = self._match_pred_labels(scan_id, obj_labels)

        if self.filter_lang and self.pc_type == "gt":
            sel = [
                i for i, l in enumerate(obj_labels)
                if self.int2cat[l] not in BG_NAMES
                and self.int2cat[l] in sentence_for_filter
            ]
            for _id in tgt_object_id_list:
                if _id not in sel:
                    sel.append(_id)
        elif self.pc_type == "gt":
            sel = [i for i, l in enumerate(obj_labels)
                   if self.int2cat[l] not in BG_NAMES]
        else:
            sel = list(range(len(obj_pcds)))
        obj_pcds = [obj_pcds[i] for i in sel]
        obj_labels = [obj_labels[i] for i in sel]

        if self.pc_type == "gt":
            tgt_id_list = [sel.index(x) for x in tgt_object_id_list]
            tgt_label_list = [obj_labels[x] for x in tgt_id_list]
        else:
            # match predicted objects against each gt target box (>=0.25);
            # first gt match assigns the name (reference :150-169)
            gt_centers, gt_sizes = [], []
            for cur_id in tgt_object_id_list:
                c, s = convert_pc_to_box(self.scan_data[scan_id]["obj_pcds"][cur_id])
                gt_centers.append(c)
                gt_sizes.append(s)
            tgt_id_list, tgt_label_list = [], []
            if gt_centers:
                centers, sizes = [], []
                for pc in obj_pcds:
                    c, s = convert_pc_to_box(pc)
                    centers.append(c)
                    sizes.append(s)
                iou = boxes_iou_matrix(centers, sizes, gt_centers, gt_sizes)
                for i in range(iou.shape[0]):
                    js = np.flatnonzero(iou[i] >= 0.25)
                    if js.size:
                        tgt_id_list.append(i)
                        tgt_label_list.append(
                            self.cat2int[tgt_object_name_list[js[0]]]
                        )

        # crop (reference :172-190): targets first, then same-label objects
        if self.max_obj_len < len(obj_labels):
            selected = list(tgt_id_list)
            remained = []
            for kobj, klabel in enumerate(obj_labels):
                if kobj not in tgt_id_list:
                    if klabel in tgt_label_list:
                        selected.append(kobj)
                    else:
                        remained.append(kobj)
                if len(selected) == self.max_obj_len:
                    break
            if len(selected) < self.max_obj_len:
                (random.shuffle(remained) if rng is np.random else rng.shuffle(remained))
                selected += remained[: self.max_obj_len - len(selected)]
            obj_pcds = [obj_pcds[i] for i in selected]
            obj_labels = [obj_labels[i] for i in selected]
            tgt_id_list = list(range(len(tgt_id_list)))

        if len(tgt_id_list) == 0:
            tgt_id_list = [len(obj_pcds)]
            tgt_label_list = [5]
        return obj_pcds, obj_labels, tgt_id_list, tgt_label_list

    @staticmethod
    def _multihot(ids, size):
        out = np.zeros(size, np.int64)
        for i in ids:
            out[i] = 1
        return out


@DATASET_REGISTRY.register()
class ScanNetSQA3D(_ScanNetQABase):
    """Situated QA (reference scannet_old.py:22-283)."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.use_unanswer = cfg.data[type(self).__name__][split].use_unanswer
        if self.split == "train":
            self.pc_type = "gt"
        elif self.split == "val":
            self.split = "test"  # reference: val uses the test annotations

        self.num_answers, self.answer_vocab, self.answer_cands = self.build_answer()
        lang_data, self.scan_ids, self.scan_to_item_idxs = self._load_qa_lang()
        if self.debug:
            self.scan_ids = sorted(self.scan_ids)[: self.debug_size]
            keep = set(self.scan_ids)
            self.lang_data = [it for it in lang_data if it["scene_id"] in keep]
        else:
            self.lang_data = lang_data
        self.questions_map = self._load_question()
        self.scan_data = self._load_scannet_cached(sorted(self.scan_ids))

    def build_answer(self):
        answer_data = json.load(open(
            os.path.join(self.base_dir, "annotations/sqa_task/answer_dict.json"),
            encoding="utf-8",
        ))[0]
        counter = collections.Counter(sorted(answer_data.keys()))
        return len(counter), SQA3DAnswer(counter.keys()), counter.keys()

    def _load_qa_lang(self):
        lang_data, scan_ids = [], set()
        scan_to_item_idxs = collections.defaultdict(list)
        anno_file = os.path.join(
            self.base_dir,
            f"annotations/sqa_task/balanced/v1_balanced_sqa_annotations_{self.split}_scannetv2.json",
        )
        for item in json.load(open(anno_file, encoding="utf-8"))["annotations"]:
            answers = [a["answer"] for a in item["answers"]]
            if self.use_unanswer or set(answers) & set(self.answer_cands):
                scan_ids.add(item["scene_id"])
                scan_to_item_idxs[item["scene_id"]].append(len(lang_data))
                lang_data.append(item)
        return lang_data, scan_ids, scan_to_item_idxs

    def _load_question(self):
        questions_map = {}
        anno_file = os.path.join(
            self.base_dir,
            f"annotations/sqa_task/balanced/v1_balanced_questions_{self.split}_scannetv2.json",
        )
        for item in json.load(open(anno_file, encoding="utf-8"))["questions"]:
            questions_map.setdefault(item["scene_id"], {})[item["question_id"]] = {
                "situation": [item["situation"]] + item["alternative_situation"],
                "question": item["question"],
            }
        return questions_map

    def __getitem__(self, index):
        item = self.lang_data[index]
        item_id = item["question_id"]
        scan_id = item["scene_id"]
        rng = self._rng(index)

        answer_list = [a["answer"] for a in item["answers"]]
        answer_id_list = [
            self.answer_vocab.stoi(a) for a in answer_list
            if self.answer_vocab.stoi(a) >= 0
        ]

        situations = self.questions_map[scan_id][item_id]["situation"]
        if self.split == "train":
            situation = random.choice(situations)
        else:
            situation = situations[0]
        question = self.questions_map[scan_id][item_id]["question"]
        concat = situation + question
        question_type = get_sqa_question_type(question)

        obj_pcds, obj_labels, tgt_id_list, tgt_label_list = self._qa_common(
            scan_id, concat, [], [], rng
        )
        obj_fts, obj_locs, obj_boxes, obj_labels = self._obj_processing_post(
            obj_pcds, obj_labels, is_need_bbox=True, rot_aug=self.rot_aug, rng=rng
        )

        return {
            "situation": situation,
            "situation_pos": item["position"],
            "situation_rot": item["rotation"],
            "question": question,
            "sentence": concat,
            "scan_dir": os.path.join(self.base_dir, "scans"),
            "scan_id": scan_id,
            "answer": "[answer_seq]".join(answer_list),
            "answer_label": self._multihot(answer_id_list, self.num_answers),
            "tgt_object_id": self._multihot(tgt_id_list, len(obj_fts) + 1),
            "tgt_object_label": self._multihot(tgt_label_list, 607),
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "obj_labels": obj_labels,
            "obj_boxes": obj_boxes,
            "data_idx": item_id,
            "sqa_type": question_type,
        }


@DATASET_REGISTRY.register()
class ScanNetScanQAOld(_ScanNetQABase):
    """ScanQA (reference scannet_old.py:286-513)."""

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.use_unanswer = cfg.data[type(self).__name__][split].use_unanswer
        if self.split == "train":
            self.pc_type = "gt"
        if split == "test":
            self.split = cfg.data.ScanNetScanQAOld.test.get("test_file", "val")
        self.is_test = "test" in self.split

        self.num_answers, self.answer_vocab, self.answer_cands = self.build_answer()
        lang_data, self.scan_ids, self.scan_to_item_idxs = self._load_qa_lang()
        if self.debug and self.debug_size != -1:
            self.scan_ids = sorted(self.scan_ids)[: self.debug_size]
            keep = set(self.scan_ids)
            self.lang_data = [it for it in lang_data if it["scene_id"] in keep]
        else:
            self.lang_data = lang_data
        self.scan_data = self._load_scannet_cached(sorted(self.scan_ids))

    def build_answer(self):
        train_data = json.load(open(
            os.path.join(self.base_dir, "annotations/qa/ScanQA_v1.0_train.json"),
            encoding="utf-8",
        ))
        counter = collections.Counter(sorted(sum((d["answers"] for d in train_data), [])))
        return len(counter), ScanQAAnswer(counter.keys()), counter.keys()

    def _load_qa_lang(self):
        lang_data, scan_ids = [], set()
        scan_to_item_idxs = collections.defaultdict(list)
        anno_file = os.path.join(
            self.base_dir, f"annotations/qa/ScanQA_v1.0_{self.split}.json"
        )
        for item in json.load(open(anno_file, encoding="utf-8")):
            if self.use_unanswer or (
                "answers" in item and set(item["answers"]) & set(self.answer_cands)
            ):
                scan_ids.add(item["scene_id"])
                scan_to_item_idxs[item["scene_id"]].append(len(lang_data))
                lang_data.append(item)
        return lang_data, scan_ids, scan_to_item_idxs

    def __getitem__(self, index):
        item = self.lang_data[index]
        item_id = item["question_id"]
        scan_id = item["scene_id"]
        rng = self._rng(index)

        if not self.is_test:
            tgt_object_id_list = list(item["object_ids"])
            tgt_object_name_list = list(item["object_names"])
            answer_list = list(item["answers"])
            answer_id_list = [
                self.answer_vocab.stoi(a) for a in answer_list
                if self.answer_vocab.stoi(a) >= 0
            ]
        else:
            tgt_object_id_list, tgt_object_name_list = [], []
            answer_list, answer_id_list = [], []
        question = item["question"]

        obj_pcds, obj_labels, tgt_id_list, tgt_label_list = self._qa_common(
            scan_id, question, tgt_object_id_list, tgt_object_name_list, rng
        )
        obj_fts, obj_locs, obj_boxes, obj_labels = self._obj_processing_post(
            obj_pcds, obj_labels, is_need_bbox=True, rot_aug=False, rng=rng
        )

        return {
            "sentence": question,
            "scan_dir": os.path.join(self.base_dir, "scans"),
            "scan_id": scan_id,
            "answers": "[answer_seq]".join(answer_list),
            "answer_label": self._multihot(answer_id_list, self.num_answers),
            "tgt_object_id": self._multihot(tgt_id_list, len(obj_fts) + 1),
            "tgt_object_label": self._multihot(tgt_label_list, 607),
            "obj_fts": obj_fts,
            "obj_locs": obj_locs,
            "obj_labels": obj_labels,
            "obj_boxes": obj_boxes,
            "data_idx": item_id,
        }

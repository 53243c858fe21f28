"""ScanQA evaluators (port of sceneverse_tpu/evaluator/scanqa_eval.py;
reference evaluator/scanqa_eval.py:14-101): top-1 and top-10 accuracy on
the multi-hot answers and the per-object class accuracies; with
``eval.save`` one row per question (scene, question id, the top-10
answers in the ScanQA train json's vocabulary, the corners of the og3d
argmax's box). ``ScanQAGenEval`` string-matches cleaned free-form
answers."""

from __future__ import annotations

import collections
import json
import os

import torch

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator, ratio_metrics)
from sceneverse_tpu_torch.evaluator.common import obj_cls_accs


def answer_hits(scores, labels):
    """(top-1 hit, top-10 hit, top-10 choices) per row of multi-hot
    ``labels``."""
    rows = torch.arange(scores.shape[0], device=scores.device)
    hit1 = labels[rows, scores.argmax(dim=-1)] == 1
    choice_10 = torch.topk(scores, min(10, scores.shape[-1]), dim=-1).indices
    hit10 = (torch.gather(labels, 1, choice_10) == 1).any(dim=1)
    return hit1, hit10, choice_10


@EVALUATOR_REGISTRY.register()
class ScanQAEval(BaseEvaluator):
    JIT_METRICS = True
    target_metric = "ans1_acc"

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.answer_vocab = None
        if self.save:
            from sceneverse_tpu_torch.data.data_utils import ScanQAAnswer

            path = os.path.join(cfg.data.scan_family_base,
                                "annotations/qa/ScanQA_v1.0_train.json")
            if os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    train_data = json.load(f)
                counter = collections.Counter(
                    sorted(sum([d["answers"] for d in train_data], [])))
                self.answer_vocab = ScanQAAnswer(counter.keys())

    def batch_metrics(self, data_dict, include_count=False):
        scores = data_dict["answer_scores"]
        total = scores.shape[0]
        hit1, hit10, choice_10 = answer_hits(scores, data_dict["answer_label"])
        metrics = {"ans1_acc": (hit1.sum(), total),
                   "ans10_acc": (hit10.sum(), total)}
        metrics.update(obj_cls_accs(data_dict))
        if (self.save and "data_idx" in data_dict
                and self.answer_vocab is not None):
            from sceneverse_tpu_torch.common.box_utils import get_3d_box

            og3d_pred = data_dict["og3d_logits"].argmax(dim=1).cpu().numpy()
            boxes = data_dict["obj_boxes"].cpu().numpy()
            c10 = choice_10.cpu().numpy()
            for i in range(total):
                box = boxes[i, og3d_pred[i]]
                self.eval_results.append({
                    "scene_id": data_dict["scan_id"][i],
                    "question_id": data_dict["data_idx"][i],
                    "answer_top10": [self.answer_vocab.itos(int(j))
                                     for j in c10[i]],
                    "bbox": get_3d_box(box[0:3], box[3:6]).tolist(),
                })
        return metrics if include_count else ratio_metrics(metrics)


@EVALUATOR_REGISTRY.register()
class ScanQAGenEval(ScanQAEval):
    """Free-form generation variant (reference :84-101)."""

    JIT_METRICS = False  # string answers: host-side math

    def batch_metrics(self, data_dict, include_count=False):
        from sceneverse_tpu_torch.data.data_utils import clean_answer

        preds = [clean_answer(a) for a in data_dict["answer_pred"]]
        gts = [list(map(clean_answer, a)) for a in data_dict["answers"]]
        correct = sum(1 for p, g in zip(preds, gts) if p in g)
        metrics = {"ans1_acc": (correct, len(preds))}
        if not include_count:
            return {k: v / max(c, 1) for k, (v, c) in metrics.items()}
        return metrics

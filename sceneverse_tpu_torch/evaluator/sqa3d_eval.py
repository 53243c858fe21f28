"""SQA3D evaluator (port of sceneverse_tpu/evaluator/sqa3d_eval.py;
reference evaluator/sqa3d_eval.py:14-148): top-1 and top-10 accuracy and
the top-1 accuracy per question type (what / is / how / can / which /
others), a type's count floored at 1e-10 in a batch's ratios as JAX's."""

from __future__ import annotations

import collections
import json
import os

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator, ratio_metrics)
from sceneverse_tpu_torch.evaluator.common import obj_cls_accs
from sceneverse_tpu_torch.evaluator.scanqa_eval import answer_hits

NUM_SQA_TYPES = 6  # 0: what, 1: is, 2: how, 3: can, 4: which, 5: others


@EVALUATOR_REGISTRY.register()
class SQA3DEval(BaseEvaluator):
    JIT_METRICS = True
    target_metric = "ans1_acc"

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.answer_vocab = None
        base = cfg.select("data.scan_family_base")
        path = os.path.join(base or "", "annotations/sqa_task/answer_dict.json")
        if base and os.path.isfile(path):
            from sceneverse_tpu_torch.data.data_utils import SQA3DAnswer

            with open(path, encoding="utf-8") as f:
                answer_data = json.load(f)[0]
            counter = collections.Counter(sorted(answer_data.keys()))
            self.answer_vocab = SQA3DAnswer(counter.keys())

    def batch_metrics(self, data_dict, include_count=False):
        scores = data_dict["answer_scores"]
        total = scores.shape[0]
        hit1, hit10, _ = answer_hits(scores, data_dict["answer_label"])
        metrics = {"ans1_acc": (hit1.sum(), total),
                   "ans10_acc": (hit10.sum(), total)}
        sqa_type = data_dict["sqa_type"]
        for t in range(NUM_SQA_TYPES):
            sel = sqa_type == t
            metrics[f"type{t}_acc"] = ((hit1 & sel).sum(), sel.sum())
        metrics.update(obj_cls_accs(data_dict))
        return metrics if include_count else ratio_metrics(metrics,
                                                           floor=1e-10)

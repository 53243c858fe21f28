"""Object-classification pretraining evaluator (port of
sceneverse_tpu/evaluator/objcls_eval.py; reference
evaluator/objcls_eval.py:8-23): masked accuracy. The reference indexes
with the mask first, so it divides by the number of VALID objects; so do
both packages. Over a data-parallel world ``record`` sums the (correct,
count) pairs over the ranks."""

from __future__ import annotations

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator,
                                                  ratio_metrics)


@EVALUATOR_REGISTRY.register()
class PretrainObjEval(BaseEvaluator):
    JIT_METRICS = True

    target_metric = "accuracy"

    def batch_metrics(self, data_dict, include_count=False):
        mask = data_dict["obj_masks"].bool()
        pred = data_dict["obj_logits"].argmax(dim=-1)
        correct = ((pred == data_dict["obj_labels"]) & mask).sum()
        metrics = {"accuracy": (correct, mask.sum())}
        if not include_count:
            return ratio_metrics(metrics)
        return metrics

"""Pretraining evaluator (port of sceneverse_tpu/evaluator/pretrain_eval.py):
batch-size-weighted mean of the og / masked-LM / object-class accuracies;
the target metric is their mean."""

from __future__ import annotations

import torch

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator)


def _masked_acc(logits, labels, mask):
    m = mask.bool()
    correct = ((logits.argmax(dim=2) == labels) & m).sum()
    return correct / (m.sum() + 1e-8)


@EVALUATOR_REGISTRY.register()
class PretrainEval(BaseEvaluator):
    JIT_METRICS = True

    def batch_metrics(self, data_dict, include_count=False):
        metrics = {}
        labels_lm = data_dict["masked_lm_labels"]
        txt_mask = labels_lm != -1
        if "tgt_object_id" in data_dict:
            og_pred = data_dict["og3d_logits"].argmax(dim=-1)
            metrics["og_acc"] = (og_pred == data_dict["tgt_object_id"][..., 0]
                                 ).float().mean()
        lm_pred = data_dict["txt_lm_cls_logits"].argmax(dim=2)
        metrics["lang_cls_acc_mask"] = ((lm_pred == labels_lm) & txt_mask
                                        ).sum() / (txt_mask.sum() + 1e-8)
        obj_masks = data_dict["obj_masks"].bool()
        sem = data_dict["obj_sem_masks"].bool()
        labels = data_dict["obj_labels"]
        for name in ("obj_cls_post_logits", "obj_cls_pre_logits"):
            if name in data_dict:
                stem = name.replace("_logits", "")
                lg = data_dict[name]
                metrics[f"{stem}_acc"] = _masked_acc(lg, labels, obj_masks)
                metrics[f"{stem}_acc_unmask"] = _masked_acc(lg, labels,
                                                            obj_masks & sem)
                metrics[f"{stem}_acc_mask"] = _masked_acc(lg, labels,
                                                          obj_masks & ~sem)
        if "obj_cls_raw_logits" in data_dict:
            metrics["obj_cls_raw_acc"] = _masked_acc(
                data_dict["obj_cls_raw_logits"], labels, obj_masks)
        metrics["target_metric"] = sum(metrics.values()) / len(metrics)
        batch = data_dict["txt_lm_cls_logits"].shape[0]
        if include_count:
            return {k: (v * batch, batch) for k, v in metrics.items()}
        return metrics

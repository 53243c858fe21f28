"""ScanRefer grounding evaluator (port of
sceneverse_tpu/evaluator/scanrefer_eval.py): Acc@0.25/0.5 overall and on the
unique / multiple splits, og accuracy and the per-object class accuracies of
every (B, O, C) ``*_logits`` output; with ``eval.save`` one row per item
(its id, the predicted object's box, whether it is the target), as JAX
``scanrefer_eval.py:57-66``."""

from __future__ import annotations

import torch

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator, ratio_metrics)


def obj_cls_accs(d):
    out = {}
    labels, masks = d.get("obj_labels"), d.get("obj_masks")
    if labels is None or masks is None:
        return out
    m = masks.bool()
    count = m.sum()
    for key, val in d.items():
        if (key.endswith("logits") and torch.is_tensor(val) and val.dim() == 3
                and tuple(val.shape[:2]) == tuple(labels.shape)):
            correct = ((val.argmax(dim=2) == labels) & m).sum()
            out[key.replace("logits", "acc")] = (correct, count)
    return out


@EVALUATOR_REGISTRY.register()
class ScanReferEval(BaseEvaluator):
    target_metric = "og_acc_iou25"

    def batch_metrics(self, data_dict, include_count=False):
        d = dict(data_dict)
        og_pred = d["og3d_logits"].argmax(dim=-1)
        total = og_pred.shape[0]
        is_mult = d["is_multiple"].bool()
        mult = is_mult.sum()
        uniq = total - mult
        rows = torch.arange(total, device=og_pred.device)
        iou25 = d["tgt_object_id_iou25"][rows, og_pred].bool()
        iou50 = d["tgt_object_id_iou50"][rows, og_pred].bool()
        metrics = {
            "og_acc_iou25": (iou25.sum(), total),
            "og_acc_iou50": (iou50.sum(), total),
            "og_acc_iou25_unique": ((iou25 & ~is_mult).sum(), uniq),
            "og_acc_iou50_unique": ((iou50 & ~is_mult).sum(), uniq),
            "og_acc_iou25_multiple": ((iou25 & is_mult).sum(), mult),
            "og_acc_iou50_multiple": ((iou50 & is_mult).sum(), mult),
            "og_acc": ((og_pred == d["tgt_object_id"][:, 0]).sum(), total),
        }
        metrics.update(obj_cls_accs(d))
        if self.save and "data_idx" in data_dict:
            pred = og_pred.cpu().numpy()
            boxes = d["obj_boxes"].cpu().numpy()
            tgt = d["tgt_object_id"][:, 0].cpu().numpy()
            for i, item_id in enumerate(list(data_dict["data_idx"])):
                self.eval_results.append({
                    "scene_id": item_id if isinstance(item_id, str)
                    else int(item_id),
                    "bbox": boxes[i][pred[i]].tolist(),
                    "correct": bool(pred[i] == tgt[i]),
                })
        return metrics if include_count else ratio_metrics(metrics)

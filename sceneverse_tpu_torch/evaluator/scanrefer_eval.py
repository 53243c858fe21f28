"""ScanRefer grounding evaluator (port of
sceneverse_tpu/evaluator/scanrefer_eval.py): Acc@0.25/0.5 overall and on the
unique / multiple splits, og accuracy, the text class accuracy
(``txt_acc``, when a ground head writes ``txt_cls_logits``) and the
per-object class accuracies of every (B, O, C) ``*_logits`` output; per-scene
(B, L, O) logits are flattened to (B * L, O); with ``eval.save`` one row per
item (its id, the predicted object's box, whether it is the target), as
JAX ``scanrefer_eval.py:57-66``."""

from __future__ import annotations

import torch

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator, ratio_metrics)
from sceneverse_tpu_torch.evaluator.common import (grounding_rows,
                                                   obj_cls_accs, txt_acc)


@EVALUATOR_REGISTRY.register()
class ScanReferEval(BaseEvaluator):
    JIT_METRICS = True
    target_metric = "og_acc_iou25"

    def batch_metrics(self, data_dict, include_count=False):
        d = dict(data_dict)
        if d["tgt_object_id_iou25"].dim() == 3:  # per-scene: flatten (B, L)
            for k in ("tgt_object_id_iou25", "tgt_object_id_iou50",
                      "is_multiple", "og3d_logits"):
                d[k] = d[k].reshape(-1, *d[k].shape[2:])
            d["tgt_object_id"] = d["tgt_object_id"].reshape(-1, 1)
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
        metrics.update(txt_acc(d, total))
        metrics.update(obj_cls_accs(d))
        grounding_rows(self, d, og_pred, d["tgt_object_id"][:, 0])
        return metrics if include_count else ratio_metrics(metrics)

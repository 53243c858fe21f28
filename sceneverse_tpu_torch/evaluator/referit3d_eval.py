"""Nr3D / Sr3D grounding evaluator (port of
sceneverse_tpu/evaluator/referit3d_eval.py; reference
evaluator/referit3d_eval.py:10-83): og accuracy (the target metric) and on
the easy / hard and view-dependent / independent splits, ``txt_acc``, the
per-object class accuracies and the ``eval.save`` rows."""

from __future__ import annotations

from sceneverse_tpu_torch.evaluator.build import (EVALUATOR_REGISTRY,
                                                  BaseEvaluator, ratio_metrics)
from sceneverse_tpu_torch.evaluator.common import (grounding_rows,
                                                   obj_cls_accs, txt_acc)


@EVALUATOR_REGISTRY.register()
class ReferIt3DEval(BaseEvaluator):
    JIT_METRICS = True
    target_metric = "og_acc"

    def batch_metrics(self, data_dict, include_count=False):
        d = dict(data_dict)
        if d["og3d_logits"].dim() == 3:  # per-scene: flatten (B, L)
            for k in ("is_hard", "is_view_dependent", "og3d_logits"):
                d[k] = d[k].reshape(-1, *d[k].shape[2:])
            d["tgt_object_id"] = d["tgt_object_id"].reshape(-1, 1)
        og_pred = d["og3d_logits"].argmax(dim=-1)
        total = og_pred.shape[0]
        hard = d["is_hard"].bool()
        viewdep = d["is_view_dependent"].bool()
        n_hard, n_viewdep = hard.sum(), viewdep.sum()
        correct = og_pred == d["tgt_object_id"][:, 0]
        metrics = {
            "og_acc_easy": ((correct & ~hard).sum(), total - n_hard),
            "og_acc_hard": ((correct & hard).sum(), n_hard),
            "og_acc_view_dep": ((correct & viewdep).sum(), n_viewdep),
            "og_acc_view_indep": ((correct & ~viewdep).sum(),
                                  total - n_viewdep),
            "og_acc": (correct.sum(), total),
        }
        metrics.update(txt_acc(d, total))
        metrics.update(obj_cls_accs(d))
        grounding_rows(self, d, og_pred, d["tgt_object_id"][:, 0])
        return metrics if include_count else ratio_metrics(metrics)

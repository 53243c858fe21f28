"""Metric helpers shared by the evaluators (port of
sceneverse_tpu/evaluator/common.py)."""

from __future__ import annotations

import torch


def obj_cls_accs(d):
    """Masked per-object class accuracy of every (B, O, C) ``*_logits``
    aligned with ``obj_labels`` (reference scanrefer_eval.py:56-62):
    {name: (correct, count)}."""
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


def txt_acc(d, total):
    """{"txt_acc": (correct, total)} of the text [CLS] class head against
    the target's label, when the model wrote ``txt_cls_logits``."""
    if "txt_cls_logits" not in d:
        return {}
    pred = d["txt_cls_logits"].argmax(dim=1)
    return {"txt_acc": ((pred == d["tgt_object_label"][:, 0]).sum(), total)}


def grounding_rows(evaluator, data_dict, og_pred, tgt):
    """``eval.save`` rows of a grounding evaluator: the item id, the box of
    the predicted object and whether it is the target (JAX
    ``scanrefer_eval.py:57-66``, ``referit3d_eval.py:51-60``)."""
    if not (evaluator.save and "data_idx" in data_dict):
        return
    pred = og_pred.cpu().numpy()
    boxes = data_dict["obj_boxes"].cpu().numpy()
    tgt = tgt.cpu().numpy()
    for i, item_id in enumerate(list(data_dict["data_idx"])):
        evaluator.eval_results.append({
            "scene_id": item_id if isinstance(item_id, str) else int(item_id),
            "bbox": boxes[i][pred[i]].tolist(),
            "correct": bool(pred[i] == tgt[i]),
        })

"""The plain reference of ``scanrefer_ft``: the GPS model of
``reference/gps.py`` with ``GroundHeadV1`` and ``og3d_loss``, clip and
AdamW, and the sums of its evaluator, ``ScanReferEval``, written from the
published metric: per scene the predicted object is the argmax of the
og3d logits; it counts where that object is the target, or overlaps it by
IoU 0.25 / 0.5, over all scenes and over the unique and the multiple
ones."""

import torch

from benchmark.reference import gps

ANSWER = "og3d_logits"  # the output the evaluation's answers come from


def weights(config, seed, device):
    return gps.make_weights(gps.param_spec(config["run"]["model"]), seed,
                            device)


def optimised(config):
    run = config["run"]
    return list(gps.optimised(gps.param_spec(run["model"]), run))


def train(W, batches, config, seed, device, tf32=False, world=1):
    rows, opt = gps.train_steps(W, batches, config["run"], seed, device,
                                tf32=tf32, world=world)
    return rows, opt.m


def evaluate(W, batch, config, tf32=False):
    """The evaluation forward's answer output (``ANSWER``) on one batch."""
    return gps.eval_outputs(W, batch, config["run"], tf32=tf32)[ANSWER]


def answer_valid(batch):
    """Which entries of the answer output are real (B, O)."""
    return batch["obj_masks"].bool()


def answer_sums(logits, batch):
    """{metric: (value, count)} of the scenes' answers, from the og3d
    logits alone."""
    pred = logits.argmax(-1)
    rows = torch.arange(pred.shape[0], device=pred.device)
    total = pred.shape[0]
    mult = batch["is_multiple"].bool()
    iou25 = batch["tgt_object_id_iou25"][rows, pred].bool()
    iou50 = batch["tgt_object_id_iou50"][rows, pred].bool()
    n_mult = int(mult.sum())
    out = {"og_acc": (int((pred == batch["tgt_object_id"][:, 0]).sum()),
                      total)}
    for name, hit in (("iou25", iou25), ("iou50", iou50)):
        out[f"og_acc_{name}"] = (int(hit.sum()), total)
        out[f"og_acc_{name}_unique"] = (int((hit & ~mult).sum()),
                                        total - n_mult)
        out[f"og_acc_{name}_multiple"] = (int((hit & mult).sum()), n_mult)
    return out

"""The one traffic generator: a pool of host batches in the trainer's batch
schema, drawn from ``--seed`` by the parameters of a traffic file
(``benchmark/traffic/<name>.json``).

Every batch is drawn on the device with one generator and moved to the
host once. What a batch holds, per scene:
  * ``objects``: real objects drawn from [lo, hi], the rest padded (zero
    points, zero boxes, label -100, mask 0);
  * each object's points on the surface of a box of random proportions
    inside a room, 1024 of them, centred and scaled by their largest xyz
    norm as the data loader does, with a colour per object plus noise in
    [-1, 1];
  * ``utterance``: a [CLS] ... [SEP] sentence of [lo, hi] tokens padded to
    ``pad``; the masked-LM share of real tokens gets labels (80% [MASK], 10%
    a random id, 10% kept); with ``caption`` a scene caption the same way,
    unmasked;
  * grounding keys (``grounding: true``): the target's label, the
    objects within IoU 0.25 / 0.5 of it, ``is_multiple``, boxes.
"""

from __future__ import annotations

import numpy as np
import torch

VOCAB = 30522
CLS, SEP, MASK = 101, 102, 103
FIRST_WORD = 1000  # ids below are special or unused tokens


def _ints(g, lo, hi, shape, device):
    """Uniform integers in [lo, hi] (inclusive)."""
    return torch.randint(int(lo), int(hi) + 1, shape, generator=g,
                         device=device)


def _text(g, B, lo, hi, pad, device, mlm=0.0):
    n = _ints(g, lo, hi, (B,), device)
    pos = torch.arange(pad, device=device)[None]
    ids = _ints(g, FIRST_WORD, VOCAB - 1, (B, pad), device)
    ids = torch.where(pos == 0, CLS, ids)
    ids = torch.where(pos == n[:, None] - 1, SEP, ids)
    masks = pos < n[:, None]
    ids = torch.where(masks, ids, 0)
    labels = torch.full((B, pad), -1, dtype=torch.long, device=device)
    if mlm:
        words = masks & (pos > 0) & (pos < n[:, None] - 1)
        chosen = words & (torch.rand((B, pad), generator=g, device=device)
                          < mlm)
        labels = torch.where(chosen, ids, labels)
        u = torch.rand((B, pad), generator=g, device=device)
        rand_ids = _ints(g, FIRST_WORD, VOCAB - 1, (B, pad), device)
        ids = torch.where(chosen & (u < 0.8), MASK, ids)
        ids = torch.where(chosen & (u >= 0.8) & (u < 0.9), rand_ids, ids)
    return ids, masks.long(), labels


def _objects(g, B, O, P, lo, hi, room, device):
    """(obj_fts (B, O, P, 6), obj_locs (B, O, 6), obj_boxes, obj_masks)."""
    n = _ints(g, lo, hi, (B,), device)
    masks = torch.arange(O, device=device)[None] < n[:, None]
    size = 0.2 + 1.8 * torch.rand((B, O, 3), generator=g, device=device)
    size[..., 2] *= 0.6
    center = torch.rand((B, O, 3), generator=g, device=device) * torch.tensor(
        room, device=device)
    center[..., 2] = size[..., 2] / 2 + 0.3 * torch.rand(
        (B, O), generator=g, device=device)
    # a point on a random face of the unit box, then the object's size
    u = torch.rand((B, O, P, 3), generator=g, device=device) * 2 - 1
    face = torch.randint(0, 3, (B, O, P), generator=g, device=device)
    side = torch.randint(0, 2, (B, O, P), generator=g, device=device) * 2 - 1
    u = u.scatter(3, face[..., None], side[..., None].float())
    u = u + 0.01 * torch.randn((B, O, P, 3), generator=g, device=device)
    xyz = u * size[:, :, None] / 2
    xyz = xyz - xyz.mean(2, keepdim=True)
    scale = torch.linalg.norm(xyz, dim=3).amax(2).clamp_min(1e-6)
    xyz = xyz / scale[..., None, None]
    rgb = (torch.rand((B, O, 1, 3), generator=g, device=device) * 2 - 1
           + 0.1 * torch.randn((B, O, P, 3), generator=g, device=device))
    fts = torch.cat([xyz, rgb.clamp(-1, 1)], 3)
    fts = torch.where(masks[..., None, None], fts, torch.zeros_like(fts))
    locs = torch.cat([center, size], 2)
    locs = torch.where(masks[..., None], locs, torch.zeros_like(locs))
    return fts, locs, locs.clone(), masks


def _iou(boxes, t):
    """Axis-aligned IoU of every box (B, O, 6) with box ``t`` (B, 6)."""
    lo = torch.maximum(boxes[..., :3] - boxes[..., 3:] / 2,
                       (t[:, :3] - t[:, 3:] / 2)[:, None])
    hi = torch.minimum(boxes[..., :3] + boxes[..., 3:] / 2,
                       (t[:, :3] + t[:, 3:] / 2)[:, None])
    inter = (hi - lo).clamp_min(0).prod(-1)
    vol = boxes[..., 3:].prod(-1) + t[:, None, 3:].prod(-1)
    return inter / (vol - inter).clamp_min(1e-9)


def draw_batch(g, t: dict, device) -> dict:
    """One batch of the mix ``t`` from generator ``g``, on ``device``."""
    B, O, P = int(t["batch"]), int(t["max_objects"]), int(t["points"])
    fts, locs, boxes, masks = _objects(g, B, O, P, *t["objects"], t["room"],
                                       device)
    ids, tmask, labels = _text(g, B, *t["utterance"], t["utterance_pad"],
                               device, mlm=float(t.get("mlm", 0.0)))
    n_obj = masks.sum(1)
    tgt = (torch.rand((B,), generator=g, device=device) * n_obj).long()
    obj_labels = _ints(g, 0, 606, (B, O), device)
    out = {
        "txt_ids": ids, "txt_masks": tmask,
        "obj_fts": fts, "obj_locs": locs, "obj_masks": masks,
        "obj_sem_masks": (torch.rand((B, O), generator=g, device=device)
                          > float(t.get("sem_mask", 0.1))).long(),
        "obj_labels": torch.where(masks, obj_labels, -100),
        "tgt_object_id": tgt[:, None],
    }
    if t.get("mlm"):
        out["masked_lm_labels"] = labels
    if t.get("caption"):
        cid, cmask, _ = _text(g, B, *t["caption"], t["caption_pad"], device)
        out["scene_txt_ids"], out["scene_txt_masks"] = cid, cmask
    if t.get("grounding"):
        rows = torch.arange(B, device=device)
        iou = _iou(boxes, boxes[rows, tgt]) * masks
        tgt_label = obj_labels[rows, tgt]
        out.update(
            obj_boxes=boxes,
            tgt_object_label=tgt_label[:, None],
            tgt_object_id_iou25=(iou >= 0.25).long(),
            tgt_object_id_iou50=(iou >= 0.5).long(),
            is_multiple=((obj_labels == tgt_label[:, None]) & masks).sum(1) > 1,
        )
    return out


def draw_pool(t: dict, seed: int, device) -> list:
    """``t["pool"]`` distinct host batches (dicts of numpy arrays) from
    ``seed``; the same seed gives the same pool on one kind of device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pool = []
    for _ in range(int(t["pool"])):
        b = draw_batch(g, t, device)
        pool.append({k: v.cpu().numpy() for k, v in b.items()})
    return pool


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}

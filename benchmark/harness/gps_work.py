"""The work of one GPS step, counted from a batch's shapes and contents:
the model's products (for ``mfu``) and the least time of the fused
attention and set-abstraction kernels (for their ``roofline``), each
against the peak of the precision its configuration states.

Counting rules (the work the algorithm needs, whatever kernel does it):
  * products only (2 operations a multiply-add); a layer that the loss's
    gradient reaches counts its backward as twice its forward (input and
    weight gradients); layers no loss reads (the frozen PointNet++ and its
    ``fc``, the class heads read by the metrics alone) run forward only;
    recomputed work is not counted;
  * rows: the real ones, whose outputs something reads (real text tokens,
    real objects); padded rows count only where a loss reads them: the
    pretrain loss's scene embedding is the mean over every object slot,
    padded ones included, so there the vision tower (PointNet++ and the
    spatial transformer) counts every slot;
  * attention counts each needed query against its scene's real keys;
  * the set abstraction counts, as the published bound of its kernel does,
    layer 1 once per point that a pair uses plus its centring term once per
    centre, layers 2-3 once per pooled (centre, point) pair (the first
    ``nsample`` in-ball points in index order; point 0 for an empty ball);
    bytes: each input read once, each output written once;
  * furthest point sampling: 8 operations per point and step (the distance),
    the points read and the centres and indices written once.
"""

from __future__ import annotations

import torch

from benchmark.harness import peaks
from benchmark.reference import gps

SA_LEVELS = [  # (npoint, nsample, radius, widths); GroupAll last
    (32, 32, 0.2, (6, 64, 64, 128)),
    (16, 32, 0.4, (131, 128, 128, 256)),
]


def _sa_pairs(xyz, centers, radius, ns):
    d2 = gps._sq3(xyz[:, None, :, :] - centers[:, :, None, :])
    within = d2 < torch.tensor(radius * radius, dtype=torch.float32)
    take = within & (within.cumsum(-1) <= ns)
    take[..., 0] |= ~within.any(-1)
    return int(take.sum()), int(take.any(1).sum())


@torch.no_grad()
def sa_work(pts, device, block=4096):
    """[(G, N, C, m, pairs, points, widths)] of the two sampled SA levels
    on objects (G, P, 6)."""
    pts = torch.as_tensor(pts, device=device).float()
    out = []
    for m, ns, r, widths in SA_LEVELS:
        G, N, C = pts.shape
        pairs = points = 0
        cens = []
        for s in range(0, G, block):
            xyz = pts[s:s + block, :, :3].contiguous()
            idx = gps.fps(xyz, m)
            cen = torch.gather(xyz, 1, idx[..., None].expand(*idx.shape, 3))
            a, b = _sa_pairs(xyz, cen, r, ns)
            pairs, points = pairs + a, points + b
            cens.append(cen)
        out.append((G, N, C, m, pairs, points, widths))
        pts = torch.cat(cens)  # the next level's xyz (its features unread)
        pts = torch.cat([pts, pts.new_zeros(G, m, widths[-1])], -1)
    return out


def sa_least_s(levels) -> float:
    """Least seconds of the step's ``fps`` and ``sv_sa_fwd`` launches."""
    t = 0.0
    for G, N, C, m, pairs, points, (c, h1, h2, h3) in levels:
        t += peaks.least_s(G * N * 12 + G * m * 16,
                           {"f32": 8 * (m - 1) * G * N})
        w_bytes = 2 * (c * h1 + h1 * h2 + h2 * h3) + 8 * (h1 + h2 + h3)
        nbytes = 4 * (G * N * C + G * m * 3 + G * m * h3) + w_bytes
        flops = 2 * (points * c * h1 + G * m * 3 * h1
                     + pairs * (h1 * h2 + h2 * h3))
        t += peaks.least_s(nbytes, {"bf16": flops})
    return t


def sa_flops(levels, G_all, D) -> float:
    """bf16 operations of the frozen PointNet++ MLPs (three levels)."""
    f = 0.0
    for G, N, C, m, pairs, points, (c, h1, h2, h3) in levels:
        f += 2 * (points * c * h1 + G * m * 3 * h1
                  + pairs * (h1 * h2 + h2 * h3))
    return f + 2 * G_all * 16 * (259 * 256 + 256 * 512 + 512 * D)


def _pairs(q, k) -> float:
    """Query-key pairs of a layer: sum over scenes of q_b k_b."""
    return float((q * k).sum())


def mha_least_s(q, k, D, H, train, gate=False) -> float:
    """Least seconds of one attention layer's ``mha_fwd`` (and, training,
    ``mha_bwd``) over scenes of ``q`` needed queries and ``k`` real keys
    (per-scene counts): q, o and their gradients at the needed rows, k, v
    and theirs at the real keys, float32 products at the 3xTF32 rate."""
    nq, nk, pairs = float(q.sum()), float(k.sum()), _pairs(q, k)
    f4 = 4
    fwd_b = f4 * (2 * nq * D + 2 * nk * D + nq + H * nq)
    g_b = f4 * (H * nq * 6 + pairs * 5) if gate else 0
    t = peaks.least_s(fwd_b + g_b, {"3xtf32": 4 * D * pairs})
    if train:
        bwd_b = f4 * (4 * nq * D + 4 * nk * D + nq + H * nq)
        g_b = f4 * (2 * H * nq * 6 + pairs * 5) if gate else 0
        t += peaks.least_s(bwd_b + g_b, {"3xtf32": 8 * D * pairs})
    return t


def step_work(batch: dict, config: dict, train: bool, device) -> dict:
    """{"flops": {precision: operations}, "mha_s", "sa_fwd_s"} of one step
    (``train``) or one evaluation forward of the configuration on the host
    ``batch``."""
    model = config["run"]["model"]
    lang = model["language"]["args"]
    D, H = int(lang["hidden_size"]), int(lang["num_attention_heads"])
    nl = int(lang["num_hidden_layers"])
    vis, gr = model["vision"]["args"], model["grounding"]["args"]
    ff, gff = int(vis["dim_feedforward"]), int(gr["dim_feedforward"])
    heads = model["heads"]["head_list"]
    losses = set(model["loss_list"]) if train else set()
    back = 3 if train else 1  # forward + input and weight gradients
    B, O = batch["obj_masks"].shape
    tv = torch.as_tensor(batch["txt_masks"]).sum(1).double()
    ov = torch.as_tensor(batch["obj_masks"]).sum(1).double()
    full = torch.full_like(ov, O)
    # the scene embedding (a mean over every slot) reads the padded objects
    vis_rows = full if "TextSceneBetweenBatch" in losses else ov
    layer = 4 * D * D
    mac, fwd, mha = 0.0, 0.0, 0.0  # mac: through the loss; fwd: read alone
    # utterance tower over its real tokens
    mac += nl * (float(tv.sum()) * (layer + 2 * D * 3072)
                 + 2 * D * _pairs(tv, tv))
    mha += nl * mha_least_s(tv, tv, D, H, train)
    if "scene_txt_ids" in batch:
        # the caption tower; its last layer's query is the [CLS] row alone
        cv = torch.as_tensor(batch["scene_txt_masks"]).sum(1).double()
        mac += (nl - 1) * (float(cv.sum()) * (layer + 2 * D * 3072)
                           + 2 * D * _pairs(cv, cv))
        mac += float(cv.sum()) * 2 * D * D + B * (2 * D * D + 2 * D * 3072)
        mac += 2 * D * float(cv.sum())
        mha += (nl - 1) * mha_least_s(cv, cv, D, H, train)
    # frozen PointNet++ and its fc on the needed objects, forward only
    masks = torch.as_tensor(batch["obj_masks"]).bool()
    pts = torch.as_tensor(batch["obj_fts"])
    needed = (pts.reshape(-1, *pts.shape[2:]) if vis_rows is full
              else pts[masks])
    levels = sa_work(needed, device)
    G = float(vis_rows.sum())
    fwd += G * D * D + float(ov.sum()) * D * 607  # fc; the raw class scores
    # spatial transformer (its input is detached from the PointNet++)
    ns = int(vis["num_layers"])
    mac += ns * (float(vis_rows.sum()) * (layer + D * 6 * H + 2 * D * ff
                                          + 6 * D)
                 + (2 * D + 6 * H) * _pairs(vis_rows, ov))
    mha += ns * mha_least_s(vis_rows, ov, D, H, train, gate=True)
    # unified encoder over the real text tokens and objects
    nu = int(gr["num_layers"])
    tok = tv + ov
    mac += nu * (float(tok.sum()) * (layer + 2 * D * gff)
                 + float(ov.sum()) * 6 * D + 2 * D * _pairs(tok, tok))
    mha += nu * mha_least_s(tok, tok, D, H, train)
    if "pretrain_head" in heads:
        V = int(model["heads"]["pretrain_head"]["args"].get("vocab_size",
                                                            30522))
        K = int(model.get("lm_max_predictions", 0)) or batch[
            "txt_ids"].shape[1]
        lm = torch.as_tensor(batch["masked_lm_labels"]) != -1
        rows = float(lm.sum(1).clamp(max=K).sum())
        mac += rows * (D * D + D * V)  # the LM head at the real masked rows
        mac += float(ov.sum()) * D + 2 * B * B * D  # the two contrasts
        # the object class head and the og3d dot product the metrics read
        fwd += float(ov.sum()) * (D * D + D * 607 + D)
    if "ground_head" in heads:
        a = model["heads"]["ground_head"]["args"]
        hid, nc = int(a["hidden_size"]), int(a["sem_cls_size"])
        og = float(ov.sum()) * (D * hid + hid)
        if "og3d_loss" in losses:
            mac += og
        else:
            fwd += og
        # the class heads read detached inputs and carry no loss
        fwd += (B + 2 * float(ov.sum())) * (D * hid + hid * nc)
    flops32 = 2 * (back * mac + fwd)
    return {"flops": {"3xtf32": flops32, "bf16": sa_flops(levels, G, D)},
            "mha_s": mha, "sa_fwd_s": sa_least_s(levels)}

"""Plain PyTorch reference of the GPS model, its losses and its optimizer.

Written from the published model (SceneVerse / GPS: ``OpenVocab`` with a
frozen PointNet++, a spatial 'cond' transformer, a BERT text tower, the
unified encoder and the pretrain or grounding head) as functions over a
dict of named weights. It imports nothing of the measured program: the
names of the weights are the published checkpoint's, which the program
loads by name.

Precision follows the configuration's ``precision`` block: every part in
float32 with TF32 off, except the frozen PointNet++ set-abstraction MLPs,
whose products take bfloat16 operands and float32 sums, with the rounding
points the configuration states (``precision.frozen_sa``). ``tf32=True``
(``precision_context``) computes the float32 products in TF32: the control
that a check of a float32 configuration has to fail.

Dropout: the reference draws its masks from two generators on the device,
seeded as the configuration's ``rng_seed`` says (``DropoutStreams``):
hidden dropout from ``torch.empty(shape).bernoulli_(keep)`` on the first,
in the order the model applies it; the fused attention's probability
dropout from a counter hash (``hash_keep_mask``) whose per-call seed is the
next ``randint(0, 2**31 - 1, (1,))`` of the second. Those are the draws the
configuration states (``dropout`` block), not the program's state. Over a
data-parallel world the batch is the global one, each rank's block of rows
masked from that rank's two streams.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30
LOG1E6 = math.log(1e-6)


def heads_of(W) -> int:
    """The towers' number of attention heads: the spatial layers' gate
    projection has 6 outputs a head."""
    return W["point_encoder.spatial_encoder.0.self_attn.lang_cond_fc.weight"
             ].shape[0] // 6


# --------------------------------------------------------------- precision
@contextlib.contextmanager
def precision_context(tf32: bool = False):
    """float32 products in full float32 (``tf32=False``) or in TF32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def bf16(x):
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------------ weights
def _lin(name, dout, din, bias=True, std=0.02):
    out = [(f"{name}.weight", (dout, din), ("normal", std))]
    if bias:
        out.append((f"{name}.bias", (dout,), ("zeros",)))
    return out


def _ln(name, dim):
    return [(f"{name}.weight", (dim,), ("ones",)),
            (f"{name}.bias", (dim,), ("zeros",))]


def param_spec(model: dict) -> list:
    """[(name, shape, init)] of every weight and buffer the configuration's
    model holds, in a fixed order. ``model`` is the configuration's
    ``model`` block; widths are read from it."""
    lang = model["language"]["args"]
    D, H = int(lang["hidden_size"]), int(lang["num_attention_heads"])
    vis = model["vision"]["args"]
    gr = model["grounding"]["args"]
    heads = model["heads"]
    V = int(heads["pretrain_head"]["args"].get("vocab_size", 30522)
            if "pretrain_head" in heads else 30522)
    L_lang = int(lang["num_hidden_layers"])
    ff = int(vis["dim_feedforward"])
    spec = []
    p = "lang_encoder.model"
    spec += [(f"{p}.embeddings.word_embeddings.weight", (30522, D),
              ("normal", .02)),
             (f"{p}.embeddings.position_embeddings.weight", (512, D),
              ("normal", .02)),
             (f"{p}.embeddings.token_type_embeddings.weight", (2, D),
              ("normal", .02))]
    spec += _ln(f"{p}.embeddings.LayerNorm", D)
    for i in range(L_lang):
        q = f"{p}.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            spec += _lin(f"{q}.attention.self.{n}", D, D)
        spec += _lin(f"{q}.attention.output.dense", D, D)
        spec += _ln(f"{q}.attention.output.LayerNorm", D)
        spec += _lin(f"{q}.intermediate.dense", 3072, D)
        spec += _lin(f"{q}.output.dense", D, 3072)
        spec += _ln(f"{q}.output.LayerNorm", D)
    v = "point_encoder"
    spec.append((f"{v}.text_features", (607, D), ("normal", .02)))
    widths = [[6, 64, 64, 128], [131, 128, 128, 256], [259, 256, 512, D]]
    for li, w in enumerate(widths):
        for j in range(3):
            q = f"{v}.point_feature_extractor.encoder.{li}.mlps.0.layer{j}"
            spec.append((f"{q}.conv.weight", (w[j + 1], w[j]),
                         ("normal", math.sqrt(2.0 / w[j]))))
            b = f"{q}.bn.bn"
            spec += [(f"{b}.weight", (w[j + 1],), ("around", 1.0, 0.1)),
                     (f"{b}.bias", (w[j + 1],), ("around", 0.0, 0.1)),
                     (f"{b}.running_mean", (w[j + 1],), ("around", 0.0, 0.1)),
                     (f"{b}.running_var", (w[j + 1],), ("variance",)),
                     (f"{b}.num_batches_tracked", (), ("count",))]
    spec += _lin(f"{v}.point_feature_extractor.fc", D, D,
                 std=math.sqrt(2.0 / D))
    spec += _lin(f"{v}.sem_cls_embed_layer.0", D, D)
    spec += _ln(f"{v}.sem_cls_embed_layer.1", D)
    spec.append((f"{v}.sem_mask_embeddings.weight", (1, 768), ("normal", .02)))
    for i in range(int(vis["num_layers"])):
        q = f"{v}.spatial_encoder.{i}"
        for n in ("w_qs", "w_ks", "w_vs", "fc"):
            spec += _lin(f"{q}.self_attn.{n}", D, D)
        spec += _lin(f"{q}.self_attn.lang_cond_fc", H * 6, D)
        spec += _lin(f"{q}.linear1", ff, D) + _lin(f"{q}.linear2", D, ff)
        spec += _ln(f"{q}.norm1", D) + _ln(f"{q}.norm2", D)
    spec += _lin(f"{v}.loc_layers.0.0", D, 6) + _ln(f"{v}.loc_layers.0.1", D)
    u = "unified_encoder"
    gff = int(gr["dim_feedforward"])
    for i in range(int(gr["num_layers"])):
        q = f"{u}.unified_encoder.{i}"
        spec += [(f"{q}.self_attn.in_proj_weight", (3 * D, D), ("normal", .02)),
                 (f"{q}.self_attn.in_proj_bias", (3 * D,), ("zeros",))]
        spec += _lin(f"{q}.self_attn.out_proj", D, D)
        spec += _lin(f"{q}.linear1", gff, D) + _lin(f"{q}.linear2", D, gff)
        spec += _ln(f"{q}.norm1", D) + _ln(f"{q}.norm2", D)
    spec += _lin(f"{u}.loc_layers.0.0", D, 6) + _ln(f"{u}.loc_layers.0.1", D)
    spec.append((f"{u}.token_type_embeddings.weight", (2, D), ("normal", .02)))
    if "pretrain_head" in heads["head_list"]:
        for n, vocab in (("lm_pred_head", V), ("obj_pred_head", 607)):
            q = f"pretrain_head.{n}"
            spec.append((f"{q}.bias", (vocab,), ("zeros",)))
            spec += _lin(f"{q}.transform.dense", D, D)
            spec += _ln(f"{q}.transform.LayerNorm", D)
            spec.append((f"{q}.decoder.weight", (vocab, D), ("normal", .02)))
    if "ground_head" in heads["head_list"]:
        a = heads["ground_head"]["args"]
        hid, ncls = int(a["hidden_size"]), int(a["sem_cls_size"])
        for n, out in (("og3d_head", 1), ("txt_clf_head", ncls),
                       ("obj3d_clf_head", ncls), ("obj3d_clf_pre_head", ncls)):
            q = f"ground_head.{n}"
            spec += _lin(f"{q}.0", hid, D) + _ln(f"{q}.2", hid)
            spec += _lin(f"{q}.4", out, hid)
    return spec


def make_weights(spec: list, seed: int, device) -> dict:
    """The weights of ``spec`` from ``seed``: one normal draw for all of
    them on ``device`` (a generator there), cut into leaves and scaled.
    The same seed and device give the same weights."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = sum(math.prod(s) for _, s, init in spec
            if init[0] in ("normal", "around", "variance"))
    flat = torch.randn(n, generator=g, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        k = math.prod(shape)
        kind = init[0]
        if kind == "zeros":
            t = torch.zeros(shape, device=device)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            z = flat[off:off + k].view(shape)
            off += k
            if kind == "normal":
                t = z * init[1]
            elif kind == "around":
                t = init[1] + init[2] * z
            else:  # a running variance: 1 + 0.25 |z|
                t = 1.0 + 0.25 * z.abs()
        out[name] = t
    return out


# ------------------------------------------------------------------ dropout
def hash_keep_mask(B, H, L, T, seed, keep, device):
    """(B, H, L, T) keep mask of the fused attention's counter hash: the
    murmur3 finaliser of ``r*T + c + (seed + b*H + h) * 0x9E3779B9`` (uint32
    arithmetic), its top 24 bits as a uniform in [0, 1)."""
    M = 0xFFFFFFFF
    bh = torch.arange(B * H, device=device, dtype=torch.int64).view(B, H, 1, 1)
    s = (seed.reshape(1, 1, 1, 1).to(torch.int64) + bh) & M
    r = torch.arange(L, device=device, dtype=torch.int64).view(1, 1, L, 1)
    c = torch.arange(T, device=device, dtype=torch.int64).view(1, 1, 1, T)
    x = (r * T + c + s * 0x9E3779B9) & M
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u < torch.tensor(keep, dtype=torch.float32)


class DropoutStreams:
    """The dropout streams of a training world (``train=True``), or none
    (evaluation). Each of the ``world`` data-parallel ranks holds the rows
    of its equal block of the global batch and draws their masks from two
    generators of its own, seeded ``rng_seed + 2000006 r`` and one more
    (the configuration's ``dropout.ranks``); a world of 1 is rank 0."""

    def __init__(self, seed: int, device, train: bool = True, world: int = 1):
        self.train, self.world = train, world
        if train:
            self.hidden, self.attn = [], []
            for r in range(world):
                base = int(seed) + 2_000_006 * r
                for gens, s in ((self.hidden, base), (self.attn, base + 1)):
                    g = torch.Generator(device=device)
                    g.manual_seed(s)
                    gens.append(g)

    def blocks(self, n):
        """The rows of each rank: [slice] over a global batch of ``n``."""
        b = n // self.world
        return [slice(r * b, (r + 1) * b) for r in range(self.world)]

    def drop(self, x, p=0.1):
        if not self.train or p == 0.0:
            return x
        keep = 1.0 - p
        mask = torch.cat([
            torch.empty(x[rows].shape, device=x.device).bernoulli_(
                keep, generator=g)
            for rows, g in zip(self.blocks(x.shape[0]), self.hidden)])
        return x * mask / keep

    def attn_keep(self, B, H, L, T, keep, device):
        """The (B, H, L, T) keep mask of one attention call: each rank's
        rows from the counter hash under the next seed of its stream."""
        return torch.cat([
            hash_keep_mask(rows.stop - rows.start, H, L, T, torch.randint(
                0, 2 ** 31 - 1, (1,), generator=g, device=device), keep,
                device)
            for rows, g in zip(self.blocks(B), self.attn)])


# ---------------------------------------------------------------- pointnet
def _sq3(d):
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


@torch.no_grad()
def fps(xyz, npoint):
    """Furthest point sampling (G, N, 3) -> (G, npoint) indices: the first
    point first; points within 1e-3 of the origin (squared norm) never
    chosen; ties to the lowest index."""
    G, N, _ = xyz.shape
    valid = _sq3(xyz) > 1e-3
    mind = torch.full((G, N), 1e10, device=xyz.device)
    idx = torch.zeros((G, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(G, device=xyz.device)
    last = torch.zeros(G, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        d = _sq3(xyz - xyz[rows, last][:, None])
        mind = torch.where(valid, torch.minimum(mind, d), mind)
        last = torch.where(valid, mind, torch.full_like(mind, -1.0)).argmax(1)
        idx[:, j] = last
    return idx


def fold(W, prefix):
    """The three (bf16 weight (Cin, H), scale, shift) of a frozen SA MLP:
    eval BatchNorm folded into the product's epilogue."""
    out = []
    for j in range(3):
        q = f"{prefix}.layer{j}"
        w = W[f"{q}.conv.weight"]
        a = W[f"{q}.bn.bn.weight"] / torch.sqrt(W[f"{q}.bn.bn.running_var"]
                                                + 1e-5)
        b = W[f"{q}.bn.bn.bias"] - W[f"{q}.bn.bn.running_mean"] * a
        out.append((w.t().to(torch.bfloat16).float(), a, b))
    return out


def sa_level(pts, npoint, nsample, radius, layers, block=2048):
    """One frozen set abstraction: (G, N, C) xyz-first points -> (centers
    (G, m, 3), pooled (G, m, H3)). The configuration's rounding points:
    layer 1 per point as bf16(bf16(p) w1) less the centre's term bf16(c) w1
    [xyz rows], each layer's input rounded to bf16, float32 sums; the pool
    is the max over the first ``nsample`` points in the ball (strict d2 <
    r^2) in index order, and over point 0 for an empty ball."""
    (w1, a1, b1), (w2, a2, b2), (w3, a3, b3) = layers
    G, N, _ = pts.shape
    cen_all, pooled_all = [], []
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    for s in range(0, G, block):
        p = pts[s:s + block]
        g = p.shape[0]
        xyz = p[..., :3].contiguous()
        idx = fps(xyz, npoint)
        cen = torch.gather(xyz, 1, idx[..., None].expand(g, npoint, 3))
        pw = bf16(bf16(p) @ w1)  # (g, N, H1)
        cw = bf16(cen) @ w1[:3]  # (g, m, H1)
        d2 = _sq3(p[:, None, :, :3] - cen[:, :, None, :])  # (g, m, N)
        within = d2 < r2
        if nsample >= N:
            first = torch.zeros_like(within)
            first[..., 0] = True
            take = torch.where(within.any(-1, keepdim=True), within, first)
            h1 = bf16(torch.relu(a1 * (pw[:, None] - cw[:, :, None]) + b1))
            h2 = bf16(torch.relu(h1 @ w2 * a2 + b2))
            h3 = torch.relu(h2 @ w3 * a3 + b3)  # (g, m, N, H3)
            h3 = torch.where(take[..., None], h3,
                             torch.full_like(h3, -3.0e38))
            pooled = h3.amax(2)
        else:
            order = torch.arange(N, device=p.device)
            key = torch.where(within, order, order + N)
            sel = torch.topk(key, nsample, dim=-1, largest=False,
                             sorted=True).values
            sel = torch.where(sel >= N, sel - N, sel)
            count = within.sum(-1)
            firsts = sel[..., :1]
            sel = torch.where(torch.arange(nsample, device=p.device)
                              < count[..., None], sel, firsts)
            sel = torch.where(count[..., None] > 0, sel, torch.zeros_like(sel))
            gh = torch.gather(pw[:, None].expand(g, npoint, N, pw.shape[-1]),
                              2, sel[..., None].expand(*sel.shape,
                                                       pw.shape[-1]))
            h1 = bf16(torch.relu(a1 * gh + (b1 - a1 * cw[:, :, None])))
            h2 = bf16(torch.relu(h1 @ w2 * a2 + b2))
            pooled = torch.relu(h2 @ w3 * a3 + b3).amax(2)
        cen_all.append(cen)
        pooled_all.append(pooled)
    return torch.cat(cen_all), torch.cat(pooled_all)


@torch.no_grad()
def pointnet(W, pts):
    """Frozen PointNet++ of (G, 1024, 6) objects -> (G, 768) float32."""
    pre = "point_encoder.point_feature_extractor"
    levels = [(32, 32, 0.2), (16, 32, 0.4)]
    x = pts.float()
    for li, (m, ns, r) in enumerate(levels):
        cen, pooled = sa_level(x, m, ns, r,
                               fold(W, f"{pre}.encoder.{li}.mlps.0"))
        x = torch.cat([cen, pooled], -1)
    G, N, C = x.shape
    h = x.reshape(G * N, C)
    layers = fold(W, f"{pre}.encoder.2.mlps.0")
    for j, (w, a, b) in enumerate(layers):
        h = torch.relu(bf16(h) @ w * a + b)
        if j < 2:
            h = bf16(h)
    h = h.reshape(G, N, -1).amax(1)
    return F.linear(h, W[f"{pre}.fc.weight"], W[f"{pre}.fc.bias"])


# -------------------------------------------------------------- attention
def _heads(x, H):
    B, L, W = x.shape
    return x.reshape(B, L, H, W // H).transpose(1, 2)


def _merge(x):
    B, H, L, dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * dh)


def attention(q, k, v, H, pad_add, streams, rate, gate=None):
    """softmax(q k^T / sqrt(dh) + pad [+ gate]) v over (B, L, H dh) packed
    heads, with the counter-hash probability dropout at ``rate``. ``gate``
    (sw (B, H, L, 6), pairwise locs (B, L, T, 5)) adds max(log_sigmoid(sw
    . [1, locs]), log 1e-6), forced to log 1e-6 at pad keys."""
    B, L, _ = q.shape
    T = k.shape[1]
    s = (_heads(q, H) @ _heads(k, H).transpose(-1, -2)) / math.sqrt(
        q.shape[-1] // H)
    pad = pad_add[:, None, None, :]
    s = s + pad
    if gate is not None:
        sw, locs = gate
        z = sw[..., :1] + torch.einsum("bhld,bltd->bhlt", sw[..., 1:], locs)
        loc = torch.where(pad < -1.0, torch.full_like(z, LOG1E6),
                          torch.clamp(F.logsigmoid(z), min=LOG1E6))
        s = s + loc
    p = torch.softmax(s, -1)
    if rate > 0.0 and streams.train:
        keep = 1.0 - rate
        mask = streams.attn_keep(B, H, L, T, keep, q.device)
        inv = torch.tensor(1.0 / keep, dtype=torch.float32)
        p = torch.where(mask, p * inv.to(q.device), torch.zeros_like(p))
    return _merge(p @ _heads(v, H))


def lin(W, name, x):
    return F.linear(x, W[f"{name}.weight"], W.get(f"{name}.bias"))


def ln(W, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"],
                        W[f"{name}.bias"], eps)


# ----------------------------------------------------------------- towers
def bert(W, ids, masks, streams, cls_only=False):
    """The BERT text tower: (B, L) ids -> (B, L, 768), or (B, 1, 768) of
    the [CLS] row when ``cls_only`` (its last layer's query is that row)."""
    p = "lang_encoder.model"
    H = heads_of(W)
    L = ids.shape[1]
    pos = torch.arange(L, device=ids.device)
    x = (F.embedding(ids, W[f"{p}.embeddings.word_embeddings.weight"])
         + W[f"{p}.embeddings.position_embeddings.weight"][pos][None]
         + W[f"{p}.embeddings.token_type_embeddings.weight"][0])
    x = streams.drop(ln(W, f"{p}.embeddings.LayerNorm", x, 1e-12))
    pad_add = (1.0 - masks.float()) * torch.finfo(torch.float32).min
    n = sum(1 for k in W if k.startswith(f"{p}.encoder.layer.")
            and k.endswith("attention.self.query.weight"))
    for i in range(n):
        q = f"{p}.encoder.layer.{i}"
        last = cls_only and i == n - 1
        if last:
            res = x[:, :1]
            qh = _heads(lin(W, f"{q}.attention.self.query", res), H)
            kh = _heads(lin(W, f"{q}.attention.self.key", x), H)
            vh = _heads(lin(W, f"{q}.attention.self.value", x), H)
            s = ((qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
                 + pad_add[:, None, None, :])
            a = _merge(streams.drop(torch.softmax(s, -1)) @ vh)
        else:
            res = x
            a = attention(lin(W, f"{q}.attention.self.query", x),
                          lin(W, f"{q}.attention.self.key", x),
                          lin(W, f"{q}.attention.self.value", x), H,
                          pad_add, streams, 0.1)
        x = ln(W, f"{q}.attention.output.LayerNorm",
               streams.drop(lin(W, f"{q}.attention.output.dense", a)) + res,
               1e-12)
        h = F.gelu(lin(W, f"{q}.intermediate.dense", x))
        x = ln(W, f"{q}.output.LayerNorm",
               streams.drop(lin(W, f"{q}.output.dense", h)) + x, 1e-12)
    return x


def pairwise_locs(centers, eps=1e-10):
    """[dist / max dist, dz / dist, dist_xy / dist, dy / dist_xy, dx /
    dist_xy] of every ordered pair of objects (B, O, O, 5)."""
    d = centers[:, :, None, :] - centers[:, None, :, :]
    dist = torch.sqrt((d * d).sum(3) + eps)
    dist2 = torch.sqrt((d[..., :2] * d[..., :2]).sum(3) + eps)
    mx = dist.reshape(dist.shape[0], -1).amax(1)
    return torch.stack([dist / mx[:, None, None], d[..., 2] / dist,
                        dist2 / dist, d[..., 1] / dist2, d[..., 0] / dist2], 3)


def ffn(W, q, x, streams, act):
    h = act(lin(W, f"{q}.linear1", x))
    return lin(W, f"{q}.linear2", streams.drop(h))


def vision(W, obj_fts, obj_locs, obj_masks, streams):
    """The vision tower: (post-fusion-ready object embeddings (B, O, 768),
    pre embeddings, softmax class scores)."""
    B, O = obj_fts.shape[:2]
    v = "point_encoder"
    H = heads_of(W)
    feats = pointnet(W, obj_fts.reshape(B * O, *obj_fts.shape[2:]))
    x = streams.drop(feats.reshape(B, O, -1)).detach()
    sem = torch.softmax(x @ W[f"{v}.text_features"].t(), 2)
    pre = x
    locs = pairwise_locs(obj_locs[..., :3])
    pad_add = torch.where(obj_masks.bool(), 0.0, NEG)
    i = 0
    while f"{v}.spatial_encoder.{i}.norm1.weight" in W:
        q = f"{v}.spatial_encoder.{i}"
        x = x + ln(W, f"{v}.loc_layers.0.1",
                   lin(W, f"{v}.loc_layers.0.0", obj_locs), 1e-5)
        sw = lin(W, f"{q}.self_attn.lang_cond_fc", x).reshape(
            B, O, H, 6).transpose(1, 2)
        a = attention(lin(W, f"{q}.self_attn.w_qs", x),
                      lin(W, f"{q}.self_attn.w_ks", x),
                      lin(W, f"{q}.self_attn.w_vs", x), H, pad_add, streams,
                      0.0, gate=(sw, locs))
        a = lin(W, f"{q}.self_attn.fc", a)
        x = ln(W, f"{q}.norm1", x + streams.drop(a), 1e-5)
        x = ln(W, f"{q}.norm2", x + streams.drop(ffn(W, q, x, streams, F.gelu)),
               1e-5)
        i += 1
    return x, pre, sem


def unified(W, txt, txt_masks, obj, obj_locs, obj_masks, streams):
    u = "unified_encoder"
    Lt = txt.shape[1]
    valid = torch.cat([txt_masks.bool(), obj_masks.bool()], 1)
    pad_add = torch.where(valid, 0.0, NEG)
    tt = W[f"{u}.token_type_embeddings.weight"]
    types = torch.cat([tt[0].expand(*txt.shape), tt[1].expand(*obj.shape)], 1)
    i = 0
    while f"{u}.unified_encoder.{i}.norm1.weight" in W:
        q = f"{u}.unified_encoder.{i}"
        obj = obj + ln(W, f"{u}.loc_layers.0.1",
                       lin(W, f"{u}.loc_layers.0.0", obj_locs), 1e-5)
        x = torch.cat([txt, obj], 1) + types
        qkv = F.linear(x, W[f"{q}.self_attn.in_proj_weight"],
                       W[f"{q}.self_attn.in_proj_bias"])
        a = attention(*qkv.chunk(3, -1), heads_of(W), pad_add, streams, 0.1)
        a = lin(W, f"{q}.self_attn.out_proj", a)
        x = ln(W, f"{q}.norm1", x + streams.drop(a), 1e-5)
        x = ln(W, f"{q}.norm2", x + streams.drop(ffn(W, q, x, streams, F.relu)),
               1e-5)
        txt, obj = x[:, :Lt], x[:, Lt:]
        i += 1
    return txt, obj


def lm_head(W, name, x):
    h = ln(W, f"{name}.transform.LayerNorm",
           F.gelu(lin(W, f"{name}.transform.dense", x)), 1e-5)
    return h @ W[f"{name}.decoder.weight"].t() + W[f"{name}.bias"]


def mlp_head(W, name, x, streams, p):
    h = ln(W, f"{name}.2", torch.relu(lin(W, f"{name}.0", x)), 1e-12)
    return lin(W, f"{name}.4", streams.drop(h, p))


# ------------------------------------------------------------------ losses
def ce(logits, labels):
    """Per-row cross entropy (labels clamped into range)."""
    lf = logits.float()
    safe = labels.clamp(0, lf.shape[-1] - 1).long()
    return torch.logsumexp(lf, -1) - torch.gather(lf, -1, safe[..., None])[..., 0]


def l2n(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def infonce(a, b):
    scale = min(1.0 / 0.07, 100.0)
    labels = torch.arange(a.shape[0], device=a.device)
    return (ce(scale * (b @ a.t()), labels).mean()
            + ce(scale * (a @ b.t()), labels).mean()) / 2


def forward(W, batch, model_cfg, streams):
    """The model's forward on one batch: {name: tensor} of what the heads
    and losses read (the program's output names)."""
    heads = model_cfg["heads"]["head_list"]
    txt = bert(W, batch["txt_ids"], batch["txt_masks"], streams)
    out = {}
    if "scene_txt_ids" in batch:
        out["scene_text_embed"] = bert(W, batch["scene_txt_ids"],
                                       batch["scene_txt_masks"], streams,
                                       cls_only=True)[:, 0]
    obj, pre, sem = vision(W, batch["obj_fts"], batch["obj_locs"],
                           batch["obj_masks"], streams)
    out["obj_cls_raw_logits"] = sem
    if "scene_txt_ids" in batch:
        out["scene_embed"] = obj.mean(1)
    tf, of = unified(W, txt, batch["txt_masks"], obj, batch["obj_locs"],
                     batch["obj_masks"], streams)
    out["cls"], out["obj_fuse"] = tf[:, 0], of
    masks = batch["obj_masks"].bool()
    if "pretrain_head" in heads:
        K = int(model_cfg.get("lm_max_predictions", 0))
        labels = batch["masked_lm_labels"]
        rows = tf
        if K and K < tf.shape[1]:
            idx = torch.argsort((labels == -1).to(torch.int8), dim=1,
                                stable=True)[:, :K]
            labels = torch.gather(labels, 1, idx)
            rows = torch.gather(tf, 1, idx[..., None].expand(*idx.shape,
                                                            tf.shape[-1]))
        out["txt_lm_cls_logits"] = lm_head(W, "pretrain_head.lm_pred_head",
                                           rows)
        out["masked_lm_labels"] = labels
    if "ground_head" in heads:
        p = float(model_cfg["heads"]["ground_head"]["args"].get("dropout", 0.0))
        og = mlp_head(W, "ground_head.og3d_head", of, streams, p)[..., 0]
        out["og3d_logits"] = og.masked_fill(~masks, float("-inf"))
        # the auxiliary heads read detached inputs and carry no configured
        # loss; their dropout draws keep the streams' order
        for key, n, x in (("txt_cls_logits", "txt_clf_head", out["cls"]),
                          ("obj_cls_post_logits", "obj3d_clf_head", of),
                          ("obj_cls_pre_logits", "obj3d_clf_pre_head", pre)):
            out[key] = mlp_head(W, f"ground_head.{n}", x.detach(), streams, p)
    return out


def losses(out, batch, model_cfg):
    """The configured losses of one forward: {name: scalar}, ``total_loss``
    the sum of ``loss_list``."""
    masks = batch["obj_masks"].bool()
    got = {}
    if "txt_lm_cls_logits" in out:
        labels = out["masked_lm_labels"]
        valid = (labels != -1).float()
        got["lm_cls_loss"] = ((ce(out["txt_lm_cls_logits"], labels) * valid
                               ).sum() / valid.sum().clamp_min(1.0))
        o = l2n(out["obj_fuse"].float())
        t = l2n(out["cls"].float())
        lg = torch.einsum("bod,bd->bo", o, t).masked_fill(~masks, float("-inf"))
        got["TextObjWithinBatch"] = ce(lg, batch["tgt_object_id"][:, -1]).mean()
        got["TextSceneBetweenBatch"] = infonce(
            l2n(out["scene_embed"].float()), l2n(out["scene_text_embed"].float()))
    if "og3d_logits" in out:
        got["og3d_loss"] = ce(out["og3d_logits"],
                              batch["tgt_object_id"][:, 0]).mean()
    got["total_loss"] = sum(got[k] for k in model_cfg["loss_list"])
    return got


# --------------------------------------------------------------- optimizer
def no_decay(name: str) -> bool:
    """Biases and LayerNorm scales take no weight decay."""
    if name.endswith("bias"):
        return True
    norms = ("LayerNorm.weight", "norm1.weight", "norm2.weight",
             "loc_layers.0.1.weight", "sem_cls_embed_layer.1.weight")
    return name.endswith(norms) or (name.startswith("ground_head.")
                                    and name.endswith(".2.weight"))


def optimised(spec, cfg) -> dict:
    """{name: base lr} of every optimised weight: the groups of the
    configuration's towers and heads, the frozen PointNet++ and the buffers
    left out."""
    m, lr = cfg["model"], float(cfg["solver"]["lr"])

    def group_lr(node):
        return float(node.get("lr", lr)) if isinstance(node, dict) else lr

    tops = {"lang_encoder": group_lr(m["language"]),
            "point_encoder": group_lr(m["vision"]),
            "unified_encoder": group_lr(m["grounding"])}
    for h in m["heads"]["head_list"]:
        tops[h] = group_lr(m["heads"][h])
    out = {}
    for name, _, init in spec:
        if init[0] == "count" or name.endswith(
                ("text_features", "running_mean", "running_var")):
            continue
        if name.startswith("point_encoder.point_feature_extractor"):
            continue
        out[name] = tops[name.split(".")[0]]
    return out


def lr_ratio(step: int, cfg) -> float:
    """warmup_cosine: the warmup (``warmup_steps`` x ``num_gpu``) from 0,
    then a cosine to ``minimum_ratio``."""
    args = cfg["solver"]["sched"]["args"]
    warm = int(args["warmup_steps"]) * int(cfg.get("num_gpu", 1))
    total = int(cfg.get("total_steps") or warm + 1)  # read past the warmup
    if warm > 0 and step <= warm:
        return step / warm
    cos = 0.5 * (1 + math.cos((step - warm) / max(total - warm, 1) * math.pi))
    return max(cos, float(args.get("minimum_ratio", 1e-5)))


class AdamW:
    """Global-norm clip then AdamW (decoupled decay, bias-corrected moments,
    eps outside the root) over ``params`` {name: base lr}."""

    def __init__(self, W, params: dict, cfg):
        s = cfg["solver"]
        self.b1, self.b2 = (float(b) for b in s["optim"]["args"]["betas"])
        self.eps = float(s["optim"]["args"].get("eps", 1e-8))
        self.wd = float(s["optim"]["args"].get("weight_decay", 0.01))
        self.clip = s.get("grad_norm")
        self.params, self.cfg, self.t = params, cfg, 0
        self.m = {n: torch.zeros_like(W[n]) for n in params}
        self.v = {n: torch.zeros_like(W[n]) for n in params}

    @torch.no_grad()
    def step(self, W, grads):
        g = {n: grads.get(n) if grads.get(n) is not None
             else torch.zeros_like(W[n]) for n in self.params}
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(x) for x in g.values()]))
            if norm >= float(self.clip):
                g = {n: x / norm * float(self.clip) for n, x in g.items()}
        ratio = lr_ratio(self.t, self.cfg)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, base in self.params.items():
            lr = base * ratio
            wd = 0.0 if no_decay(n) else self.wd
            p = W[n]
            p.mul_(1 - lr * wd)
            self.m[n].mul_(self.b1).add_(g[n], alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g[n], g[n], value=1 - self.b2)
            denom = (self.v[n] / c2).sqrt() + self.eps
            p.sub_(lr * (self.m[n] / c1) / denom)


def train_steps(W, batches, cfg, seed, device, tf32=False, world=1):
    """The configuration's training from weights ``W`` over ``batches``
    (global batches, one optimizer step each, the rows split over a
    data-parallel ``world`` as ``DropoutStreams`` says): returns (per-step
    losses [{name: float}], the AdamW state); ``W`` is updated in place.
    ``tf32`` computes the float32 products in TF32."""
    spec_params = optimised(param_spec(cfg["model"]), cfg)
    for n in spec_params:
        W[n].requires_grad_(True)
    opt = AdamW(W, spec_params, cfg)
    streams = DropoutStreams(seed, device, world=world)
    rows = []
    names = list(spec_params)
    with precision_context(tf32):
        for batch in batches:
            got = losses(forward(W, batch, cfg["model"], streams), batch,
                         cfg["model"])
            grads = torch.autograd.grad(got["total_loss"],
                                        [W[n] for n in names],
                                        allow_unused=True)
            rows.append({k: float(v.detach()) for k, v in got.items()})
            del got
            opt.step(W, dict(zip(names, grads)))
            del grads
    for n in spec_params:
        W[n].requires_grad_(False)
    return rows, opt


@torch.no_grad()
def eval_outputs(W, batch, cfg, tf32=False):
    """The model's evaluation forward (no dropout) on one batch."""
    with precision_context(tf32):
        return forward(W, batch, cfg["model"], DropoutStreams(0, None,
                                                              train=False))

"""Transformer layer library of the GPS towers and the grounding variants
(port of sceneverse_tpu/modules/layers/transformers.py; reference
modules/layers/transformers.py):
  * ``MultiHeadAttention``: torch ``nn.MultiheadAttention`` names, the
    packed ``in_proj_weight`` when the key and value widths are the model's,
    separate ``q_proj`` / ``k_proj`` / ``v_proj`` otherwise;
  * ``CrossAttentionLayer``, ``TransformerDecoderLayer``,
    ``TransformerEncoderLayer`` (post-norm, or pre-norm with ``prenorm``);
  * ``MultiHeadAttentionSpatial`` in every fusion ('mul', 'bias', 'add',
    'ctx', 'cond'), single- or multi-head spatial weights, any
    ``spatial_dim``; ``TransformerSpatialDecoderLayer`` and
    ``TransformerSpatialEncoderLayer``.

Attention routes as in the JAX package: the fused kernel
(``ops/mha.py``) under its gate ``SCENEVERSE_FUSED_MHA`` (default on) when
no ``attn_mask`` is given and the head layout fits; then flash attention
(``ops/attention.py``) where probability dropout is inactive; else the
plain path with ``softmax_lowp``. The spatial layer takes the fused kernel
only in the multi-head 'cond' fusion at ``spatial_dim`` 5 (its in-kernel
gate); the other fusions are plain PyTorch, as they are plain XLA in JAX
(``transformers.py:409-414`` there says why). Attention layers return
``None`` for the attention weights, which no caller reads. LayerNorm eps
is 1e-5. The JAX package's ``_ln_split`` (``SCENEVERSE_LN_BARRIER``) is an
XLA fusion barrier and numerically a no-op, so it is not ported."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sceneverse_tpu_torch.modules.utils import (AttentionSeed, Dropout,
                                                get_activation_fn)
from sceneverse_tpu_torch.ops.attention import flash_enabled, masked_mha
from sceneverse_tpu_torch.ops.mha import (LOG1E6, fused_mha,
                                          fused_mha_enabled,
                                          fused_mha_supported)
from sceneverse_tpu_torch.ops.softmax import softmax_lowp
from sceneverse_tpu_torch.utils.precision import LayerNorm


def _heads(x, n_head):  # (B, T, H*dh) -> (B, H, T, dh)
    B, T, D = x.shape
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2)


def _merge(x):  # (B, H, L, dh) -> (B, L, H*dh)
    B, H, L, dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * dh)


class MultiHeadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``-named attention; batch-first."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0,
                 kdim=None, vdim=None):
        super().__init__()
        assert d_model % n_head == 0
        self.d_model, self.n_head = d_model, n_head
        self.d_head = d_model // n_head
        self.same_dims = ((kdim is None or kdim == d_model)
                          and (vdim is None or vdim == d_model))
        if self.same_dims:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model,
                                                           d_model))
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        else:
            self.q_proj = nn.Linear(d_model, d_model)
            self.k_proj = nn.Linear(kdim or d_model, d_model)
            self.v_proj = nn.Linear(vdim or d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout)
        self.seed = AttentionSeed()
        if self.same_dims:
            nn.init.normal_(self.in_proj_weight, std=0.02)

    def _project(self, query, key, value):
        if not self.same_dims:
            return self.q_proj(query), self.k_proj(key), self.v_proj(value)
        w, b, d = self.in_proj_weight, self.in_proj_bias, self.d_model
        if query is key and key is value:
            return F.linear(query, w, b).chunk(3, dim=-1)
        return (F.linear(query, w[:d], b[:d]),
                F.linear(key, w[d:2 * d], b[d:2 * d]),
                F.linear(value, w[2 * d:], b[2 * d:]))

    def forward(self, query, key, value, key_padding_mask=None,
                attn_mask=None):
        """JAX ``transformers.py:97-177``: the fused kernel when no
        ``attn_mask`` is given, its gate is on and it takes the layout; else
        flash attention when probability dropout is inactive, no
        ``attn_mask`` is given and its gate is on; else the plain path
        (compute-dtype logits, -inf where ``attn_mask`` or the key pad is
        True, ``softmax_lowp``, probability dropout). Queries (B, L, D)
        attend to keys (B, T, kdim) with L and T free."""
        q, k, v = self._project(query, key, value)
        p = self.attn_dropout.p
        scale = 1.0 / math.sqrt(self.d_head)
        d = self.d_model
        if (attn_mask is None and fused_mha_enabled()
                and fused_mha_supported(d, self.n_head)):
            rate = p if self.training else 0.0
            out = fused_mha(q, k, v, self.n_head,
                            key_padding_mask=key_padding_mask,
                            dropout_rate=rate,
                            seed=self.seed.draw() if rate > 0.0 else None,
                            scale=scale)
            return self.out_proj(out), None
        q, k, v = (_heads(t, self.n_head) for t in (q, k, v))
        if ((p == 0.0 or not self.training) and attn_mask is None
                and flash_enabled()):
            out = masked_mha(q, k, v, key_padding_mask, sm_scale=scale)
        else:
            logits = (q @ k.transpose(-1, -2)) / math.sqrt(self.d_head)
            if attn_mask is not None:
                logits = logits.masked_fill(attn_mask, -torch.inf)
            if key_padding_mask is not None:
                logits = logits.masked_fill(
                    key_padding_mask[:, None, None, :], -torch.inf)
            out = self.attn_dropout(softmax_lowp(logits, v.dtype)) @ v
        return self.out_proj(_merge(out)), None


class _FFN(nn.Module):
    """The feed-forward block and dropouts the layers share (torch names:
    ``linear1``, ``dropout``, ``linear2``)."""

    def _ffn_init(self, d_model, dim_feedforward, dropout, activation):
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.dropout = Dropout(dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.activation = get_activation_fn(activation)

    def _ffn(self, x):
        return self.linear2(self.dropout(self.activation(self.linear1(x))))


class CrossAttentionLayer(_FFN):
    """Cross-attention + FFN, pre- or post-norm (reference
    transformers.py:12-63). Keeps the reference's quirks that JAX keeps:
    pre-norm, the FFN reads ``norm3`` of the attention's residual sum;
    post-norm, it reads the attention's output; ``norm2`` is never used."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu", k_dim=None, v_dim=None, prenorm=True):
        super().__init__()
        self.prenorm = prenorm
        self.multihead_attn = MultiHeadAttention(
            d_model, nhead, dropout=dropout, kdim=k_dim, vdim=v_dim)
        self._ffn_init(d_model, dim_feedforward, dropout, activation)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def forward(self, tgt, memory, memory_key_padding_mask=None,
                memory_mask=None):
        tgt2 = self.norm1(tgt) if self.prenorm else tgt
        tgt2, _ = self.multihead_attn(
            tgt2, memory, memory, key_padding_mask=memory_key_padding_mask,
            attn_mask=memory_mask)
        tgt = tgt + self.dropout2(tgt2)
        if self.prenorm:
            tgt2 = self.norm3(tgt)
        else:  # the FFN reads the attention's output, as in JAX
            tgt = self.norm1(tgt)
        tgt = tgt + self.dropout3(self._ffn(tgt2))
        if not self.prenorm:
            tgt = self.norm3(tgt)
        return tgt, None


class TransformerDecoderLayer(_FFN):
    """Pre-norm self-attention, cross-attention and FFN (reference
    transformers.py:66-112)."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nhead,
                                                 dropout=dropout)
        self._ffn_init(d_model, dim_feedforward, dropout, activation)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def _self(self, tgt2, tgt_key_padding_mask, tgt_pairwise_locs=None):
        return self.self_attn(tgt2, tgt2, tgt2,
                              key_padding_mask=tgt_key_padding_mask)

    def forward(self, tgt, memory, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, tgt_pairwise_locs=None):
        tgt2 = self.norm1(tgt)
        tgt2, _ = self._self(tgt2, tgt_key_padding_mask, tgt_pairwise_locs)
        tgt = tgt + self.dropout1(tgt2)
        tgt2, _ = self.multihead_attn(
            self.norm2(tgt), memory, memory,
            key_padding_mask=memory_key_padding_mask)
        tgt = tgt + self.dropout2(tgt2)
        tgt = tgt + self.dropout3(self._ffn(self.norm3(tgt)))
        return tgt, None, None


class TransformerEncoderLayer(_FFN):
    """Post-norm encoder layer, or pre-norm with ``prenorm`` (reference
    transformers.py:115-154). Pre-norm keeps the JAX package's reading of
    the reference: the FFN and its residual take ``norm2`` of the
    attention's residual sum."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu", prenorm=False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self._ffn_init(d_model, dim_feedforward, dropout, activation)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.prenorm = prenorm

    def forward(self, tgt, tgt_key_padding_mask=None):
        tgt2 = self.norm1(tgt) if self.prenorm else tgt
        tgt2, _ = self.self_attn(tgt2, tgt2, tgt2,
                                 key_padding_mask=tgt_key_padding_mask)
        tgt = tgt + self.dropout1(tgt2)
        if self.prenorm:
            tgt = self.norm2(tgt)
            return tgt + self.dropout2(self._ffn(tgt)), None
        tgt = self.norm1(tgt)
        return self.norm2(tgt + self.dropout2(self._ffn(tgt))), None


class MultiHeadAttentionSpatial(nn.Module):
    """Attention fused with pairwise spatial features (reference
    transformers.py:157-239), every fusion of the JAX package:
      * 'mul': relu(loc_fc(locs)) per head, added as its log;
      * 'bias': loc_fc(locs) added to the logits;
      * 'add': (softmax(logits) + softmax(loc_fc(locs))) / 2;
      * 'ctx': the queries against ``pairwise_loc_fc(locs)`` per head as a
        second set of logits;
      * 'cond' (GPS): a per-query gate from the pre-projection query
        (``lang_cond_fc``), ``max(log_sigmoid(sw . [1, locs]), log 1e-6)``.
    ``spatial_multihead=False`` shares one spatial head among all heads.
    No probability dropout on any route, in training too."""

    def __init__(self, d_model, n_head, dropout=0.1, spatial_multihead=True,
                 spatial_dim=5, spatial_attn_fusion="cond"):
        super().__init__()
        assert d_model % n_head == 0
        self.n_head, self.d_model = n_head, d_model
        self.d_per_head = d_model // n_head
        self.spatial_multihead = spatial_multihead
        self.spatial_dim = spatial_dim
        self.spatial_attn_fusion = spatial_attn_fusion
        self.spatial_n_head = n_head if spatial_multihead else 1
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        if spatial_attn_fusion in ("mul", "bias", "add"):
            self.pairwise_loc_fc = nn.Linear(spatial_dim, self.spatial_n_head)
        elif spatial_attn_fusion == "ctx":
            self.pairwise_loc_fc = nn.Linear(spatial_dim, d_model)
        elif spatial_attn_fusion == "cond":
            self.lang_cond_fc = nn.Linear(
                d_model, self.spatial_n_head * (spatial_dim + 1))
        else:
            raise NotImplementedError(
                f"unsupported spatial_attn_fusion {spatial_attn_fusion}")

    def _loc_logits(self, q, q_in, pairwise_locs):
        """The spatial term (B, H, L, T) of each fusion, before masking."""
        B, L, _ = q_in.shape
        H, fusion = self.n_head, self.spatial_attn_fusion
        if fusion in ("mul", "bias", "add"):
            loc = self.pairwise_loc_fc(pairwise_locs).permute(0, 3, 1, 2)
            if fusion == "mul":
                loc = torch.relu(loc)
            return loc.expand(-1, H, -1, -1) if not self.spatial_multihead \
                else loc
        if fusion == "ctx":
            loc = self.pairwise_loc_fc(pairwise_locs)  # (B, L, T, D)
            loc = loc.reshape(*loc.shape[:3], H, self.d_per_head)
            return (torch.einsum("bhlk,blthk->bhlt", q, loc)
                    / math.sqrt(self.d_per_head))
        sw = self.lang_cond_fc(q_in).reshape(B, L, self.spatial_n_head,
                                             self.spatial_dim + 1)
        sw = sw.transpose(1, 2).expand(-1, H, -1, -1)  # (B, H, L, sd+1)
        with torch.autocast(q_in.device.type, enabled=False):
            # JAX promotes the einsum to the f32 of the locations
            loc = torch.einsum("bhld,bltd->bhlt", sw[..., 1:].float(),
                               pairwise_locs.float()) + sw[..., :1].float()
            return torch.clamp_min(F.logsigmoid(loc), LOG1E6)

    def forward(self, q_in, k_in, v_in, pairwise_locs, key_padding_mask=None):
        """The fused kernel for the multi-head 'cond' fusion at
        ``spatial_dim`` 5 when its gate is on and it takes the layout; else
        the plain path of JAX ``transformers.py:364-449``: each fusion's
        spatial term, masked at pad keys as there (-inf on the logits; on
        the spatial term log 1e-6 for 'cond', 0 for 'mul', -inf otherwise),
        then the fusion's softmax."""
        B, L, _ = q_in.shape
        H = self.n_head
        q2, k2, v2 = self.w_qs(q_in), self.w_ks(k_in), self.w_vs(v_in)
        scale = 1.0 / math.sqrt(self.d_per_head)
        fusion = self.spatial_attn_fusion
        if (fusion == "cond" and self.spatial_multihead
                and self.spatial_dim == 5 and fused_mha_enabled()
                and fused_mha_supported(self.d_model, H)):
            sw = self.lang_cond_fc(q_in).reshape(B, L, H, 6).transpose(1, 2)
            out = fused_mha(q2, k2, v2, H, key_padding_mask=key_padding_mask,
                            gate_sw=sw, locs=pairwise_locs, scale=scale)
            return self.fc(out.to(v2.dtype)), None
        q, k, v = (_heads(t, H) for t in (q2, k2, v2))
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(self.d_per_head)
        loc = self._loc_logits(q, q_in, pairwise_locs)
        if key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
            attn = attn.masked_fill(mask, -torch.inf)
            fill = {"cond": LOG1E6, "mul": 0.0}.get(fusion, -torch.inf)
            loc = loc.masked_fill(mask, fill)
        if fusion == "add":
            fused = (torch.softmax(attn.float(), dim=3)
                     + torch.softmax(loc.float(), dim=3)) / 2
        else:
            if fusion == "mul":
                loc = torch.log(torch.clamp_min(loc, 1e-6)).to(attn.dtype)
            elif fusion == "cond":
                loc = loc.to(attn.dtype)
            fused = softmax_lowp(loc + attn, v.dtype)
        out = _merge(fused.to(v.dtype) @ v)
        return self.fc(out), None


class TransformerSpatialDecoderLayer(TransformerDecoderLayer):
    """Decoder layer whose self-attention is spatial (reference
    transformers.py:242-282)."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu", spatial_multihead=True, spatial_dim=5,
                 spatial_attn_fusion="mul"):
        super().__init__(d_model, nhead, dim_feedforward=dim_feedforward,
                         dropout=dropout, activation=activation)
        self.self_attn = MultiHeadAttentionSpatial(
            d_model, nhead, dropout=dropout,
            spatial_multihead=spatial_multihead, spatial_dim=spatial_dim,
            spatial_attn_fusion=spatial_attn_fusion)

    def _self(self, tgt2, tgt_key_padding_mask, tgt_pairwise_locs=None):
        return self.self_attn(tgt2, tgt2, tgt2, tgt_pairwise_locs,
                              key_padding_mask=tgt_key_padding_mask)

    def forward(self, tgt, memory, tgt_pairwise_locs,
                tgt_key_padding_mask=None, memory_key_padding_mask=None):
        return super().forward(
            tgt, memory, tgt_key_padding_mask=tgt_key_padding_mask,
            memory_key_padding_mask=memory_key_padding_mask,
            tgt_pairwise_locs=tgt_pairwise_locs)


class TransformerSpatialEncoderLayer(TransformerEncoderLayer):
    """Post-norm encoder layer with spatial self-attention (reference
    transformers.py:285-316): always post-norm."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu", spatial_multihead=True, spatial_dim=5,
                 spatial_attn_fusion="cond"):
        super().__init__(d_model, nhead, dim_feedforward=dim_feedforward,
                         dropout=dropout, activation=activation)
        self.self_attn = MultiHeadAttentionSpatial(
            d_model, nhead, dropout=dropout,
            spatial_multihead=spatial_multihead, spatial_dim=spatial_dim,
            spatial_attn_fusion=spatial_attn_fusion)

    def forward(self, tgt, tgt_pairwise_locs, tgt_key_padding_mask=None):
        tgt2, _ = self.self_attn(tgt, tgt, tgt, tgt_pairwise_locs,
                                 key_padding_mask=tgt_key_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(tgt2))
        return self.norm2(tgt + self.dropout2(self._ffn(tgt))), None

"""Transformer layers of the GPS towers (port of
sceneverse_tpu/modules/layers/transformers.py): ``MultiHeadAttention`` with
the packed in-projection (:97-139 there), the post-norm
``TransformerEncoderLayer``, ``MultiHeadAttentionSpatial`` in 'cond' mode
(:338-449) and ``TransformerSpatialEncoderLayer``. Attention routes as in
the JAX package: the fused kernel (``ops/mha.py``) under its gate
``SCENEVERSE_FUSED_MHA`` (default on); with it off, flash attention
(``ops/attention.py``) or the plain path with ``softmax_lowp``. LayerNorm
eps is 1e-5 here."""

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


class MultiHeadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``-named (packed ``in_proj_weight``)
    attention; batch-first."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        assert d_model % n_head == 0
        self.d_model, self.n_head = d_model, n_head
        self.d_head = d_model // n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout)
        self.seed = AttentionSeed()
        nn.init.normal_(self.in_proj_weight, std=0.02)

    def forward(self, query, key, value, key_padding_mask=None):
        """JAX ``transformers.py:97-177``: the fused kernel when its gate is
        on and takes the layout; else flash attention when probability
        dropout is inactive and its gate is on; else the plain path
        (compute-dtype logits, -inf at pad keys, ``softmax_lowp``,
        probability dropout)."""
        w, b, d = self.in_proj_weight, self.in_proj_bias, self.d_model
        if query is key and key is value:
            q, k, v = F.linear(query, w, b).chunk(3, dim=-1)
        else:
            q = F.linear(query, w[:d], b[:d])
            k = F.linear(key, w[d:2 * d], b[d:2 * d])
            v = F.linear(value, w[2 * d:], b[2 * d:])
        p = self.attn_dropout.p
        scale = 1.0 / math.sqrt(self.d_head)
        if fused_mha_enabled() and fused_mha_supported(d, self.n_head):
            rate = p if self.training else 0.0
            out = fused_mha(q, k, v, self.n_head,
                            key_padding_mask=key_padding_mask,
                            dropout_rate=rate,
                            seed=self.seed.draw() if rate > 0.0 else None,
                            scale=scale)
            return self.out_proj(out), None
        B, L, _ = q.shape
        q, k, v = (_heads(t, self.n_head) for t in (q, k, v))
        if (p == 0.0 or not self.training) and flash_enabled():
            out = masked_mha(q, k, v, key_padding_mask, sm_scale=scale)
        else:
            logits = (q @ k.transpose(-1, -2)) / math.sqrt(self.d_head)
            if key_padding_mask is not None:
                logits = logits.masked_fill(
                    key_padding_mask[:, None, None, :], -torch.inf)
            out = self.attn_dropout(softmax_lowp(logits, v.dtype)) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, L, d)), None


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (reference transformers.py:115-154)."""

    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1,
                 activation="relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.dropout = Dropout(dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = get_activation_fn(activation)

    def _ffn(self, tgt):
        return self.linear2(self.dropout(self.activation(self.linear1(tgt))))

    def forward(self, tgt, tgt_key_padding_mask=None):
        tgt2, _ = self.self_attn(tgt, tgt, tgt,
                                 key_padding_mask=tgt_key_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(tgt2))
        return self.norm2(tgt + self.dropout2(self._ffn(tgt))), None


class MultiHeadAttentionSpatial(nn.Module):
    """Spatial attention, 'cond' fusion (reference transformers.py:206-232):
    per-query gate weights from the pre-projection query, gate computed
    inside the fused kernel from the pairwise locations."""

    def __init__(self, d_model, n_head, dropout=0.1, spatial_multihead=True,
                 spatial_dim=5, spatial_attn_fusion="cond"):
        super().__init__()
        if not (spatial_attn_fusion == "cond" and spatial_multihead
                and spatial_dim == 5):
            raise NotImplementedError(
                "only the multi-head 'cond' fusion with spatial_dim=5 is "
                "ported")
        self.n_head, self.d_model = n_head, d_model
        self.d_per_head = d_model // n_head
        self.spatial_dim = spatial_dim
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.lang_cond_fc = nn.Linear(d_model, n_head * (spatial_dim + 1))

    def forward(self, q_in, k_in, v_in, pairwise_locs, key_padding_mask=None):
        """The fused kernel when its gate is on and takes the layout, else
        the plain 'cond' path of JAX ``transformers.py:364-449``: the gate
        ``max(log_sigmoid(sw . [1, locs]), log 1e-6)``, log 1e-6 and -inf at
        pad keys, added to the compute-dtype logits, ``softmax_lowp``, no
        probability dropout (in training too)."""
        B, L, _ = q_in.shape
        H = self.n_head
        q2, k2, v2 = self.w_qs(q_in), self.w_ks(k_in), self.w_vs(v_in)
        sw = self.lang_cond_fc(q_in).reshape(B, L, H, self.spatial_dim + 1)
        sw = sw.transpose(1, 2)  # (B, H, L, 6)
        scale = 1.0 / math.sqrt(self.d_per_head)
        if fused_mha_enabled() and fused_mha_supported(self.d_model, H):
            out = fused_mha(q2, k2, v2, H, key_padding_mask=key_padding_mask,
                            gate_sw=sw, locs=pairwise_locs, scale=scale)
            return self.fc(out.to(v2.dtype)), None
        q, k, v = (_heads(t, H) for t in (q2, k2, v2))
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(self.d_per_head)
        with torch.autocast(q_in.device.type, enabled=False):
            # JAX promotes the einsum to the f32 of the locations
            loc = torch.einsum("bhld,bltd->bhlt", sw[..., 1:].float(),
                               pairwise_locs.float()) + sw[..., :1].float()
            loc = torch.clamp_min(F.logsigmoid(loc), LOG1E6)
        if key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
            attn = attn.masked_fill(mask, -torch.inf)
            loc = loc.masked_fill(mask, LOG1E6)
        attn = softmax_lowp(loc.to(attn.dtype) + attn, v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, L, self.d_model)
        return self.fc(out), None


class TransformerSpatialEncoderLayer(TransformerEncoderLayer):
    """Post-norm encoder layer with spatial self-attention
    (reference transformers.py:285-316)."""

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

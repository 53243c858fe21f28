"""4-layer BERT text tower with HF parameter names (port of
sceneverse_tpu/modules/language/bert.py; reference modules/language/bert.py
wraps HF ``BertModel``). Self-attention takes the JAX package's routes
(``BertSelfAttention.forward``) with HF's additive pad row
``(1 - mask) * finfo(f32).min``; the ``cls_only`` final layer (:207-228
there) computes only the [CLS] query row in plain torch, as the JAX package
runs it outside its kernels. LayerNorm eps 1e-12, exact GELU."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from sceneverse_tpu_torch.modules.build import LANGUAGE_REGISTRY
from sceneverse_tpu_torch.modules.utils import AttentionSeed, Dropout
from sceneverse_tpu_torch.ops.attention import flash_enabled, masked_mha
from sceneverse_tpu_torch.ops.mha import (fused_mha, fused_mha_enabled,
                                          fused_mha_supported)
from sceneverse_tpu_torch.ops.softmax import softmax_lowp


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 4
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.dropout(self.LayerNorm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)
        self.seed = AttentionSeed()

    def _plain(self, q, k, v, pad_add):
        """(B, H, Lq, dh) heads: compute-dtype logits, the additive pad row,
        f32 softmax with a v.dtype residual, probability dropout."""
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        logits = logits + pad_add[:, None, None, :].to(logits.dtype)
        return self.dropout(softmax_lowp(logits, v.dtype)) @ v

    def forward(self, x, pad_add, q_rows=None):
        """JAX ``bert.py:87-158``: the fused kernel when its gate is on and
        takes the layout; else flash attention when probability dropout is
        inactive and its gate is on; else the plain path. The ``cls_only``
        query rows always take the plain path."""
        B, L, D = x.shape
        H, dh = self.num_heads, self.head_dim
        heads = lambda t: t.reshape(B, -1, H, dh).transpose(1, 2)
        if q_rows is not None:
            # [CLS]-only query rows against full-length keys/values
            out = self._plain(heads(self.query(x[:, :q_rows])),
                              heads(self.key(x)), heads(self.value(x)),
                              pad_add)
            return out.transpose(1, 2).reshape(B, q_rows, D)
        q2, k2, v2 = self.query(x), self.key(x), self.value(x)
        if fused_mha_enabled() and fused_mha_supported(D, H):
            rate = self.dropout.p if self.training else 0.0
            return fused_mha(q2, k2, v2, H, pad_additive=pad_add,
                             dropout_rate=rate,
                             seed=self.seed.draw() if rate > 0.0 else None,
                             scale=1.0 / math.sqrt(dh))
        q, k, v = heads(q2), heads(k2), heads(v2)
        if (self.dropout.p == 0.0 or not self.training) and flash_enabled():
            out = masked_mha(q, k, v, pad_add < -1.0,
                             sm_scale=1.0 / math.sqrt(dh))
        else:
            out = self._plain(q, k, v, pad_add)
        return out.transpose(1, 2).reshape(B, L, D)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dropout(self.dense(hidden)) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, pad_add, q_rows=None):
        residual = x if q_rows is None else x[:, :q_rows]
        return self.output(self.self(x, pad_add, q_rows), residual)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class BertOutput(BertSelfOutput):
    def __init__(self, cfg: BertConfig):
        super().__init__(cfg)
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x, pad_add, q_rows=None):
        x = self.attention(x, pad_add, q_rows)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers)])


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids, attention_mask, cls_only: bool = False):
        """last_hidden_state (B, L, D), or (B, 1, D) with ``cls_only``."""
        x = self.embeddings(input_ids)
        pad_add = ((1.0 - attention_mask.float())
                   * torch.finfo(torch.float32).min)
        last = len(self.encoder.layer) - 1
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, pad_add, q_rows=1 if (cls_only and i == last) else None)
        return x


@LANGUAGE_REGISTRY.register()
class BERTLanguageEncoder(nn.Module):
    """reference modules/language/bert.py:7-26 (random init; converted
    checkpoints load on top)."""

    def __init__(self, cfg=None, weights: str = "bert-base-uncased",
                 hidden_size: int = 768, num_hidden_layers: int = 4,
                 num_attention_heads: int = 12, type_vocab_size: int = 2):
        super().__init__()
        del weights
        self.model = BertModel(BertConfig(
            hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            type_vocab_size=type_vocab_size))

    def forward(self, txt_ids, txt_masks, cls_only: bool = False):
        return self.model(txt_ids, txt_masks, cls_only=cls_only)

"""Masked-LM pretrain heads (port of
sceneverse_tpu/modules/heads/pretrain_head.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sceneverse_tpu_torch.modules.build import HEADS_REGISTRY
from sceneverse_tpu_torch.utils.precision import LayerNorm


class BertPredictionHeadTransform(nn.Module):
    """dense -> exact GELU -> LayerNorm(eps 1e-5)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x):
        return self.LayerNorm(F.gelu(self.dense(x), approximate="none"))


class BertLMPredictionHead(nn.Module):
    """transform -> decoder (no bias) + standalone bias, added in the
    decoder's compute dtype as the JAX package does."""

    def __init__(self, hidden_size: int, vocab_size: int):
        super().__init__()
        self.transform = BertPredictionHeadTransform(hidden_size)
        self.decoder = nn.Linear(hidden_size, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x):
        h = self.decoder(self.transform(x))
        return h + self.bias.to(h.dtype)


@HEADS_REGISTRY.register()
class PretrainHeadV1(nn.Module):
    """The masked-LM head alone over the BERT vocab (reference :36-43).
    Its signature is the JAX package's: the text embeddings, and keywords
    only."""

    def __init__(self, cfg=None, hidden_size=768, vocab_size=30522):
        super().__init__()
        self.lm_pred_head = BertLMPredictionHead(hidden_size, vocab_size)

    def forward(self, txt_embeds, **kwargs):
        return self.lm_pred_head(txt_embeds)


@HEADS_REGISTRY.register()
class OVPretrainHead(nn.Module):
    """LM head over the BERT vocab + 607-way object head (reference :46-56)."""

    def __init__(self, cfg=None, hidden_size=768, vocab_size=30522,
                 obj_vocab_size=607):
        super().__init__()
        self.lm_pred_head = BertLMPredictionHead(hidden_size, vocab_size)
        self.obj_pred_head = BertLMPredictionHead(hidden_size, obj_vocab_size)

    def forward(self, txt_embeds, obj_embeds, **kwargs):
        return self.lm_pred_head(txt_embeds), self.obj_pred_head(obj_embeds)

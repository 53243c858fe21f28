"""CLIP text encoder (port of sceneverse_tpu/modules/language/clip.py; the
reference wraps HF ``CLIPTextModelWithProjection``, reference
modules/language/clip.py:11-28): causal self-attention, pre-LN blocks,
quick-GELU MLP, a final LayerNorm and a bias-free text projection, with
HF's parameter names (``text_model.encoder.layers.N.self_attn.q_proj``,
...). ``CLIPLanguageEncoder`` projects every token of the last hidden
state, L2-normalises it and optionally runs an MLP head on it.

Attention is plain PyTorch with ``softmax_lowp`` (compute-dtype logits,
f32 softmax), as the JAX package runs it in plain XLA; it is not routed
to the fused kernel, which the JAX package does not route it to either.
No network access is assumed: the ``weights`` name is not fetched, the
weights are random unless a converted checkpoint is loaded on top. A
text longer than ``max_position_embeddings`` (77) raises."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from sceneverse_tpu_torch.modules.build import LANGUAGE_REGISTRY
from sceneverse_tpu_torch.modules.utils import get_mlp_head
from sceneverse_tpu_torch.ops.softmax import softmax_lowp
from sceneverse_tpu_torch.utils.precision import Embedding, LayerNorm


@dataclass
class CLIPTextConfig:
    """Defaults: the openai/clip-vit-large-patch14 text tower."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF ``quick_gelu``: x * sigmoid(1.702 x), CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = Embedding(cfg.max_position_embeddings,
                                            cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class CLIPAttention(nn.Module):
    """HF CLIPAttention: q scaled per head, an additive mask."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = D // cfg.num_attention_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor):
        B, L, D = x.shape
        heads = lambda t: t.reshape(B, L, self.num_heads,
                                    self.head_dim).transpose(1, 2)
        q = heads(self.q_proj(x)) * self.head_dim ** -0.5
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = q @ k.transpose(-1, -2)
        logits = logits + attn_bias.to(logits.dtype)
        out = softmax_lowp(logits, v.dtype) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block (HF CLIPEncoderLayer)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, attn_bias):
        x = x + self.self_attn(self.layer_norm1(x), attn_bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, attn_bias):
        for layer in self.layers:
            x = layer(x, attn_bias)
        return x


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size,
                                          eps=cfg.layer_norm_eps)

    def forward(self, input_ids, attention_mask=None):
        """last_hidden_state (B, L, D); ``attention_mask`` 1 = keep. The
        causal mask and the pad row add up as HF adds them, each
        ``finfo(f32).min`` (-inf where both mask a key)."""
        L = input_ids.shape[1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(
                f"CLIP text of {L} tokens: the position table has "
                f"{self.cfg.max_position_embeddings} rows")
        x = self.embeddings(input_ids)
        neg = torch.finfo(torch.float32).min
        keep = torch.ones((L, L), dtype=torch.bool,
                          device=input_ids.device).tril()
        bias = torch.where(keep, 0.0, neg)[None, None]
        if attention_mask is not None:
            pad = (1.0 - attention_mask.float()) * neg
            bias = bias + pad[:, None, None, :]
        return self.final_layer_norm(self.encoder(x, bias))

    def pooled(self, input_ids, last_hidden):
        """The hidden state at each row's first ``eos_token_id`` (HF's
        pooling; row 0 where there is none)."""
        eos = torch.argmax((input_ids == self.cfg.eos_token_id).int(), dim=-1)
        return last_hidden[torch.arange(last_hidden.shape[0],
                                        device=last_hidden.device), eos]


class CLIPTextModelWithProjection(nn.Module):
    """HF-shaped: ``text_model`` and the bias-free ``text_projection``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                         bias=False)

    def forward(self, input_ids, attention_mask=None):
        """(last_hidden_state, text_embeds of the EOS-pooled rows)."""
        last_hidden = self.text_model(input_ids, attention_mask)
        pooled = self.text_model.pooled(input_ids, last_hidden)
        return last_hidden, self.text_projection(pooled)


@LANGUAGE_REGISTRY.register()
class CLIPLanguageEncoder(nn.Module):
    """reference modules/language/clip.py:11-28: every token of the last
    hidden state projected and L2-normalised, then, with
    ``use_projection``, the MLP head (``get_mlp_head``). With
    ``freeze_backbone`` the CLIP part runs under ``torch.no_grad()`` (JAX's
    ``stop_gradient``, the reference's ``torch.no_grad``)."""

    def __init__(self, cfg=None, weights="openai/clip-vit-large-patch14",
                 output_dim=768, freeze_backbone=True, use_projection=False,
                 dropout=0.1, num_hidden_layers=12):
        super().__init__()
        del weights  # no network access; converted checkpoints load on top
        self.freeze_backbone = freeze_backbone
        clip_cfg = CLIPTextConfig(projection_dim=output_dim,
                                  num_hidden_layers=num_hidden_layers)
        self.model = CLIPTextModelWithProjection(clip_cfg)
        self.use_projection = use_projection
        if use_projection:
            self.projection = get_mlp_head(clip_cfg.hidden_size, output_dim,
                                           output_dim, dropout=dropout)

    def _backbone(self, txt_ids, txt_masks):
        txt = self.model.text_projection(
            self.model.text_model(txt_ids, txt_masks))
        return txt / torch.linalg.vector_norm(
            txt, dim=2, keepdim=True).clamp_min(1e-12)

    def forward(self, txt_ids, txt_masks):
        if self.freeze_backbone:
            with torch.no_grad():
                txt = self._backbone(txt_ids, txt_masks)
        else:
            txt = self._backbone(txt_ids, txt_masks)
        return self.projection(txt) if self.use_projection else txt

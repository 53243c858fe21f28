"""The vocabulary-parallel LM head over the mp group (the port's counterpart
of the JAX package's ``_param_spec`` / ``shard_module`` placement,
``sceneverse_tpu/parallel/mesh.py``).

The rule is JAX's: a ``BertLMPredictionHead`` whose vocabulary V divides mp
holds rows ``[k V / mp, (k + 1) V / mp)`` of its ``decoder.weight`` (V, H)
and of its ``bias`` (V,) on mp rank k (the columns of JAX's (H, V) kernel);
its transform and every other parameter stay replicated. At V = 30522, mp
of 2, 3 or 6 splits the text head and 4 leaves it whole; the 607-way object
head stays whole. ``split_heads`` runs last, after the pretrain load and
the resume, as JAX places its state last (``trainer/build.py:224-231``);
the optimizer keeps the same parameter objects, so AdamW's moments for a
split parameter are split too (sliced here when a resume loaded them
whole).

A split head's forward computes its logits' columns ``x W_k^T + b_k`` and
gathers them over the mp group along the last dimension, so
``txt_lm_cls_logits`` keeps its (..., V) shape and every loss and evaluator
reads it unchanged. A checkpoint holds the whole head (``full_checkpoint``
gathers the parameters and their optimizer state over the mp group before
rank 0 writes, as orbax writes JAX's sharded arrays whole), so a checkpoint
of one mp loads at another.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sceneverse_tpu_torch.parallel import mesh


def _rows(v: int, k: int, n: int) -> slice:
    return slice(k * (v // n), (k + 1) * (v // n))


def _zero_filled(x: torch.Tensor, dim: int, k: int, n: int) -> torch.Tensor:
    """``x`` at block ``k`` of ``n`` along ``dim``, zeros elsewhere."""
    shape = list(x.shape)
    pad = lambda m: x.new_zeros(shape[:dim] + [m * shape[dim]]
                                + shape[dim + 1:])
    return torch.cat([pad(k), x, pad(n - k - 1)], dim)


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mp ranks' ``x`` concatenated along ``dim`` in mp order: an
    all-reduce of a zero-filled buffer (exact: adding zeros changes no bit;
    one collective that gloo and NCCL both take on CUDA tensors)."""
    buf = _zero_filled(x.contiguous(), dim, mesh.mp_rank(), mesh.mp_world())
    dist.all_reduce(buf, group=mesh.group("mp"))
    return buf


class _GatherLogits(torch.autograd.Function):
    """Forward: the mp ranks' logit columns gathered along the last
    dimension. Backward: this rank's columns of the gradient, with NO sum
    over the mp group. The trap: the gather looks like ``all_gather_rows``,
    whose backward sums, but there every rank holds a share of the loss;
    here every mp rank computes the same whole loss from the same gathered
    logits, so each already holds the whole gradient and a sum would scale
    it by mp."""

    @staticmethod
    def forward(ctx, h):
        ctx.k, ctx.v = mesh.mp_rank(), h.shape[-1]
        return _all_gather(h, h.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.k * ctx.v:(ctx.k + 1) * ctx.v].contiguous()


class _HeadInput(torch.autograd.Function):
    """Forward: the identity, placed on the split head's input. Backward:
    the sum of the gradient over the mp group. The trap: the forward does
    nothing, so the backward looks like it should do nothing too; but each
    rank holds only its rows of W, so its ``dx = g_k W_k`` is one term of
    ``dx = sum_k g_k W_k``, and the replicated transform below needs the
    whole sum (the same on every mp rank)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=mesh.group("mp"))
        return g


def head_logits(transformed: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The whole (..., V) logits of a split head from its transformed input
    and its rows of the decoder and bias (bias added in the product's
    dtype, as the whole head adds it)."""
    h = torch.nn.functional.linear(_HeadInput.apply(transformed), weight)
    return _GatherLogits.apply(h + bias.to(h.dtype))


def is_split(p: torch.Tensor) -> bool:
    return bool(getattr(p, "vocab_split", False))


def _split_names(model: torch.nn.Module) -> list:
    return [n for n, p in model.named_parameters() if is_split(p)]


@torch.no_grad()
def split_heads(model: torch.nn.Module, optimizer=None) -> list:
    """Split every head with a ``vocab_shard`` slot whose vocabulary divides
    mp, in place: each parameter keeps its object and takes its rows
    (``p.data``), and so do its optimizer moments and accumulated gradient
    where ``optimizer`` (a ``GPSOptimizer``) already holds them whole.
    Returns the split parameters' names; nothing is split for mp = 1."""
    n, k = mesh.mp_world(), mesh.mp_rank()
    if n == 1:
        return []
    index = ({id(p): i for i, p in enumerate(optimizer.params)}
             if optimizer is not None else {})
    for m in model.modules():
        if not hasattr(m, "vocab_shard") or m.vocab_shard is not None:
            continue
        v = m.decoder.weight.shape[0]
        if v % n:
            continue  # JAX's rule: a vocabulary mp does not divide stays whole
        rows = _rows(v, k, n)
        for p in (m.decoder.weight, m.bias):
            full = p.shape
            p.data = p.data[rows].clone()
            p.vocab_split = True
            if optimizer is None:
                continue
            state = optimizer.opt.state.get(p, {})
            for key, t in state.items():
                if torch.is_tensor(t) and t.shape == full:
                    state[key] = t[rows].clone()
            i = index.get(id(p))
            if optimizer.acc is not None and i is not None:
                optimizer.acc[i] = optimizer.acc[i][rows].clone()
        m.vocab_shard = (k, n)
    return _split_names(model)


@torch.no_grad()
def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A split parameter's (or moment's) rows gathered over the mp group."""
    return _all_gather(t, 0)


@torch.no_grad()
def full_checkpoint(state: dict, model: torch.nn.Module, optimizer) -> dict:
    """``state`` (the trainer's checkpoint entries) with every split
    parameter, its optimizer moments and its accumulated gradient gathered
    whole over the mp group; the live optimizer state is not touched. Every
    rank calls it (the gathers are collectives)."""
    names = set(_split_names(model))
    if not names:
        return state
    state = dict(state)
    state["model"] = {k: full_tensor(v) if k in names else v
                      for k, v in state["model"].items()}
    opt = dict(state["optimizer"])
    inner = dict(opt["opt"])
    inner["state"] = dict(inner["state"])
    acc = list(opt["acc"]) if opt.get("acc") is not None else None
    for i, p in enumerate(optimizer.params):
        if not is_split(p):
            continue
        if i in inner["state"]:
            inner["state"][i] = {
                key: full_tensor(t) if torch.is_tensor(t)
                and t.shape == p.shape else t
                for key, t in inner["state"][i].items()}
        if acc is not None:
            acc[i] = full_tensor(acc[i])
    opt["opt"], opt["acc"] = inner, acc
    state["optimizer"] = opt
    return state

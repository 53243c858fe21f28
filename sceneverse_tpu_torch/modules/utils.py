"""Module helpers: explicit-generator dropout, attention dropout seeds,
tower rematerialisation that replays them, BERT-style init (sceneverse_tpu
modules/weights.py: normal(0.02) for Linear and Embedding weights, zero
biases, unit LayerNorm), activations."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from sceneverse_tpu_torch.utils.precision import LayerNorm

BERT_STD = 0.02


def get_mlp_head(input_size: int, hidden_size: int, output_size: int,
                 dropout: float = 0.0) -> nn.Sequential:
    """Linear -> ReLU -> LayerNorm(eps 1e-12) -> Dropout -> Linear
    (JAX ``modules/utils.py::MlpHead``; reference modules/utils.py:18-25):
    indices 0, 2 and 4 are the reference's names, which the checkpoint
    converters map to JAX's ``fc1`` / ``norm`` / ``fc2``."""
    return nn.Sequential(
        nn.Linear(input_size, hidden_size), nn.ReLU(),
        LayerNorm(hidden_size, eps=1e-12), Dropout(dropout),
        nn.Linear(hidden_size, output_size))


def get_activation_fn(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")  # exact erf GELU
    raise RuntimeError(f"activation {name!r} not ported (relu/gelu)")


class Dropout(nn.Module):
    """Dropout whose mask comes from ``self.generator`` (a torch.Generator
    on the tensor's device, set by ``set_generators``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.generator)
        return x * mask.to(x.dtype) / keep


class AttentionSeed(nn.Module):
    """Draws the per-call int seed of the fused attention kernel's
    in-kernel dropout from a host generator (no device sync)."""

    def __init__(self):
        super().__init__()
        self.seed_generator = None

    def draw(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.seed_generator))


def set_generators(model: nn.Module, seed: int, device,
                   rank: int = 0) -> None:
    """Give every dropout of ``model`` one explicit device generator and
    every attention-seed stream one host generator, both from ``(seed,
    rank)``, ``rank`` the dp rank: dp rank 0 draws as one process does, the
    other dp ranks of a data-parallel world from streams of their own, so
    one rank's dropout differs from a single process's over the same rows
    by design, as the reference's per-rank streams do (and as the
    documented dropout difference of JAX ``mha.py:41-44``). The ranks of an
    mp group run the same replicated towers on the same rows and draw the
    same masks, as JAX's one stream over the mesh does."""
    base = seed + 2_000_006 * rank
    dev = torch.Generator(device=device)
    dev.manual_seed(base)
    host = torch.Generator()
    host.manual_seed(base + 1)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = dev
        elif isinstance(m, AttentionSeed):
            m.seed_generator = host


def _streams(module: nn.Module) -> list:
    """The distinct explicit generators of ``module``'s dropouts and
    attention seeds (``set_generators``)."""
    gens = {}
    for m in module.modules():
        if isinstance(m, Dropout):
            g = m.generator
        elif isinstance(m, AttentionSeed):
            g = m.seed_generator
        else:
            continue
        if g is not None:
            gens[id(g)] = g
    return list(gens.values())


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    unbatched products, recompute everything else (batched ``bmm``
    included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class _Replay:
    """The recompute context of ``remat``: the module's random streams as
    they stood at the tower's entry for the recompute, then back where they
    were just before it; the running statistics of its training-mode
    BatchNorms back as they were, so the recompute moves them no second
    time. ``inner`` is the policy's own recompute context."""

    def __init__(self, gens, entry, stats, inner):
        self.gens, self.entry, self.stats, self.inner = gens, entry, stats, inner

    def __enter__(self):
        self.before = [g.get_state() for g in self.gens]
        self.kept = [t.clone() for t in self.stats]
        for g, state in zip(self.gens, self.entry):
            g.set_state(state)
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            for g, state in zip(self.gens, self.before):
                g.set_state(state)
            with torch.no_grad():
                for t, kept in zip(self.stats, self.kept):
                    t.copy_(kept)


def remat(module: nn.Module, fn, *args, policy: str = "full"):
    """``fn(*args)`` (a call of ``module``) with its activations dropped in
    the forward and recomputed in the backward:
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, under
    ``policy`` "full" (recompute everything) or "dots" (selective: keep the
    unbatched products' outputs, ``_dots_policy``).

    The checkpoint replays only torch's default generators. The port's
    dropouts and attention seeds draw from their own (``set_generators``),
    so their states at the entry are kept and set again for the recompute
    (the same dropout masks and kernel seeds as the forward), then put back
    as they were before it (no later draw moves). JAX gets both from its
    functional keys."""
    if policy not in ("full", "dots"):
        raise ValueError(f"remat policy {policy!r}; valid: full, dots")
    gens = _streams(module)
    entry = [g.get_state() for g in gens]
    stats = [t for m in module.modules()
             if m.training and getattr(m, "running_mean", None) is not None
             for t in (m.running_mean, m.running_var,
                       getattr(m, "num_batches_tracked", None))
             if t is not None]

    def contexts():
        if policy == "dots":
            fwd, rec = _ckpt.create_selective_checkpoint_contexts(
                _dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _Replay(gens, entry, stats, rec)

    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=contexts)


@torch.no_grad()
def init_bert_weights(module: nn.Module, generator: torch.Generator) -> None:
    """normal(0.02) Linear/Embedding/packed in-projection weights, zero
    biases, unit LayerNorm (reference modules/weights.py:3-20), in module
    order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, BERT_STD, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if hasattr(m, "in_proj_weight"):  # packed attention projection
            m.in_proj_weight.normal_(0.0, BERT_STD, generator=generator)
            m.in_proj_bias.zero_()

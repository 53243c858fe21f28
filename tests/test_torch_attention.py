"""Port parity: sceneverse_tpu_torch flash attention (``ops/attention.py``,
the plain twin of the CUDA ``flash_fwd`` / ``flash_bwd`` kernels and their
autograd op) against the JAX package's ``masked_mha`` (the library's TPU
flash-attention kernels in interpret mode, with their custom VJP), and
``softmax_lowp`` against the JAX one. Same numpy inputs on both sides.

Tolerances:
  * flash attention, o, dq, dk, dv: 2 bf16 steps of the largest magnitude
    (2^-6 * max|jax|). Both sides return these in bf16; the probabilities
    are rounded to bf16 at other points (the library normalises before the
    rounding when one key block covers the row; the port rounds the
    unnormalised p of its online softmax, as its kernel does), which moves
    an element by less than a step before its own rounding. Measured: one
    step at most.
  * d ab: f32 on both sides, 2^-7 * max|jax|; it inherits di = sum(o * do)
    from the bf16 o (measured 1.5e-3 relative).
  * softmax_lowp: f32 forward within 1e-6 (XLA's exp and sum order differ
    from torch's, a few ulp; not bit-equal); bf16 forward and backward
    equal to JAX (the bf16 rounding hides the ulps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sceneverse_tpu.ops.pallas.attention import masked_mha as jax_masked_mha
from sceneverse_tpu.ops.pallas.mha import fused_mha_supported as jax_supported
from sceneverse_tpu.ops.softmax import softmax_lowp as jax_softmax_lowp
from sceneverse_tpu_torch.ops import attention as tatt
from sceneverse_tpu_torch.ops import mha as tmha
from sceneverse_tpu_torch.ops.softmax import softmax_lowp

BF16_TOL, DAB_TOL = 2.0 ** -6, 2.0 ** -7


def _case(L, seed=0):
    rng = np.random.RandomState(seed)
    B, H, dh = 1, 2, 64
    q, k, v, do = (rng.randn(B, H, L, dh).astype(np.float32)
                   for _ in range(4))
    pad = rng.rand(B, L) > 0.7
    pad[:, 0] = False
    ab = rng.randn(B, H, L, L).astype(np.float32)
    return q, k, v, pad, ab, do


@pytest.mark.parametrize("L", [130, 300])  # one 256 key block; 3 of 128
@pytest.mark.parametrize("use_ab", [False, True])
def test_masked_mha_forward_and_vjp_match_jax(L, use_ab):
    q, k, v, pad, ab, do = _case(L)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def jf(q, k, v, ab):
        return jax_masked_mha(q, k, v, jnp.asarray(pad),
                              ab if use_ab else None, sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        jo, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v, ab)))
        jg = vjp(jnp.asarray(do))
    tin = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, ab)]
    to = tatt.masked_mha(*tin[:3], torch.from_numpy(pad),
                         tin[3] if use_ab else None, sm_scale=scale)
    assert to.dtype == torch.float32 and to.shape == q.shape
    wrt = tin if use_ab else tin[:3]
    tg = torch.autograd.grad(to, wrt, torch.from_numpy(do))
    jo = np.asarray(jo)
    assert np.abs(to.detach().numpy() - jo).max() <= BF16_TOL * np.abs(jo).max()
    for name, t, j in zip(("dq", "dk", "dv", "dab"), tg, jg):
        j = np.asarray(j)
        tol = DAB_TOL if name == "dab" else BF16_TOL
        assert np.abs(j).max() > 0, name
        assert np.abs(t.numpy() - j).max() <= tol * np.abs(j).max(), name


def test_flash_twin_is_the_plain_softmax_at_f32_scale():
    """The twin's online softmax over 64-key tiles equals one f32 softmax of
    the same logits up to the bf16 rounding of p and o: against an f32
    reference, o within 2^-7 of max|o|, l and m exact functions of it."""
    q, k, v, pad, ab, _ = _case(150, seed=3)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    tq, tk, tv = bf(q * 0.125), bf(k), bf(v)
    tpad, tab = torch.from_numpy(pad), torch.from_numpy(ab)
    o, l, m = tatt.flash_fwd_plain(tq, tk, tv, tpad, tab)
    s = tq.float() @ tk.float().transpose(-1, -2) + tab
    s = s + torch.where(tpad[:, None, None, :], tatt.MASK_VALUE, 0.0)
    assert torch.equal(m, s.amax(-1))
    want_l = torch.exp(s - m[..., None]).sum(-1)
    assert torch.allclose(l, want_l, rtol=1e-5)
    want = torch.softmax(s, -1) @ tv.float()
    assert (o.float() - want).abs().max() <= 2.0 ** -7 * want.abs().max()
    assert o.dtype == torch.bfloat16


def test_all_pad_query_gets_the_mean_of_v():
    """A query whose keys are all pads (no GPS path has one): every score
    rounds to the same -0.7 * FLT_MAX, so the output is the mean of v over
    the Lk keys (the library also averages its zero padding)."""
    q, k, v, _, _, _ = _case(20, seed=4)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    pad = torch.ones((1, 20), dtype=torch.bool)
    o, _, _ = tatt.flash_fwd_plain(bf(q), bf(k), bf(v), pad, None)
    want = bf(v).float().mean(2, keepdim=True).expand_as(o)
    assert (o.float() - want).abs().max() <= 2.0 ** -7


def test_softmax_lowp_f32_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 3, 8, 8)) * 3).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jp, vjp = jax.vjp(lambda a: jax_softmax_lowp(a, jnp.float32),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    p = softmax_lowp(xt, torch.float32)
    assert torch.equal(p, torch.softmax(xt, -1))  # the same forward as torch
    (dx,) = torch.autograd.grad(p, xt, torch.from_numpy(g))
    assert np.abs(p.detach().numpy() - np.asarray(jp)).max() <= 1e-6
    assert np.abs(dx.numpy() - np.asarray(jdx)).max() <= 1e-6


def test_softmax_lowp_bf16_keeps_bf16_probs_and_matches_jax_vjp():
    """The numbers of tests/test_attention.py::test_softmax_lowp_bf16_grad_close:
    forward and VJP equal to JAX's; the backward keeps only the bf16
    probabilities (no f32 copy) and returns the logits' f32."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 16)) * 3).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jp, vjp = jax.vjp(lambda a: jax_softmax_lowp(a, jnp.bfloat16),
                      jnp.asarray(x))
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    (jdx,) = vjp(gb)
    xt = torch.from_numpy(x).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        p = softmax_lowp(xt, torch.bfloat16)
    assert p.dtype == torch.bfloat16
    assert [t.dtype for t in saved] == [torch.bfloat16]
    (dx,) = torch.autograd.grad(
        p, xt, torch.from_numpy(np.array(gb.astype(jnp.float32))).to(
            torch.bfloat16))
    assert dx.dtype == torch.float32
    assert np.array_equal(p.float().detach().numpy(),
                          np.asarray(jp.astype(jnp.float32)))
    assert np.abs(dx.numpy() - np.asarray(jdx)).max() <= 1e-6


def test_cls_only_row_keeps_bf16_probabilities():
    """The caption tower's [CLS]-only layer under a bf16 autocast saves its
    probabilities in v's bf16 for the backward, as JAX's ``softmax_lowp``
    does (it used to keep an f32 softmax)."""
    from sceneverse_tpu_torch.modules.language.bert import (BertConfig,
                                                            BertSelfAttention)

    torch.manual_seed(0)
    att = BertSelfAttention(BertConfig(hidden_size=32, num_attention_heads=2))
    x = torch.randn((2, 12, 32), requires_grad=True)
    pad = torch.zeros((2, 12))
    saved = []
    with torch.autocast("cpu", dtype=torch.bfloat16), \
            torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
        out = att(x, pad, q_rows=1)
    probs = [t for t in saved if tuple(t.shape) == (2, 2, 1, 12)]
    assert probs and all(t.dtype == torch.bfloat16 for t in probs)
    out.float().sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("D,H", [(64, 4), (128, 2), (768, 12), (256, 4),
                                 (384, 8), (96, 2), (192, 4), (100, 3)])
def test_fused_mha_supported_is_the_jax_predicate(D, H):
    assert tmha.fused_mha_supported(D, H) == jax_supported(D, H)


def test_gates_read_at_call_time(monkeypatch):
    monkeypatch.delenv("SCENEVERSE_FUSED_MHA", raising=False)
    monkeypatch.delenv("SCENEVERSE_FLASH_ATTN", raising=False)
    assert tmha.fused_mha_enabled() and not tatt.flash_enabled()
    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")
    monkeypatch.setenv("SCENEVERSE_FLASH_ATTN", "on")
    assert not tmha.fused_mha_enabled() and tatt.flash_enabled()


@pytest.mark.parametrize("training", [False, True])
def test_layers_route_as_the_jax_package(monkeypatch, training):
    """With ``SCENEVERSE_FUSED_MHA=off`` and ``SCENEVERSE_FLASH_ATTN=on``:
    in eval the BERT and unified-encoder layers take flash attention and the
    spatial layer the plain 'cond' path; in training (dropout 0.1) every
    layer takes the plain path. The fused kernel is never called."""
    from sceneverse_tpu_torch.modules.language import bert
    from sceneverse_tpu_torch.modules.layers import transformers as tr

    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")
    monkeypatch.setenv("SCENEVERSE_FLASH_ATTN", "on")
    calls = {"flash": 0, "fused": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (bert, tr):
        monkeypatch.setattr(mod, "masked_mha", spy("flash", mod.masked_mha))
        monkeypatch.setattr(mod, "fused_mha", spy("fused", mod.fused_mha))
    torch.manual_seed(0)
    layers = [
        (bert.BertSelfAttention(bert.BertConfig(hidden_size=32,
                                                num_attention_heads=2)),
         lambda m, x: m(x, torch.zeros((2, 6)))),
        (tr.MultiHeadAttention(32, 2, dropout=0.1),
         lambda m, x: m(x, x, x, torch.zeros((2, 6), dtype=torch.bool))[0]),
        (tr.MultiHeadAttentionSpatial(32, 2),
         lambda m, x: m(x, x, x, torch.randn((2, 6, 6, 5)),
                        torch.zeros((2, 6), dtype=torch.bool))[0]),
    ]
    for m, run in layers:
        m.train(training)
        assert torch.isfinite(run(m, torch.randn((2, 6, 32)))).all()
    assert calls == {"flash": 0 if training else 2, "fused": 0}

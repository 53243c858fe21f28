"""Port parity for the grounding variants and the transformer library they
use: ``MultiHeadAttention`` with ``kdim`` / ``vdim``, ``CrossAttentionLayer``
(pre- and post-norm), ``TransformerDecoderLayer``,
``TransformerEncoderLayer(prenorm=True)``, ``MultiHeadAttentionSpatial`` in
all five fusions with and without ``spatial_multihead``,
``TransformerSpatialDecoderLayer``, ``EntitySpatialCrossEncoder``,
``UnifiedSpatialCrossEncoderV1``, ``calc_pairwise_locs`` in its three modes
and ``calc_pairwise_locs_mv``; the fused attention's plain twin at L != T
against JAX's ``fused_mha`` in interpret mode. One ``OpenVocab`` train
step with each encoder is held in ``tests/test_torch_grounding_step.py``.

Sizes: hidden 64, 4 heads (dh 16), 2 layers, FFN 128, B = 2, at most 9
objects and 7 tokens (queries and keys of different lengths throughout).
The JAX weights are carried by ``from_jax_params`` (every parameter lands,
none is left: ``carry``), eval mode, same numpy inputs, f32. The layers run
on the plain attention path on both sides (``SCENEVERSE_FUSED_MHA=off``),
and where marked "interpret" on the fused path: JAX's Pallas kernel in
interpret mode against the port's plain twin of the CUDA kernel.

Tolerances: layers, encoders and pairwise features max|port - jax| <=
1e-5 * max(1, max|jax|) (the same f32 formulas in another summation
order); the attention twin 1e-5 forward and 1e-4 on the gradients
(absolute, O(1) values, ``tests/test_torch_mha.py``'s)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from test_torch_mha import _jax_run, _torch_run
from test_torch_modules import carry, close


D, H, FF = 64, 4, 128
B, L, T = 2, 9, 7  # objects (queries) and tokens (keys)


@pytest.fixture
def plain(monkeypatch):
    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")


def _pad(rng, n, lo=2):
    """(B, n) bool, True at pad positions, each row with >= lo valid."""
    valid = rng.randint(lo, n + 1, size=B)
    return np.arange(n)[None] >= valid[:, None]


def _locs(rng, n=L):
    """(B, n, 6) object centers and positive sizes."""
    return np.concatenate([rng.randn(B, n, 3), rng.rand(B, n, 3) + 0.2],
                          -1).astype(np.float32)


def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def jbuild(cls, seed, **kw):
    """The JAX module, built eagerly: the tests' modules share parameter
    shapes, so eager JAX compiles each primitive once for the file, where
    ``nnx.jit`` compiles a program per module (twice the file's time)."""
    return cls(rngs=nnx.Rngs(seed), **kw)


def _both(jm, tm, jcall, tcall, *arrays):
    """The JAX module (eager) and the port's on the same arrays; returns
    (port, jax) of the first output."""
    want = jcall(jm, *map(jnp.asarray, arrays))
    with torch.no_grad():
        got = tcall(tm, *(torch.from_numpy(np.array(a)) for a in arrays))
    first = lambda o: o[0] if isinstance(o, tuple) else o
    return first(got), first(want)


def test_mha_kdim_vdim(plain):
    from sceneverse_tpu.modules.layers.transformers import \
        MultiHeadAttention as J
    from sceneverse_tpu_torch.modules.layers.transformers import \
        MultiHeadAttention as Tm

    rng = np.random.RandomState(0)
    jm = jbuild(lambda **k: J(D, H, kdim=48, vdim=40, **k), 0)
    tm = Tm(D, H, kdim=48, vdim=40)
    assert not tm.same_dims and hasattr(tm, "q_proj")
    carry(jm, tm)
    q, k, v = _x(rng, B, L, D), _x(rng, B, T, 48), _x(rng, B, T, 40)
    pad = _pad(rng, T)
    call = lambda m, q, k, v, p: m(q, k, v, key_padding_mask=p)
    close(*_both(jm, tm, call, call, q, k, v, pad))


def test_mha_attn_mask_takes_the_plain_path(interpret):
    """An ``attn_mask`` keeps the layer off the fused kernel in both
    packages; -inf where it is True."""
    from sceneverse_tpu.modules.layers.transformers import \
        MultiHeadAttention as J
    from sceneverse_tpu_torch.modules.layers.transformers import \
        MultiHeadAttention as Tm

    rng = np.random.RandomState(1)
    jm = jbuild(lambda **k: J(D, H, **k), 1)
    tm = Tm(D, H)
    carry(jm, tm)
    q, kv = _x(rng, B, L, D), _x(rng, B, T, D)
    mask = rng.rand(L, T) > 0.6
    mask[:, 0] = False
    call = lambda m, q, kv, am: m(q, kv, kv, attn_mask=am)
    close(*_both(jm, tm, call, call, q, kv, mask))


@pytest.mark.parametrize("prenorm", [True, False], ids=["prenorm",
                                                       "postnorm"])
def test_cross_attention_layer(plain, prenorm):
    from sceneverse_tpu.modules.layers.transformers import \
        CrossAttentionLayer as J
    from sceneverse_tpu_torch.modules.layers.transformers import \
        CrossAttentionLayer as Tm

    rng = np.random.RandomState(2)
    kw = dict(dim_feedforward=FF, k_dim=48, v_dim=48, prenorm=prenorm)
    jm = jbuild(lambda **k: J(D, H, **k), 2, **kw)
    tm = Tm(D, H, **kw)
    carry(jm, tm)
    tgt, mem = _x(rng, B, L, D), _x(rng, B, T, 48)
    pad = _pad(rng, T)
    mask = rng.rand(L, T) > 0.7
    mask[:, 0] = False
    call = lambda m, t, mm, p, am: m(t, mm, memory_key_padding_mask=p,
                                     memory_mask=am)
    close(*_both(jm, tm, call, call, tgt, mem, pad, mask))


def test_transformer_decoder_layer(plain):
    from sceneverse_tpu.modules.layers.transformers import \
        TransformerDecoderLayer as J
    from sceneverse_tpu_torch.modules.layers.transformers import \
        TransformerDecoderLayer as Tm

    rng = np.random.RandomState(3)
    jm = jbuild(lambda **k: J(D, H, **k), 3, dim_feedforward=FF)
    tm = Tm(D, H, dim_feedforward=FF)
    carry(jm, tm)
    tgt, mem = _x(rng, B, T, D), _x(rng, B, L, D)
    call = lambda m, t, mm, tp, mp: m(t, mm, tgt_key_padding_mask=tp,
                                      memory_key_padding_mask=mp)
    close(*_both(jm, tm, call, call, tgt, mem, _pad(rng, T), _pad(rng, L)))


def test_transformer_encoder_layer_prenorm(plain):
    from sceneverse_tpu.modules.layers.transformers import \
        TransformerEncoderLayer as J
    from sceneverse_tpu_torch.modules.layers.transformers import \
        TransformerEncoderLayer as Tm

    rng = np.random.RandomState(4)
    kw = dict(dim_feedforward=FF, prenorm=True)
    jm = jbuild(lambda **k: J(D, H, **k), 4, **kw)
    tm = Tm(D, H, **kw)
    carry(jm, tm)
    call = lambda m, t, p: m(t, tgt_key_padding_mask=p)
    close(*_both(jm, tm, call, call, _x(rng, B, L, D), _pad(rng, L)))


SPATIAL = [(f, mh, 5) for f in ("mul", "bias", "add", "ctx", "cond")
           for mh in (True, False)] + [("cond", True, 4), ("mul", False, 1)]


@pytest.mark.parametrize("fusion,multihead,sdim", SPATIAL,
                         ids=[f"{f}-{'mh' if m else 'sh'}-sd{s}"
                              for f, m, s in SPATIAL])
def test_spatial_attention_fusions(plain, fusion, multihead, sdim):
    from sceneverse_tpu.modules.layers.transformers import \
        MultiHeadAttentionSpatial as J
    from sceneverse_tpu.ops.geometry import calc_pairwise_locs
    from sceneverse_tpu_torch.modules.layers.transformers import \
        MultiHeadAttentionSpatial as Tm

    rng = np.random.RandomState(5)
    kw = dict(spatial_multihead=multihead, spatial_dim=sdim,
              spatial_attn_fusion=fusion)
    jm = jbuild(lambda **k: J(D, H, **k), 5, **kw)
    tm = Tm(D, H, **kw)
    carry(jm, tm)
    x = _x(rng, B, L, D)
    locs = np.asarray(calc_pairwise_locs(jnp.asarray(_locs(rng)[..., :3]),
                                         spatial_dim=sdim))
    call = lambda m, a, lc, p: m(a, a, a, lc, key_padding_mask=p)
    close(*_both(jm, tm, call, call, x, locs, _pad(rng, L)))


def test_spatial_decoder_layer(plain):
    from sceneverse_tpu.modules.layers.transformers import \
        TransformerSpatialDecoderLayer as J
    from sceneverse_tpu.ops.geometry import calc_pairwise_locs
    from sceneverse_tpu_torch.modules.layers.transformers import \
        TransformerSpatialDecoderLayer as Tm

    rng = np.random.RandomState(6)
    kw = dict(dim_feedforward=FF, activation="gelu",
              spatial_attn_fusion="cond")
    jm = jbuild(lambda **k: J(D, H, **k), 6, **kw)
    tm = Tm(D, H, **kw)
    carry(jm, tm)
    locs = np.asarray(calc_pairwise_locs(jnp.asarray(_locs(rng)[..., :3])))
    call = lambda m, t, mm, lc, tp, mp: m(t, mm, lc, tgt_key_padding_mask=tp,
                                          memory_key_padding_mask=mp)
    close(*_both(jm, tm, call, call, _x(rng, B, L, D), _x(rng, B, T, D), locs,
                 _pad(rng, L), _pad(rng, T)))


ENCODERS = [("EntitySpatialCrossEncoder", "center", "plain"),
            ("EntitySpatialCrossEncoder", "vertical_bottom", "plain"),
            ("UnifiedSpatialCrossEncoderV1", "center", "plain"),
            ("EntitySpatialCrossEncoder", "center", "interpret")]


@pytest.mark.parametrize("name,rel,route", ENCODERS,
                         ids=["-".join(e) for e in ENCODERS])
def test_grounding_encoders(monkeypatch, name, rel, route):
    import sceneverse_tpu.modules  # noqa: F401  (registries)
    import sceneverse_tpu_torch.modules  # noqa: F401
    from sceneverse_tpu.modules.build import GROUNDING_REGISTRY as JR
    from sceneverse_tpu_torch.modules.build import GROUNDING_REGISTRY as TR

    monkeypatch.setenv(*(("SCENEVERSE_FUSED_MHA", "off") if route == "plain"
                         else ("SCENEVERSE_PALLAS_INTERPRET", "1")))
    rng = np.random.RandomState(7)
    kw = dict(hidden_size=D, num_attention_heads=H, spatial_dim=5,
              num_layers=1 if route == "interpret" else 2, dim_loc=6,
              pairwise_rel_type=rel)
    jm = jbuild(JR.get(name), 7, **kw)
    tm = TR.get(name)(**kw)
    carry(jm, tm)
    txt, obj, locs = _x(rng, B, T, D), _x(rng, B, L, D), _locs(rng)
    tmask, omask = ~_pad(rng, T), ~_pad(rng, L)
    want = jm(*map(jnp.asarray, (txt, tmask, obj, locs, omask)))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (txt, tmask, obj, locs, omask)))
    assert got[1].shape == (B, L, D) and got[0].shape == (B, T, D)
    for g, w in zip(got, want):
        close(g, w)
    if name == "EntitySpatialCrossEncoder":  # the text passes through
        np.testing.assert_array_equal(got[0].numpy(), txt)


@pytest.mark.parametrize("rel,sdim,norm", [
    ("center", 5, True), ("center", 4, False), ("center", 1, True),
    ("vertical_bottom", 5, True), ("vertical_bottom", 4, True),
    ("mlp", 5, True)])
def test_calc_pairwise_locs(rel, sdim, norm):
    from sceneverse_tpu.ops import geometry as jg
    from sceneverse_tpu_torch.ops import geometry as tg

    locs = _locs(np.random.RandomState(8))
    c, s = locs[..., :3], locs[..., 3:]
    want = jg.calc_pairwise_locs(jnp.asarray(c), jnp.asarray(s),
                                 pairwise_rel_type=rel,
                                 spatial_dist_norm=norm, spatial_dim=sdim)
    got = tg.calc_pairwise_locs(torch.from_numpy(c), torch.from_numpy(s),
                                pairwise_rel_type=rel,
                                spatial_dist_norm=norm, spatial_dim=sdim)
    assert got.shape == (B, L, L, 12 if rel == "mlp" else sdim)
    close(got, want)
    if rel == "center":
        close(tg.calc_pairwise_locs_mv(torch.from_numpy(c), spatial_dim=sdim,
                                       spatial_dist_norm=norm),
              jg.calc_pairwise_locs_mv(jnp.asarray(c), spatial_dim=sdim,
                                       spatial_dist_norm=norm))


def test_calc_pairwise_locs_rejects_unknown_mode():
    from sceneverse_tpu_torch.ops.geometry import calc_pairwise_locs

    with pytest.raises(NotImplementedError):
        calc_pairwise_locs(torch.zeros(1, 2, 3), pairwise_rel_type="edge")


@pytest.mark.parametrize("Lq,Tk", [(10, 6), (6, 10)],
                         ids=["objects-over-text", "text-over-objects"])
def test_mha_twin_cross_lengths_match_jax_interpret(Lq, Tk):
    """The CPU half of the card's cross-attention check: the port's plain
    twin (and its autograd) at L != T, key pad and dropout 0.1 with a fixed
    seed, against JAX's Pallas kernel in interpret mode, forward and VJP;
    dh = 64, the CUDA kernels' head width."""
    rng = np.random.RandomState(9)
    Bq, Hh, dh = 1, 2, 64
    Dm = Hh * dh
    d = {"q": _x(rng, Bq, Lq, Dm), "k": _x(rng, Bq, Tk, Dm),
         "v": _x(rng, Bq, Tk, Dm), "w": _x(rng, Bq, Lq, Dm)}
    pad = rng.rand(Bq, Tk) > 0.6
    pad[:, 0] = False
    kw = {"key_padding_mask": pad}
    jo, jg = _jax_run(d, kw, Hh, 0.1, 0.125, 4321)
    to, tgr = _torch_run(d, kw, Hh, 0.1, 0.125, 4321)
    assert to.shape == (Bq, Lq, Dm)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    for t, j in zip(tgr, jg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)

"""Port parity for the CLIP text tower: ``CLIPTextModelWithProjection``
(causal mask, pad row, EOS pooling) and ``CLIPLanguageEncoder``
(``use_projection`` on / off, ``freeze_backbone`` on / off) against the JAX
package's modules with the JAX weights (seeded random values,
``random_build``, for the whole model) carried by ``from_jax_params``
(every parameter lands, none is left); an ``OpenVocab`` forward with CLIP
as its language tower against JAX's; the caption tower's fallback to the
whole tower for an encoder without ``cls_only``; the position-table limit.

Sizes: the tower at hidden 64, 4 heads, 2 layers, FFN 128, a 100-word
vocabulary and 16 positions, ``CLIPLanguageEncoder`` too (``tiny_clip``:
both packages' ``CLIPTextConfig`` defaults set to these widths) with
``output_dim`` 64 (its MLP head takes the hidden width as its input, as
JAX's does, so ``use_projection`` needs ``output_dim`` equal to it); B = 2
texts of 9 tokens, padded after their EOS, the second row's EOS at a
random position. f32, eval mode.

Tolerances: max|port - jax| <= 1e-5 * max(1, max|jax|) on every output
(the same f32 formulas in another summation order); gradients 1e-4 *
max|jax grad| of each tensor + 1e-6 * the largest gradient (``k_proj``'s
bias has a gradient of exactly 0 in exact arithmetic, rounding noise on
both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from test_torch_grounding_step import random_build
from test_torch_modules import carry, close

B, L = 2, 9
TINY = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=16, projection_dim=48, eos_token_id=99)


def _ids(rng, vocab, eos):
    """Token ids with EOS ending each text and pads after it; the mask."""
    ids = rng.randint(1, vocab - 1, (B, L))
    ends = np.array([L - 1, rng.randint(3, L - 1)])
    mask = np.arange(L)[None] <= ends[:, None]
    ids[np.arange(B), ends] = eos
    return np.where(mask, ids, 0), mask.astype(np.int64)


def test_clip_text_model_with_projection():
    from sceneverse_tpu.modules.language import clip as J
    from sceneverse_tpu_torch.modules.language import clip as Tc

    jm = J.CLIPTextModelWithProjection(J.CLIPTextConfig(**TINY),
                                       rngs=nnx.Rngs(0))
    tm = Tc.CLIPTextModelWithProjection(Tc.CLIPTextConfig(**TINY))
    carry(jm, tm)
    ids, mask = _ids(np.random.RandomState(0), 100, 99)
    jh, je = jm(jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        th, te = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert th.shape == (B, L, 64) and te.shape == (B, 48)
    close(th, jh)
    close(te, je)
    ends = mask.sum(1) - 1  # EOS pooling reads each row's EOS position
    np.testing.assert_array_equal(
        tm.text_model.pooled(torch.from_numpy(ids), th).numpy(),
        th.numpy()[np.arange(B), ends])


def test_quick_gelu_matches_jax():
    from sceneverse_tpu.modules.language.clip import quick_gelu as jq
    from sceneverse_tpu_torch.modules.language.clip import quick_gelu as tq

    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(tq(torch.from_numpy(x)), jq(jnp.asarray(x)))


@pytest.fixture
def tiny_clip(monkeypatch):
    """``CLIPLanguageEncoder`` builds its tower from ``CLIPTextConfig``'s
    clip-vit-large-patch14 defaults in both packages; here both build it at
    the TINY widths (the full width runs on the card, ``chip_smoke.py``)."""
    import functools

    from sceneverse_tpu.modules.language import clip as J
    from sceneverse_tpu_torch.modules.language import clip as Tc

    for mod in (J, Tc):
        tiny = {k: v for k, v in TINY.items()
                if k not in ("projection_dim", "num_hidden_layers")}
        monkeypatch.setattr(mod, "CLIPTextConfig",
                            functools.partial(mod.CLIPTextConfig, **tiny))


def _encoders(seed, **kw):
    from sceneverse_tpu.modules.language.clip import CLIPLanguageEncoder as J
    from sceneverse_tpu_torch.modules.language.clip import \
        CLIPLanguageEncoder as Tc

    kw = dict(output_dim=64, num_hidden_layers=2, **kw)
    jm = J(rngs=nnx.Rngs(seed), **kw)
    tm = Tc(**kw)
    carry(jm, tm)
    return jm, tm


@pytest.mark.parametrize("use_projection", [False, True],
                         ids=["no-projection", "projection"])
@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trained"])
def test_clip_language_encoder_forward(tiny_clip, freeze, use_projection):
    jm, tm = _encoders(1, freeze_backbone=freeze,
                       use_projection=use_projection)
    assert hasattr(tm, "projection") == use_projection
    ids, mask = _ids(np.random.RandomState(1), 100, 99)
    want = jm(jnp.asarray(ids), jnp.asarray(mask))
    got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (B, L, 64)
    close(got.detach(), want)
    if not use_projection:  # per-token unit vectors
        np.testing.assert_allclose(got.detach().norm(dim=2).numpy(), 1.0,
                                   rtol=1e-5)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trained"])
def test_clip_language_encoder_grads(tiny_clip, freeze):
    """With ``freeze_backbone`` the backbone gets no gradient (JAX: zeros
    through ``stop_gradient``) and the MLP head its own; without, every
    tensor's gradient equals JAX's."""
    from test_torch_slice import _flat

    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    jm, tm = _encoders(2, freeze_backbone=freeze, use_projection=True)
    ids, mask = _ids(np.random.RandomState(2), 100, 99)
    w = np.random.RandomState(3).randn(B, L, 64).astype(np.float32)
    grads = nnx.grad(lambda m: jnp.sum(m(jnp.asarray(ids), jnp.asarray(mask))
                                       * w))(jm)
    jg = from_jax_params(_flat(nnx.state(grads, nnx.Param)))
    (tm(torch.from_numpy(ids), torch.from_numpy(mask))
     * torch.from_numpy(w)).sum().backward()
    gmax = max(np.abs(v.numpy()).max() for v in jg.values())
    for n, p in tm.named_parameters():
        j = jg[n].numpy()
        if freeze and n.startswith("model."):
            assert p.grad is None and not np.any(j), n
            continue
        assert p.grad is not None, n
        err = np.abs(p.grad.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max() + 1e-6 * gmax, (n, err)


def test_clip_raises_past_its_position_table():
    """77 rows: the port raises a ValueError on a longer text, where the
    JAX package's gather past the table fills the rows with NaN
    (ROADMAP.md section C)."""
    from sceneverse_tpu.modules.language import clip as J
    from sceneverse_tpu_torch.modules.language.clip import (
        CLIPTextConfig, CLIPTextTransformer)

    cfg = CLIPTextConfig(**{**TINY, "max_position_embeddings": 8})
    tower = CLIPTextTransformer(cfg)
    tower(torch.ones((1, 8), dtype=torch.long))
    with pytest.raises(ValueError, match="position table"):
        tower(torch.ones((1, 9), dtype=torch.long))
    jemb = J.CLIPTextEmbeddings(J.CLIPTextConfig(
        **{**TINY, "max_position_embeddings": 8}), rngs=nnx.Rngs(0))
    rows = np.asarray(jemb(jnp.ones((1, 9), jnp.int32)))[0]
    assert np.isfinite(rows[:8]).all() and np.isnan(rows[8]).all()


def _clip_cfg(**data_args):
    from test_model_optim import tiny_gps_cfg

    cfg = tiny_gps_cfg()
    cfg.model.language = {"name": "CLIPLanguageEncoder", "lr": 1e-5,
                          "args": {"output_dim": 32, "num_hidden_layers": 1,
                                   "freeze_backbone": True}}
    cfg.model.vision.args.num_layers = 1
    cfg.data.args.update(data_args)
    return cfg


def test_openvocab_with_clip_language_tower(monkeypatch, tiny_clip):
    """``OpenVocab`` with ``CLIPLanguageEncoder`` as ``model.language``
    (``tests/test_model_optim.py``'s tiny model otherwise), eval forward
    against JAX's, plain attention on both sides."""
    from test_model_optim import gps_batch
    from test_torch_slice import _flat

    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.model import build_model as tbuild

    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")
    cfg = _clip_cfg()
    jm = random_build(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))
    jm.eval()
    tm = tbuild(TConfig(cfg.to_dict()))
    missing, unexpected = load_jax_params(
        tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
    assert unexpected == [] and all(
        k.endswith("num_batches_tracked") for k in missing)
    tm.eval()
    batch = {k: np.array(v) for k, v in gps_batch().items()}
    batch["txt_masks"][1, 4:] = 0
    jout = nnx.jit(lambda m, b: m(b))(
        jm, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tout = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("og3d_logits", "txt_lm_cls_logits", "obj_cls_post_logits",
              "intra_text_embed", "inter_text_embed", "inter_obj_embeds"):
        close(tout[k], jout[k])


def test_caption_tower_runs_whole_without_cls_only(tiny_clip):
    """``_lang_cls`` on an encoder whose forward takes no ``cls_only``
    (CLIP) runs the whole tower and reads [CLS], as JAX :113-118 does."""
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.model import build_model

    cfg = _clip_cfg(use_scene_cap=True)
    cfg.model.split_scene_cap_tower = True
    model = build_model(TConfig(cfg.to_dict())).eval()
    ids, mask = _ids(np.random.RandomState(4), 100, 99)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        got = model._lang_cls(ids, mask)
        want = model.lang_encoder(ids, mask)[:, 0]
    assert torch.equal(got, want)
    assert jax.numpy.zeros(1).shape == (1,)  # JAX stays importable beside

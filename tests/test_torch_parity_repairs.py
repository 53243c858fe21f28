"""Port parity for five behaviours of the JAX package, each held against the
JAX package on the CPU from the same numpy inputs:

  1. ``SCENEVERSE_CAP_CLS_ONLY`` (default on, read at call time): with it
     off the split caption tower runs in full and the caption embed is its
     ``[:, 0]``; on, the final layer computes the [CLS] row alone.
  2. The bf16 policy of ``enable_mixed_precision``: every Embedding computes
     in bf16 and every LayerNorm returns bf16 (``SCENEVERSE_LN_BF16``,
     default on; f32 statistics), module by module and for the tiny slice.
  3. The ``train/lr/group_i`` log rows are ``base_lr * schedule(step)`` at
     the post-increment step, as JAX's ``BaseTrainer.log``.
  4. Each eval loader of a split is recorded, logged and reset on its own,
     ``is_best`` is their OR and the results are merged
     (``default_trainer.py:105-129``).
  5. ``mixed_precision``: bf16, bfloat16, fp16 and 16 train under bf16, any
     other value in f32, with no raise.

Tolerances of the bf16 checks (max abs error against the JAX module):
  * one module: 4 bf16 steps (2^-8 each) of max(1, max|jax|). Both sides
    round at the same points (bf16 matmuls, bf16 embeddings and LayerNorm
    outputs), but the frameworks' bf16 matmuls sum in another order, so a
    value on a rounding boundary lands one step apart and a LayerNorm's
    1/std carries such steps on (measured at most 2 steps here).
  * the tiny slice's losses: 2e-2 * max(1, |jax|). Through 2 + 2 + 2 bf16
    layers, the bf16 heads and the softmax cross-entropies the one-step
    differences add up (measured below 1e-2).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sceneverse_tpu.config import load_config
from sceneverse_tpu.data.build import get_dataset, numpy_collate
from sceneverse_tpu.utils.precision import enable_mixed_precision
from test_torch_modules import D, FF, H, _mask, carry, jbuild
from test_torch_slice import CFG, PARITY, TINY, _flat

BF16_STEP = 2.0 ** -8
GATES = ("SCENEVERSE_CAP_CLS_ONLY", "SCENEVERSE_LN_BF16",
         "SCENEVERSE_FUSED_MHA", "SCENEVERSE_FLASH_ATTN")


@pytest.fixture
def plain_attention(monkeypatch):
    """Both sides on their plain attention path (no Pallas kernel), so the
    bf16 checks see only the towers' own rounding points."""
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")


def _bf16_close(got, want, steps=4):
    assert got.dtype == torch.bfloat16, got.dtype
    assert want.dtype == jnp.bfloat16, want.dtype
    g = got.float().detach().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= steps * BF16_STEP * max(1.0, np.abs(w).max()), err


# ------------------------------------------------ 1. SCENEVERSE_CAP_CLS_ONLY
@pytest.fixture(scope="module")
def tiny_models():
    """The tiny slice's JAX and port models (eval mode, same weights) and
    one batch."""
    from sceneverse_tpu.model import build_model as jbuild_model
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.model import build_model as tbuild_model

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        cfg = load_config(CFG, PARITY)
        ds = get_dataset(cfg, "train")
        items = [ds[i] for i in range(len(ds))
                 if (ds[i]["masked_lm_labels"] != -1).any()][:2]
        batch = {k: v for k, v in numpy_collate(items).items()
                 if isinstance(v, np.ndarray)}
        jm = nnx.jit(lambda: jbuild_model(cfg, rngs=nnx.Rngs(0)))()
        jm.eval()
        tm = tbuild_model(cfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        assert not missing and not unexpected
        tm.eval()
    return cfg, jm, tm, batch


@pytest.mark.parametrize("gate", ["on", "off", "1", "true", None])
def test_cap_cls_only_gate_matches_jax(tiny_models, monkeypatch, gate):
    """The port's caption embed against JAX's ``_lang_cls`` under the same
    gate; with the gate off, the port's final caption layer takes every
    query row (no ``q_rows``) and the embed is the full tower's [:, 0]."""
    from sceneverse_tpu_torch.modules.language import bert

    _, jm, tm, batch = tiny_models
    monkeypatch.delenv("SCENEVERSE_CAP_CLS_ONLY", raising=False)
    if gate is not None:
        monkeypatch.setenv("SCENEVERSE_CAP_CLS_ONLY", gate)
    seen = []
    orig = bert.BertLayer.forward

    def spy(self, x, pad_add, q_rows=None):
        seen.append(q_rows)
        return orig(self, x, pad_add, q_rows)

    monkeypatch.setattr(bert.BertLayer, "forward", spy)
    ids, masks = batch["scene_txt_ids"], batch["scene_txt_masks"]
    want = np.asarray(jm._lang_cls(jnp.asarray(ids), jnp.asarray(masks)))
    with torch.no_grad():
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
        got = out["scene_text_embed"].numpy()
        full = tm.lang_encoder(torch.from_numpy(ids),
                               torch.from_numpy(masks))[:, 0].numpy()
    n_layers = len(tm.lang_encoder.model.encoder.layer)
    # the utterance call, the caption call, then the full-tower reference
    caption = seen[n_layers:2 * n_layers]
    if gate == "off":
        assert caption == [None] * n_layers
        assert np.array_equal(got, full)
    else:
        assert caption == [None] * (n_layers - 1) + [1]
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# ------------------------------------------------ 2. bf16 LayerNorm / Embed
@pytest.mark.parametrize("ln_bf16", ["on", "off"])
def test_bert_embeddings_and_layer_follow_jax_bf16(plain_attention,
                                                   monkeypatch, ln_bf16):
    from sceneverse_tpu.modules.language.bert import BERTLanguageEncoder as J
    from sceneverse_tpu_torch.modules.language.bert import (
        BERTLanguageEncoder as T)

    monkeypatch.setenv("SCENEVERSE_LN_BF16", ln_bf16)
    rng = np.random.RandomState(10)
    jm = jbuild(J, 10, hidden_size=D, num_hidden_layers=1,
                num_attention_heads=H)
    tm = T(hidden_size=D, num_hidden_layers=1, num_attention_heads=H)
    carry(jm, tm)
    enable_mixed_precision(jm)
    ids = rng.randint(0, 30522, (2, 11))
    mask = _mask(rng, 2, 11).astype(np.int64)
    jbert = jm.model
    jemb = nnx.jit(lambda m, a: m(a))(jbert.embeddings, jnp.asarray(ids))
    with torch.autocast("cpu", torch.bfloat16):
        temb = tm.model.embeddings(torch.tensor(ids))
        tout = tm(torch.tensor(ids), torch.tensor(mask))
    jout = nnx.jit(lambda m, a, b: m(a, b))(jm, jnp.asarray(ids),
                                            jnp.asarray(mask))
    word = tm.model.embeddings.word_embeddings
    with torch.autocast("cpu", torch.bfloat16):
        assert word(torch.tensor(ids)).dtype == torch.bfloat16
    if ln_bf16 == "on":
        _bf16_close(temb, jemb)
        _bf16_close(tout, jout)
    else:  # f32 LayerNorm outputs on both sides
        assert temb.dtype == torch.float32 and jemb.dtype == jnp.float32
        assert tout.dtype == torch.float32 and jout.dtype == jnp.float32
        for g, w in ((temb, jemb), (tout, jout)):
            w = np.asarray(w)
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 4 * BF16_STEP * max(1.0, np.abs(w).max()), err


def test_spatial_cond_layer_follows_jax_bf16(plain_attention):
    from sceneverse_tpu.modules.layers.transformers import (
        TransformerSpatialEncoderLayer as J)
    from sceneverse_tpu.ops.geometry import calc_pairwise_locs
    from sceneverse_tpu_torch.modules.layers.transformers import (
        TransformerSpatialEncoderLayer as T)

    rng = np.random.RandomState(12)
    kw = dict(dim_feedforward=FF, activation="gelu", spatial_dim=5,
              spatial_multihead=True, spatial_attn_fusion="cond")
    jm = jbuild(lambda **k: J(D, H, **k), 12, **kw)
    tm = T(D, H, **kw)
    carry(jm, tm)
    enable_mixed_precision(jm)
    x = rng.randn(2, 7, D).astype(np.float32)
    locs = np.asarray(calc_pairwise_locs(
        jnp.asarray(rng.randn(2, 7, 3).astype(np.float32))))
    pad = ~_mask(rng, 2, 7)
    want, _ = nnx.jit(lambda m, a, l, p: m(a, l, tgt_key_padding_mask=p))(
        jm, jnp.asarray(x), jnp.asarray(locs), jnp.asarray(pad))
    with torch.autocast("cpu", torch.bfloat16):
        got, _ = tm(torch.tensor(x), torch.tensor(locs),
                    tgt_key_padding_mask=torch.tensor(pad))
    _bf16_close(got, want)


def test_unified_encoder_layer_follows_jax_bf16(plain_attention):
    from sceneverse_tpu.modules.grounding.unified_encoder import (
        UnifiedSpatialCrossEncoderV2 as J)
    from sceneverse_tpu_torch.modules.grounding.unified_encoder import (
        UnifiedSpatialCrossEncoderV2 as T)

    rng = np.random.RandomState(14)
    kw = dict(hidden_size=D, num_attention_heads=H, num_layers=1,
              dim_feedforward=FF)
    jm = jbuild(J, 14, **kw)
    tm = T(**kw)
    carry(jm, tm)
    enable_mixed_precision(jm)
    txt = rng.randn(2, 6, D).astype(np.float32)
    obj = rng.randn(2, 5, D).astype(np.float32)
    txt_m = _mask(rng, 2, 6).astype(np.int64)
    obj_m = _mask(rng, 2, 5)
    locs = rng.randn(2, 5, 6).astype(np.float32)
    want = nnx.jit(lambda m, *a: m(*a))(
        jm, *map(jnp.asarray, (txt, txt_m, obj, locs, obj_m)))
    with torch.autocast("cpu", torch.bfloat16):
        got = tm(*map(torch.tensor, (txt, txt_m, obj, locs, obj_m)))
        # the loc layer's LayerNorm and the token-type embedding alone
        assert tm.loc_layers[0](torch.tensor(locs)).dtype == torch.bfloat16
        assert tm.token_type_embeddings(
            torch.zeros(2, 3, dtype=torch.long)).dtype == torch.bfloat16
    for g, w in zip(got, want):
        _bf16_close(g, w)


def test_pretrain_head_follows_jax_bf16(plain_attention):
    from sceneverse_tpu.modules.heads.pretrain_head import OVPretrainHead as J
    from sceneverse_tpu_torch.modules.heads.pretrain_head import (
        OVPretrainHead as T)

    rng = np.random.RandomState(15)
    jm = jbuild(J, 15, hidden_size=D, vocab_size=100)
    tm = T(hidden_size=D, vocab_size=100)
    carry(jm, tm)
    enable_mixed_precision(jm)
    txt = rng.randn(2, 4, D).astype(np.float32)
    obj = rng.randn(2, 5, D).astype(np.float32)
    want = nnx.jit(lambda m, a, b: m(a, b))(jm, jnp.asarray(txt),
                                            jnp.asarray(obj))
    # the head's LayerNorm alone, on an f32 input: bf16 on both sides
    jln = nnx.jit(lambda m, a: m(a))(jm.lm_pred_head.transform.LayerNorm,
                                     jnp.asarray(txt))
    with torch.autocast("cpu", torch.bfloat16):
        got = tm(torch.tensor(txt), torch.tensor(obj))
        tln = tm.lm_pred_head.transform.LayerNorm(torch.tensor(txt))
    _bf16_close(tln, jln)
    for g, w in zip(got, want):
        _bf16_close(g, w)


def test_precision_modules_are_the_torch_modules_outside_autocast():
    """f32 and no autocast: bit for bit the torch modules; the subclasses
    keep the no-decay and init ``isinstance`` checks and parameter names."""
    from torch import nn

    from sceneverse_tpu_torch.utils.precision import Embedding, LayerNorm

    torch.manual_seed(0)
    ln, emb = LayerNorm(8, eps=1e-5), Embedding(5, 8)
    ref_ln, ref_emb = nn.LayerNorm(8, eps=1e-5), nn.Embedding(5, 8)
    ref_ln.load_state_dict(ln.state_dict())
    ref_emb.load_state_dict(emb.state_dict())
    x, ids = torch.randn(3, 8), torch.tensor([[0, 4, 2]])
    assert torch.equal(ln(x), ref_ln(x)) and torch.equal(emb(ids), ref_emb(ids))
    assert isinstance(ln, nn.LayerNorm) and isinstance(emb, nn.Embedding)
    assert sorted(ln.state_dict()) == ["bias", "weight"]
    assert list(emb.state_dict()) == ["weight"]


def test_tiny_slice_bf16_losses_match_jax(tiny_models, plain_attention):
    """One bf16 forward of the tiny slice on both sides (JAX after
    ``enable_mixed_precision`` on a copy of the model, the port under
    ``torch.autocast``): the losses agree and the towers' outputs are
    bf16 where JAX's are."""
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    cfg, jm, tm, batch = tiny_models
    jm = nnx.clone(jm)
    enable_mixed_precision(jm)
    loss_mod = build_optim(cfg, jm, total_steps=10)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")

        @nnx.jit
        def jfwd(m, b):
            out = m(b)
            return out, loss_mod(out)[1]

        jout, jlosses = jfwd(jm, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
            tout = tm({k: torch.from_numpy(v) for k, v in batch.items()})
            _, tlosses = Loss(cfg)(tout)
    assert jout["scene_text_embed"].dtype == jnp.bfloat16
    assert tout["scene_text_embed"].dtype == torch.bfloat16
    assert set(jlosses) == set(tlosses)
    for k in jlosses:
        want, got = float(jlosses[k]), float(tlosses[k])
        assert np.isfinite(got), k
        assert abs(got - want) <= 2e-2 * max(1.0, abs(want)), (k, got, want)


# ----------------------------------------------------------- 3. LR log rows
def test_lr_rows_follow_jax_schedule(tmp_path):
    from sceneverse_tpu.optim.scheduler import get_schedule_fn
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_trainer

    over = TINY + ["solver.epochs=3", "solver.sched.args.warmup_steps=1",
                   f"exp_dir={tmp_path}"]
    trainer = build_trainer(tload(CFG, over), device="cpu")
    rows = []
    trainer.logger.log = lambda row, step=None: rows.append((step, row))
    trainer.train_step(0)
    sched = get_schedule_fn(load_config(CFG, over), trainer.total_steps)
    assert [s for s, _ in rows] == [1, 2]
    for step, row in rows:
        ratio = float(sched(step))
        for i, (_, base_lr) in enumerate(trainer.optimizer.group_info):
            assert np.isclose(row[f"train/lr/group_{i}"], base_lr * ratio,
                              rtol=1e-6, atol=0.0), (step, i)


# ------------------------------------------------- 4. one record per loader
class _Recorder:
    """A stand-in evaluator: counts updates, records (is_best, results) of
    its own; the k-th record is best when k is in ``best``."""

    def __init__(self, best):
        self.best, self.n, self.k = best, 0, 0

    def update(self, data):
        self.n += 1

    def record(self):
        self.k += 1
        return self.k in self.best, {f"n_{self.k}": float(self.n),
                                     "target_metric": float(self.k)}

    def reset(self):
        self.n = 0


def _jax_eval_loop(loaders, ev):
    from sceneverse_tpu.trainer.default_trainer import DefaultTrainer

    logged = []
    fake = types.SimpleNamespace(
        model=types.SimpleNamespace(eval=lambda: None),
        _val_evaluator=lambda: ev, data_loaders={"val": loaders},
        _fusable_metrics=lambda e: None, forward=lambda d: {},
        log=lambda r, mode: logged.append((mode, dict(r))))
    return DefaultTrainer._eval_loop(fake, "val", "val"), logged


@pytest.mark.parametrize("best", [(), (1,), (2,), (1, 2)])
def test_eval_loop_records_each_loader(best):
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.trainer.openvocab_trainer import (
        OpenVocabTrainer)

    loaders = [[{"a": np.zeros(1)}] * 3, [{"a": np.zeros(1)}] * 2]
    logged = []
    ev = _Recorder(best)
    fake = types.SimpleNamespace(
        evaluator={"val": ev}, _val_evaluator=lambda: ev,
        data_loaders={"val": loaders}, _fusable_metrics=lambda e: None,
        device_batch=lambda h: to_device(h, "cpu"),
        forward=lambda b: {}, history={"val": []},
        log=lambda r, mode: logged.append((mode, dict(r))))
    got = OpenVocabTrainer._eval_loop(fake, "val", "val")
    want, jlogged = _jax_eval_loop(loaders, _Recorder(best))
    assert got == want
    assert logged == jlogged and len(logged) == 2
    assert fake.history["val"] == [r for _, r in jlogged]
    assert got[1]["n_1"] == 3.0 and got[1]["n_2"] == 2.0
    assert got[0] == bool(best)


# ------------------------------------------------------ 5. mixed_precision
@pytest.mark.parametrize("value", ["no", "fp32", "32", "bf16", "bfloat16",
                                   "fp16", "16", "BF16", "full"])
def test_mixed_precision_values_follow_jax(tmp_path, value):
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import BaseTrainer

    cfg = tload(CFG, TINY + [f"mixed_precision={value}",
                             f"exp_dir={tmp_path}"])
    trainer = BaseTrainer(cfg, device="cpu")
    # the JAX trainer's rule (trainer/build.py:181-186)
    jax_bf16 = value.lower() in ("bf16", "bfloat16", "fp16", "16")
    assert trainer.amp_dtype == (torch.bfloat16 if jax_bf16 else None)
    with trainer.autocast():
        assert torch.is_autocast_enabled("cpu") == jax_bf16

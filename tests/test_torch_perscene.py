"""Port parity for ``OpenVocabPerScene`` and ``PretrainHeadV1``.

Setup: ``tests/test_model_optim.py``'s tiny GPS config (hidden 32, 2 layers
a tower, trainable PointNet++, ``OVPretrainHead`` over 100 words) and its
per-scene batch: B = 2 scenes x L = 3 sentences x T = 7 tokens, 5 objects
x 64 points, (B, L, T) ``masked_lm_labels``; with no masked-position gather
and with ``lm_max_predictions`` 3 (the gather reads the (B, L, T) labels as
the B*L rows the text ran at). Eval mode on both sides, the JAX weights
carried by ``from_jax_params``, ``SCENEVERSE_FUSED_MHA=off`` on both sides
(the interpret-mode kernel's trace would cost seconds a model; the fused
attention is held by ``tests/test_torch_mha.py``).

Tolerances, on max|port - jax| / max(1, max|jax|): 1e-5 for every output
and ``lm_cls_loss`` (f32 in another summation order: eval BatchNorm, the
towers); the gathered labels exactly. The per-scene
forward against ``OpenVocab`` on the B*L rows with each scene's objects
repeated, the same weights: 1e-5 (the same arithmetic at other batch
sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sceneverse_tpu_torch.config import Config as TConfig
from test_model_optim import gps_batch, tiny_gps_cfg
from test_torch_slice import _flat

B, L, T, O, VOCAB = 2, 3, 7, 5, 100
TOL = 1e-5
KEYS = ["og3d_logits", "txt_lm_cls_logits", "obj_cls_post_logits",
        "obj_cls_raw_logits", "inter_text_embed", "inter_obj_embeds",
        "intra_text_embed", "intra_obj_embeds"]


def _batch():
    """test_model_optim.py:98-112 / 420-441: the per-scene fields."""
    b = {k: np.array(v) for k, v in gps_batch().items()}
    r = np.random.RandomState(1)
    b["txt_ids"] = r.randint(0, VOCAB, (B, L, T))
    b["txt_masks"] = np.ones((B, L, T), np.int32)
    b["txt_masks"][1, 2, 5:] = 0  # a padded sentence
    b["tgt_object_id"] = r.randint(0, O, (B, L))
    labels = np.where(r.rand(B, L, T) < 0.3, r.randint(0, VOCAB, (B, L, T)),
                      -1)
    labels[:, :, 2] = r.randint(0, VOCAB, (B, L))  # each sentence masks one
    b["masked_lm_labels"] = labels
    return b


def _cfg(k):
    cfg = tiny_gps_cfg()
    cfg.model.name = "OpenVocabPerScene"
    cfg.model.lm_max_predictions = k
    return cfg


@pytest.fixture(scope="module", params=[0, 3], ids=["no-gather", "gather3"])
def perscene(request):
    """Both packages' per-scene outputs and lm_cls_loss, and the port's
    model."""
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim.loss import loss as JL
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.loss import loss as TL

    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        cfg = _cfg(request.param)
        jm = jbuild(cfg, rngs=nnx.Rngs(0))
        jm.eval()
        jout = nnx.jit(lambda m, b: m(b))(
            jm, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tbuild(TConfig(cfg.to_dict()))
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            tout = tm(tb)
    return {"jax": jout, "port": tout, "model": tm, "batch": batch,
            "missing": missing, "unexpected": unexpected, "k": request.param,
            "loss": (float(JL.lm_cls_loss(jout)),
                     float(TL.lm_cls_loss(tout)))}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_perscene_weights_carry(perscene):
    assert perscene["unexpected"] == []
    assert all(k.endswith("num_batches_tracked") for k in perscene["missing"])


def test_perscene_outputs_match_jax(perscene):
    j, t = perscene["jax"], perscene["port"]
    assert tuple(t["og3d_logits"].shape) == (B, L, O)
    K = perscene["k"] or T
    assert tuple(t["txt_lm_cls_logits"].shape) == (B * L, K, VOCAB)
    assert tuple(t["obj_cls_raw_logits"].shape) == (B, O, 607)
    assert "txt_cls_logits" not in t  # no ground head in this variant
    for k in KEYS:
        assert _close(t[k].numpy(), np.asarray(j[k])), k
    np.testing.assert_array_equal(t["masked_lm_labels"].numpy(),
                                  np.asarray(j["masked_lm_labels"]))
    jl, tl = perscene["loss"]
    assert abs(tl - jl) <= TOL * max(1.0, abs(jl))


def test_perscene_gather_reads_the_sentence_rows(perscene):
    """With K = 3 the first gathered slot of each of the B*L rows is that
    sentence's masked position 2 (``test_model_optim.py:420-441``)."""
    got = perscene["port"]["masked_lm_labels"].numpy()
    labels = perscene["batch"]["masked_lm_labels"]
    if perscene["k"]:
        assert got.shape == (B * L, 3)
        first = labels.reshape(B * L, T)[:, :3]
        assert ((got != -1).sum(1) == np.minimum(
            (labels.reshape(B * L, T) != -1).sum(1), 3)).all()
        np.testing.assert_array_equal(
            got[:, 0], np.where(first[:, 0] != -1, first[:, 0],
                                np.where(first[:, 1] != -1, first[:, 1],
                                         first[:, 2])))
    else:
        assert got.shape == (B, L, T)


def test_perscene_equals_openvocab_on_repeated_objects(perscene):
    """The per-scene forward is ``OpenVocab`` over the B*L sentence rows
    with each scene's objects, locations and masks repeated L times."""
    from sceneverse_tpu_torch.model import build_model

    cfg = _cfg(perscene["k"])
    cfg.model.name = "OpenVocab"
    ov = build_model(TConfig(cfg.to_dict()))
    ov.load_state_dict(perscene["model"].state_dict())
    ov.eval()
    b = perscene["batch"]
    flat = {k: torch.from_numpy(np.repeat(v, L, axis=0)) for k, v in b.items()
            if k.startswith("obj_")}
    for k in ("txt_ids", "txt_masks", "masked_lm_labels"):
        flat[k] = torch.from_numpy(b[k].reshape(B * L, T))
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        want = ov(flat)
    got = perscene["port"]
    assert _close(got["og3d_logits"].reshape(B * L, O), want["og3d_logits"])
    for k in ("txt_lm_cls_logits", "obj_cls_post_logits", "intra_text_embed",
              "intra_obj_embeds", "inter_text_embed", "inter_obj_embeds"):
        assert _close(got[k], want[k]), k
    np.testing.assert_array_equal(
        got["masked_lm_labels"].reshape(B * L, -1).numpy(),
        want["masked_lm_labels"].numpy())
    assert _close(got["obj_cls_raw_logits"].repeat_interleave(L, 0),
                  want["obj_cls_raw_logits"])


def test_pretrain_head_v1_matches_jax():
    from sceneverse_tpu.modules.heads.pretrain_head import \
        PretrainHeadV1 as JHead
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.modules.build import HEADS_REGISTRY

    jh = JHead(hidden_size=32, vocab_size=VOCAB, rngs=nnx.Rngs(3))
    th = HEADS_REGISTRY.get("PretrainHeadV1")(hidden_size=32,
                                              vocab_size=VOCAB)
    missing, unexpected = load_jax_params(th, _flat(nnx.state(jh,
                                                              nnx.Param)))
    assert missing == [] and unexpected == []
    x = np.random.RandomState(2).randn(B * L, T, 32).astype(np.float32)
    want = np.asarray(jh(jnp.asarray(x)))
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    assert got.shape == (B * L, T, VOCAB)
    assert _close(got, want)
    assert not isinstance(th(torch.from_numpy(x)), tuple)

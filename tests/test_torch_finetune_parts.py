"""The parts of the port's finetune and QA path against the JAX package, each
on its own inputs made from a seed:

  * every functional loss, value and gradient with respect to its logits,
    on random inputs with -inf-masked og3d logits, -100 pad labels and
    label smoothing (the JAX cross entropy's custom VJP against autograd);
  * ``TextObjBetweenBatch``, ``TextObjWithinBatch`` and its per-scene
    repeat; the ScanQA BCE branch against the reference formula (see its
    test: the JAX branch raises on these shapes);
  * the heads with the JAX weights carried over (``from_jax_params``, no
    name missing or left over), outputs and input gradients;
  * the head groups of ``get_opt_params`` and the per-val-dataset
    ``build_eval``;
  * ``ScanReferEval`` (per-scene too), ``ReferIt3DEval``, ``ScanQAEval``
    and ``SQA3DEval`` over two batches of random scores (no ties:
    ``lax.top_k`` and ``torch.topk`` may order ties differently), and the
    ``eval.save`` rows of the first three;
  * ``ScanNetScanQAOld`` and ``ScanNetSQA3D`` items through the wrapper,
    bit-equal on every split (``np.random`` and ``random`` seeded before
    every item on both sides: train items draw from them);
  * ``common/box_utils.py``;
  * ``run_torch.main`` on the four finetune configs on the CPU, the
    ScanQA one in a subprocess that imports no JAX.
"""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import REPO, TINY, _RUN, _flat

FINETUNE = os.path.join(REPO, "configs", "final", "finetune")
B, O, C, A = 4, 6, 9, 12  # batch, objects, classes, answers


def _rand(seed):
    return np.random.default_rng(seed)


def _loss_batch(seed):
    """Random inputs of every functional loss: pads (mask 0, label -100),
    og3d logits -inf at pads."""
    r = _rand(seed)
    masks = np.ones((B, O), bool)
    masks[0, 4:] = masks[2, 5:] = False
    og = r.normal(size=(B, O)).astype(np.float32)
    og[~masks] = -np.inf
    labels = r.integers(0, C, (B, O)).astype(np.int64)
    labels[~masks] = -100
    return {
        "og3d_logits": og,
        "tgt_object_id": np.array([[1], [3], [0], [5]], np.int64),
        "txt_cls_logits": r.normal(size=(B, C)).astype(np.float32),
        "tgt_object_label": (r.random((B, C)) < 0.3).astype(np.int64),
        "obj_cls_raw_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_cls_pre_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_cls_post_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_labels": labels,
        "obj_masks": masks,
        "obj_sem_masks": r.random((B, O)) < 0.5,
        "answer_scores": r.normal(size=(B, A)).astype(np.float32),
        "answer_label": (r.random((B, A)) < 0.2).astype(np.int64),
        "txt_lm_cls_logits": r.normal(size=(B, 7, C)).astype(np.float32),
        "masked_lm_labels": np.where(r.random((B, 7)) < 0.4,
                                     r.integers(0, C, (B, 7)), -1),
        "pred_images": r.normal(size=(B, 3, 4)).astype(np.float32),
        "target_images": r.normal(size=(B, 3, 4)).astype(np.float32),
    }


# the loss, and the logits its gradient is taken against
LOSSES = {
    "og3d_loss": "og3d_logits",
    "og3d_multi_loss": None,
    "txt_cls_multi_loss": "txt_cls_logits",
    "obj_cls_raw_loss": "obj_cls_raw_logits",
    "obj_cls_pre_loss": "obj_cls_pre_logits",
    "obj_cls_post_loss": "obj_cls_post_logits",
    "answer_loss": "answer_scores",
    "lm_cls_loss": "txt_lm_cls_logits",
    "obj_cls_pre_loss_mask": "obj_cls_pre_logits",
    "obj_cls_pre_loss_unmask": "obj_cls_pre_logits",
    "obj_cls_post_loss_mask": "obj_cls_post_logits",
    "obj_cls_post_loss_unmask": "obj_cls_post_logits",
    "obj_cls_loss": "obj_logits",
    "mse_loss": "pred_images",
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_functional_loss_and_its_gradient_match_jax(name):
    from sceneverse_tpu.optim.loss import loss as jl
    from sceneverse_tpu_torch.optim.loss import loss as tl

    d = _loss_batch(0)
    if name == "og3d_multi_loss":  # a (B, O) multi-hot target, finite logits
        d["og3d_logits"] = np.nan_to_num(d["og3d_logits"], neginf=-3.0)
        d["tgt_object_id"] = (_rand(1).random((B, O)) < 0.3).astype(np.int64)
    key = LOSSES[name] or "og3d_logits"
    jfn, tfn = getattr(jl, name), getattr(tl, name)

    def jloss(x):
        return jfn({**{k: jnp.asarray(v) for k, v in d.items()}, key: x})

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(d[key]))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    x = tb[key].clone().requires_grad_(True)
    got = tfn({**tb, key: x})
    got.backward()
    got = got.detach()
    assert np.isfinite(float(want))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    jg, tg = np.asarray(jgrad), x.grad.numpy()
    assert np.isfinite(tg).all() and np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_cross_entropy_with_label_smoothing_matches_jax(smoothing):
    from sceneverse_tpu.optim.loss.loss import cross_entropy as jce
    from sceneverse_tpu_torch.optim.loss.loss import cross_entropy as tce

    r = _rand(2)
    logits = r.normal(size=(5, 7, 11)).astype(np.float32) * 3
    labels = r.integers(-1, 12, (5, 7))  # out-of-range labels clamp
    want, jg = jax.value_and_grad(
        lambda x: jnp.sum(jce(x, jnp.asarray(labels), smoothing)
                          * jnp.arange(7.0)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = (tce(x, torch.from_numpy(labels), smoothing) * torch.arange(7.0)
           ).sum()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def _contra_inputs(seed, rows=B):
    r = _rand(seed)
    return {
        "intra_obj_embeds": r.normal(size=(rows, O, 8)).astype(np.float32),
        "intra_text_embed": r.normal(size=(rows, 8)).astype(np.float32),
        "inter_obj_embeds": r.normal(size=(rows, O, 8)).astype(np.float32),
        "inter_text_embed": r.normal(size=(rows, 8)).astype(np.float32),
        "obj_masks": np.arange(O)[None] < np.array([[6], [4], [5], [3]]),
        "tgt_object_id": np.array([[1], [3], [0], [2]], np.int64),
    }


def _contra(cls_name, d, task="Pretrain"):
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.optim.loss import contra_loss as jc
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.optim.loss import contra_loss as tc

    want = getattr(jc, cls_name)(JConfig({"task": task}))(
        {k: jnp.asarray(v) for k, v in d.items()})
    got = getattr(tc, cls_name)(TConfig({"task": task}))(
        {k: torch.from_numpy(v) for k, v in d.items()})
    return float(want), float(got)


@pytest.mark.parametrize("cls_name",
                         ["TextObjWithinBatch", "TextObjBetweenBatch"])
@pytest.mark.parametrize("per_scene", [False, True])
def test_contrastive_losses_match_jax(cls_name, per_scene):
    """With ``per_scene`` the texts are B * L rows (L = 3) over B scenes'
    objects: the masks repeat per scene (JAX ``contra_loss.py:47-51``) and
    each row takes its own target."""
    d = _contra_inputs(3)
    if per_scene:
        rows = _contra_inputs(4, rows=3 * B)
        d.update({k: rows[k] for k in ("intra_obj_embeds", "intra_text_embed",
                                       "inter_obj_embeds",
                                       "inter_text_embed")})
        # (B, L) targets, each within its scene's real objects
        d["tgt_object_id"] = np.array([[1, 0, 5], [3, 2, 0], [4, 1, 0],
                                       [2, 0, 1]], np.int64)
    want, got = _contra(cls_name, d)
    assert np.isfinite(want) and want > 0
    assert got == pytest.approx(want, rel=1e-6)


def test_scanqa_bce_branch_follows_the_reference_formula():
    """``task: ScanQA`` (``scanqa_finetune.yaml``): BCE with logits of the
    cosine logits against the (B, O) multi-hot of target objects, weighted
    by ``obj_masks``, summed, over B (reference contra_loss.py:11-39,
    SURVEY.md F3). The JAX package takes ``labels[..., -1]`` first
    (``sceneverse_tpu/optim/loss/contra_loss.py:55-60``) and so meets (B, O)
    logits with (B,) labels: ``ValueError: Incompatible shapes for
    broadcasting`` at B != O (at the config's B = 32, O = 80), a wrong loss
    at B = O. The port is held to the formula, written with JAX's own
    ``bce_with_logits``."""
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.optim.loss.contra_loss import TextObjWithinBatch
    from sceneverse_tpu.optim.loss.loss import bce_with_logits

    d = _contra_inputs(5)
    d["tgt_object_id"] = np.zeros((B, O), np.int64)
    d["tgt_object_id"][[0, 0, 1, 2, 3], [1, 2, 3, 0, 2]] = 1
    d["tgt_object_id"][1, 4] = 1  # the "no target" slot, a pad: weight 0
    j = {k: jnp.asarray(v) for k, v in d.items()}

    def norm(x):
        return x / jnp.clip(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    logits = jnp.einsum("bod,bd->bo", norm(j["intra_obj_embeds"]),
                        norm(j["intra_text_embed"]))
    want = float(jnp.sum(bce_with_logits(
        logits, j["tgt_object_id"].astype(jnp.float32),
        weight=j["obj_masks"].astype(jnp.float32))) / B)
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.optim.loss import contra_loss as tc

    got = float(tc.TextObjWithinBatch(TConfig({"task": "ScanQA"}))(
        {k: torch.from_numpy(v) for k, v in d.items()}))
    assert want > 0 and got == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        TextObjWithinBatch(JConfig({"task": "ScanQA"}))(j)


def test_an_unregistered_loss_name_fails_at_build_in_both():
    """``txt_cls_loss``, whose label rewrite both aggregators carry (JAX
    ``loss.py:253-255``), is registered in neither package."""
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.optim.loss.loss import Loss as JLoss
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.optim.loss.loss import Loss as TLoss

    cfg = {"model": {"loss_list": ["og3d_loss", "txt_cls_loss"]}}
    for loss_cls, config in ((JLoss, JConfig), (TLoss, TConfig)):
        with pytest.raises(KeyError, match="txt_cls_loss"):
            loss_cls(config(cfg))


def test_loss_aggregator_sums_the_finetune_losses_as_jax():
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.optim.loss.loss import Loss as JLoss
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.optim.loss.loss import Loss as TLoss

    cfg = {"model": {"loss_list": ["og3d_loss", "obj_cls_pre_loss",
                                   "TextObjWithinBatch"],
                     "vis_loss_list": ["og3d_loss", "obj_cls_post_loss",
                                       "TextObjBetweenBatch"]}}
    d = {**_loss_batch(6), **_contra_inputs(7)}
    jt, jl = JLoss(JConfig(cfg))({k: jnp.asarray(v) for k, v in d.items()})
    tt, tl = TLoss(TConfig(cfg))({k: torch.from_numpy(np.asarray(v))
                                  for k, v in d.items()})
    assert sorted(tl) == sorted(jl)
    for k in jl:
        assert float(tl[k]) == pytest.approx(float(jl[k]), rel=1e-6), k
    assert float(tt) == pytest.approx(float(jt), rel=1e-6)


# ------------------------------------------------------------------ heads
HEADS = {
    "GroundHeadV1": {"input_size": 16, "hidden_size": 12, "sem_cls_size": 9,
                     "dropout": 0.3, "detach_all_aux_loss": False},
    "GroundHeadV1_detach": {"input_size": 16, "hidden_size": 12,
                            "sem_cls_size": 9, "dropout": 0.3,
                            "detach_all_aux_loss": True},
    "GroundHead": {"input_size": 16, "hidden_size": 12, "dropout": 0.3},
    "QAHeadV1": {"hidden_size": 16, "mlp_size": 8, "glimpse": 2,
                 "flat_out_size": 10, "num_answers": 7},
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax_with_its_weights_carried_over(name):
    """Eval mode on both sides. Outputs within 1e-5, and the gradients of a
    scalar of every output with respect to the head's inputs (so
    ``detach_all_aux_loss`` must cut the auxiliary heads' share)."""
    from flax import nnx

    from sceneverse_tpu.modules.heads import grounding_head as jg
    from sceneverse_tpu.modules.heads import qa_head as jq
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.modules.heads import grounding_head as tg
    from sceneverse_tpu_torch.modules.heads import qa_head as tq

    cls = name.split("_")[0]
    jmod = jq if cls == "QAHeadV1" else jg
    tmod = tq if cls == "QAHeadV1" else tg
    jh = getattr(jmod, cls)(**HEADS[name], rngs=nnx.Rngs(0))
    jh.eval()
    th = getattr(tmod, cls)(**HEADS[name])
    flat = _flat(nnx.state(jh, nnx.Not(nnx.RngState)))
    missing, unexpected = load_jax_params(th, flat)
    assert missing == [] and unexpected == []
    th.eval()
    r = _rand(8)
    masks = np.arange(O)[None] < np.array([[6], [4], [5], [3]])
    txt_masks = np.arange(5)[None] < np.array([[5], [3], [2], [4]])
    ins = {"txt": r.normal(size=(B, 5, 16)).astype(np.float32),
           "obj": r.normal(size=(B, O, 16)).astype(np.float32),
           "pre": r.normal(size=(B, O, 16)).astype(np.float32)}
    w = {k: r.normal(size=s).astype(np.float32) for k, s in
         (("txt_cls", (B, 9)), ("obj_cls", (B, O, 9)),
          ("obj_cls_pre", (B, O, 9)), ("og3d", (B, O)), ("ans", (B, 7)))}

    def call(h, x, m, tm, xp):
        if cls == "GroundHeadV1":
            outs = h(x["txt"], x["obj"], x["pre"], m)
            keys = ("txt_cls", "obj_cls", "obj_cls_pre", "og3d")
        elif cls == "GroundHead":
            outs, keys = (h(x["obj"], m),), ("og3d",)
        else:
            outs, keys = (h(x["obj"], m, x["txt"], tm),), ("ans",)
        return outs, keys

    def scalar(outs, keys, xp):
        tot = 0.0
        for o, k in zip(outs, keys):
            finite = xp.where(xp.isfinite(o), o, 0.0)  # og3d pads are -inf
            tot = tot + (finite * xp.asarray(w[k])).sum()
        return tot

    def jfn(x):
        outs, keys = call(jh, x, jnp.asarray(masks), jnp.asarray(txt_masks),
                          jnp)
        return scalar(outs, keys, jnp), outs

    (_, jouts), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in ins.items()})
    tx = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ins.items()}
    touts, keys = call(th, tx, torch.from_numpy(masks),
                       torch.from_numpy(txt_masks), torch)
    scalar(touts, keys, torch).backward()
    for k, j, t in zip(keys, jouts, touts):
        j, t = np.asarray(j), t.detach().numpy()
        assert t.shape == j.shape, k
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j), err_msg=k)
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if cls == "GroundHeadV1":
        assert np.isneginf(np.asarray(jouts[3])[~masks]).all()
    for k, x in tx.items():
        j = np.asarray(jgrads[k])
        t = np.zeros_like(j) if x.grad is None else x.grad.numpy()
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=k)
    if name == "GroundHeadV1_detach":
        assert tx["pre"].grad is None and not np.asarray(jgrads["pre"]).any()


class _Stub:
    def __init__(self, cfg):
        self.cfg, self.head_list = cfg, list(cfg.model.heads.head_list)


def test_opt_param_groups_follow_jax_head_order():
    """JAX orders the head groups ground, qa, pretrain whatever
    ``head_list``'s order (``model/openvocab.py:141-145`` there), which sets
    the ``lr/group_i`` log keys; the port followed ``head_list``."""
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.model.openvocab import OpenVocab as JOpenVocab
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.model.openvocab import OpenVocab as TOpenVocab

    cfg = {"solver": {"lr": 1e-4},
           "model": {"language": {"lr": 1e-5}, "vision": {}, "grounding": {},
                     "heads": {"head_list": ["pretrain_head", "qa_head",
                                             "ground_head"],
                               "pretrain_head": {"lr": 3e-4},
                               "qa_head": {}, "ground_head": {"lr": 2e-4}}}}
    want = JOpenVocab.get_opt_params(_Stub(JConfig(cfg)))
    got = TOpenVocab.get_opt_params(_Stub(TConfig(cfg)))
    assert [g["prefix"] for g in got] == [g["prefix"] for g in want]
    assert [g["lr"] for g in got] == [g["lr"] for g in want]
    assert [g["prefix"][0] for g in got][3:] == ["ground_head", "qa_head",
                                                "pretrain_head"]


def test_build_eval_per_val_dataset_form_matches_jax(tmp_path):
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.evaluator import build_eval as jbuild
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.evaluator import build_eval as tbuild

    cfg = {"exp_dir": str(tmp_path), "eval": {"save": False},
           "data": {"val": ["ScanNetSpatialRefer", "ScanNetSQA3D", "Nr3D"],
                    "ScanNetSpatialRefer": {"evaluator": "ScanReferEval"},
                    "ScanNetSQA3D": {"evaluator": "SQA3DEval"},
                    "Nr3D": {"evaluator": "ReferIt3DEval"}}}
    want = [type(e).__name__ for e in jbuild(JConfig(cfg))]
    got = [type(e).__name__ for e in tbuild(TConfig(cfg))]
    assert got == want == ["ScanReferEval", "SQA3DEval", "ReferIt3DEval"]


# ------------------------------------------------------------- evaluators
def _eval_batch(seed, per_scene=False):
    """Two-batch evaluator inputs: random scores (continuous: no ties),
    targets, IoU lists, split flags, class logits, boxes and ids."""
    r = _rand(seed)
    lead = (B, 3) if per_scene else (B,)
    masks = np.arange(O)[None] < r.integers(3, O + 1, (B, 1))
    tgt = r.integers(0, 3, lead + (1,)) if not per_scene else \
        r.integers(0, 3, lead)
    iou = (r.random(lead + (O,)) < 0.4).astype(np.int64)
    if per_scene:
        np.put_along_axis(iou, tgt[..., None], 1, axis=-1)
    else:
        np.put_along_axis(iou, tgt, 1, axis=-1)
    labels = r.integers(0, C, (B, O)).astype(np.int64)
    labels[~masks] = -100
    answer = (r.random((B, A)) < 0.15).astype(np.int64)
    answer[0] = 0  # an item with no answer in the vocabulary
    return {
        "og3d_logits": r.normal(size=lead + (O,)).astype(np.float32),
        "tgt_object_id": tgt.astype(np.int64),
        "tgt_object_id_iou25": iou,
        "tgt_object_id_iou50": iou * (r.random(iou.shape) < 0.7),
        "is_multiple": r.random(lead) < 0.5,
        "is_hard": r.random(lead) < 0.5,
        "is_view_dependent": r.random(lead) < 0.5,
        "txt_cls_logits": r.normal(size=(B, C)).astype(np.float32),
        "tgt_object_label": r.integers(0, C, (B, 1)).astype(np.int64),
        "obj_cls_post_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_cls_pre_logits": r.normal(size=(B, O, C)).astype(np.float32),
        "obj_labels": labels,
        "obj_masks": masks,
        "obj_boxes": r.normal(size=(B, O, 6)).astype(np.float32),
        "answer_scores": r.normal(size=(B, A)).astype(np.float32),
        "answer_label": answer,
        "sqa_type": np.array([0, 2, 2, 5]),
        "data_idx": [f"item{seed}_{i}" for i in range(B)],
        "scan_id": [f"scene{seed:04d}_0{i}" for i in range(B)],
    }


def _qa_tree(root):
    """ScanQA train json whose vocabulary has A answers (``eval.save``
    names the top-10 answers from it)."""
    os.makedirs(os.path.join(root, "annotations", "qa"))
    items = [{"answers": [f"answer {i}"]} for i in range(A)]
    with open(os.path.join(root, "annotations", "qa",
                           "ScanQA_v1.0_train.json"), "w") as f:
        json.dump(items, f)
    return str(root)


@pytest.mark.parametrize("name,per_scene", [
    ("ScanReferEval", False), ("ScanReferEval", True),
    ("ReferIt3DEval", False), ("ReferIt3DEval", True),
    ("ScanQAEval", False), ("SQA3DEval", False)])
def test_evaluator_matches_jax_over_two_batches(name, per_scene, tmp_path):
    import sceneverse_tpu.evaluator  # noqa: F401 (registry)
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.evaluator.build import EVALUATOR_REGISTRY as JREG
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.evaluator.build import get_eval

    save = not per_scene and name != "SQA3DEval"
    base = _qa_tree(tmp_path / "tree")
    cfg = {"eval": {"save": save}, "data": {"scan_family_base": base}}
    jev = JREG.get(name)(JConfig({**cfg, "exp_dir": str(tmp_path / "jax")}))
    tev = get_eval(name, TConfig({**cfg, "exp_dir": str(tmp_path / "torch")}))
    batches = []
    for seed in (10, 11):
        b = _eval_batch(seed, per_scene)
        if per_scene:  # the per-scene rows' ids are the scenes'
            b.pop("data_idx")
        batches.append((
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in b.items()},
            {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in b.items()}))
    for jb, tb in batches:  # the train-time ratios
        want = {k: float(v) for k, v in jev.batch_metrics(jb).items()}
        got = {k: float(v) for k, v in tev.batch_metrics(tb).items()}
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    jev.eval_results.clear()  # those calls saved rows too
    tev.eval_results.clear()
    for jb, tb in batches:
        jev.update(jb)
        tev.update(tb)
    _, want = jev.record()
    _, got = tev.record()
    assert sorted(got) == sorted(want)
    assert {k: float(v) for k, v in got.items()} == pytest.approx(
        {k: float(v) for k, v in want.items()}, rel=1e-12)
    assert 0.0 < got[tev.target_metric] < 1.0
    if name.startswith(("ScanRefer", "ReferIt3D")):
        assert "txt_acc" in got
    if name == "SQA3DEval":
        assert {f"type{t}_acc" for t in range(6)} <= set(got)
    if save:
        path = f"eval_results/{name}/results.json"
        rows = json.loads((tmp_path / "torch" / path).read_text())
        assert len(rows) == 2 * B
        assert rows == json.loads((tmp_path / "jax" / path).read_text())


def test_scanqa_gen_eval_matches_jax(tmp_path):
    """Free-form answers, cleaned on both sides before the match."""
    from sceneverse_tpu.config import Config as JConfig
    from sceneverse_tpu.evaluator.scanqa_eval import ScanQAGenEval as JGen
    from sceneverse_tpu_torch.config import Config as TConfig
    from sceneverse_tpu_torch.evaluator.scanqa_eval import \
        ScanQAGenEval as TGen

    cfg = {"exp_dir": str(tmp_path), "eval": {"save": False}}
    jev, tev = JGen(JConfig(cfg)), TGen(TConfig(cfg))
    batches = [
        {"answer_pred": ["A brown chair.", "two", "the  Table", "red"],
         "answers": [["brown chair"], ["2", "two"], ["table"], ["blue"]]},
        {"answer_pred": ["Yes", "on the left side"],
         "answers": [["yes"], ["left"]]}]
    for b in batches:
        assert tev.batch_metrics(b) == jev.batch_metrics(b)
        jev.update(b)
        tev.update(b)
    _, want = jev.record()
    _, got = tev.record()
    assert got == pytest.approx(want) and 0.0 < got["ans1_acc"] < 1.0


# --------------------------------------------------------------- datasets
QA_DATA = ["data.args.max_obj_len=5", "data.args.max_seq_len=16",
           "data.args.num_points=32", "data.args.pc_type=gt", "num_gpu=1"]


@pytest.fixture(scope="module")
def qa_tree(tmp_path_factory):
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    return write_synthetic_tree(tmp_path_factory.mktemp("qa"), n_scans=2,
                                n_objects=8, pts_per_obj=40)


def _clear_scan_caches():
    """Both packages cache QA scans by id module-wide: another test
    module's tree holds the same ids."""
    from sceneverse_tpu.data.datasets import scannet_qa as jqa
    from sceneverse_tpu_torch.data.datasets import scannet_qa as tqa

    jqa.SCAN_DATA.clear()
    tqa.SCAN_DATA.clear()


@pytest.mark.parametrize("config", ["scanqa_finetune", "sqa3d_finetune"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_qa_items_are_bit_equal_to_jax(qa_tree, config, split):
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data.build import get_dataset as jget
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.data.build import get_dataset as tget

    over = QA_DATA + [f"data.scan_family_base={qa_tree}"]
    path = os.path.join(FINETUNE, f"{config}.yaml")
    _clear_scan_caches()
    jds, tds = jget(jload(path, over), split), tget(tload(path, over), split)
    if split != "train":
        jds, tds = jds[0], tds[0]
    assert len(tds) == len(jds) == 6
    assert type(tds.dataset).__name__ == type(jds.dataset).__name__
    for i in range(len(jds)):
        items = []
        for ds in (jds, tds):
            np.random.seed(100 + i)
            random.seed(200 + i)
            items.append(ds[i])
        want, got = items
        assert list(got) == list(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
    assert want["tgt_object_id"].shape == (5,)  # the (O,) multi-hot
    assert want["answer_label"].shape == ((5,) if config == "scanqa_finetune"
                                          else (6,))


def test_box_utils_match_jax():
    from sceneverse_tpu.common import box_utils as jb
    from sceneverse_tpu_torch.common import box_utils as tb

    r = _rand(12)
    for _ in range(3):
        c1, s1 = r.normal(size=3), r.random(3) + 0.1
        c2, s2 = c1 + 0.2 * r.normal(size=3), r.random(3) + 0.1
        a, b = tb.get_3d_box(c1, s1), tb.get_3d_box(c2, s2)
        np.testing.assert_array_equal(a, jb.get_3d_box(c1, s1))
        assert tb.get_box3d_min_max(a) == jb.get_box3d_min_max(a)
        assert tb.box3d_iou(a, b) == jb.box3d_iou(a, b)
    assert tb.box3d_iou(a, a) == pytest.approx(1.0)


@pytest.mark.parametrize("config,target,head", [
    ("scanrefer_finetune", "og_acc_iou25", "ground_head"),
    ("nr3d_finetune", "og_acc", "ground_head"),
    ("sqa3d_finetune", "ans1_acc", "qa_head")])
def test_run_torch_finetune_cpu(qa_tree, tmp_path, config, target, head):
    """The other three finetune configs through ``run_torch.main`` on the
    CPU at tiny widths: two train steps from a pretrain-style checkpoint
    (the towers load, the head starts from its init), finite losses, the
    config's target metric in [0, 1] on the test pass."""
    import run_torch
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.model import build_model

    _clear_scan_caches()
    tiny = [a for a in TINY if "pretrain_head" not in a]
    pre = build_model(load_config(
        os.path.join(REPO, "configs", "final", "synthetic_pretrain.yaml"),
        TINY + QA_DATA))
    ckpt = tmp_path / "best.pth"
    torch.save({"model": pre.state_dict()}, ckpt)
    out = run_torch.main([
        "--config-path", FINETUNE, "--config-name", config, *tiny, *QA_DATA,
        f"data.scan_family_base={qa_tree}", "dataloader.batchsize=3",
        "dataloader.num_workers=0", "solver.epochs=1", "device=cpu",
        "model.heads.ground_head.args.input_size=64",
        "model.heads.ground_head.args.hidden_size=32",
        "model.heads.qa_head.args.hidden_size=64",
        "model.heads.qa_head.args.num_answers=6",
        f"pretrain_ckpt_path={ckpt}", f"base_dir={tmp_path}"])
    _clear_scan_caches()
    trainer, res = out["trainer"], out["results"]
    losses = [r["total_loss"] for r in trainer.history["train"]]
    head_keys = [k for k in trainer.model.state_dict()
                 if k.startswith(f"{head}.")]
    assert trainer.pretrain_loaded == (len(trainer.model.state_dict())
                                       - len(head_keys))
    assert len(losses) >= 2 and all(np.isfinite(x) for x in losses)
    assert 0.0 <= res[target] <= 1.0
    assert all(0.0 <= v <= 1.0 for k, v in res.items() if k != "best_result")


def test_run_torch_scanqa_finetune_cpu_without_jax(qa_tree, tmp_path):
    """``scanqa_finetune.yaml`` unchanged but for the data root, tiny
    widths and the answer head shrunk to the fixture's 5 answers: its
    ``answer_loss`` and ScanQA BCE branch train two steps, ``ScanQAEval``
    scores val and test."""
    args = ["--config-path", FINETUNE, "--config-name", "scanqa_finetune",
            *[a for a in TINY if "pretrain_head" not in a], *QA_DATA,
            f"data.scan_family_base={qa_tree}", "dataloader.batchsize=3",
            "dataloader.num_workers=0",
            "model.heads.qa_head.args.hidden_size=64",
            "model.heads.qa_head.args.num_answers=5", "solver.epochs=1",
            "device=cpu", f"base_dir={tmp_path}"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(repo=REPO, args=args)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["jax_package"] == []
    assert res["device"] == "cpu"
    assert len(res["losses"]) == 2
    assert all(np.isfinite(x) for x in res["losses"])
    assert {"ans1_acc", "ans10_acc"} <= set(res["test"])
    assert all(0.0 <= v <= 1.0 for k, v in res["test"].items()
               if k != "best_result")

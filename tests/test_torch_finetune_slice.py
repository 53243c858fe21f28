"""The finetune configs through both packages at tiny widths, from an on-disk
SceneVerse tree (``sceneverse_tpu.data.fixture``):
``scanrefer_finetune.yaml`` (``GroundHeadV1``, ``og3d_loss``,
``ScanReferEval``), ``nr3d_finetune.yaml`` (the same head on Nr3D,
``ReferIt3DEval``) and ``sqa3d_finetune.yaml`` (``QAHeadV1``,
``answer_loss``, ``SQA3DEval``). ``scanqa_finetune.yaml`` trains its
ScanQA BCE branch, which the JAX package cannot run (``ROADMAP.md`` §C): it
is held to the reference formula and run on the CPU in
``test_torch_finetune_parts.py``.

Per config, with the JAX weights carried across (``ckpt/convert.py``: no
name missing, none left over), dropout off (eval mode) on both sides, the
JAX side under ``SCENEVERSE_PALLAS_INTERPRET=1`` and both sides with
``SCENEVERSE_FUSED_MHA=off`` (the attention of the JAX package's exact
mode: the interpret-mode MHA kernel's trace cost 15 s a config;
``test_torch_slice.py`` holds the fused route over the whole model):
  * the first train batch of both packages' loaders is bit-equal (the
    global seeds set before each loader's first batch, as
    ``test_torch_data_slice.py``);
  * the frozen PointNet++ within the SA kernels' 1e-2 * max|jax|; from the
    same object features on (``test_torch_data_slice.py`` says why apart):
    the head outputs (``og3d_logits`` with its -inf pads,
    ``txt_cls_logits``, ``obj_cls_{pre,post}_logits``, ``answer_scores``)
    within 1e-4 * max(1, max|jax|) and the losses within
    1e-4 * max(1, |jax|);
  * gradients and parameters after 2 AdamW steps, at
    ``test_torch_slice.py``'s tolerances (its docstring has them);
  * the evaluator's metrics on the step's outputs equal to JAX's.

The tree: 1 scan, 8 objects (5 foreground: the crop to max_obj_len - 1 = 4
runs), 80 points each (subsampled to 64).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from test_torch_slice import REPO, TINY, _flat

FINETUNE = os.path.join(REPO, "configs", "final", "finetune")
DATA = ["data.args.max_obj_len=5", "data.args.max_seq_len=16",
        "data.args.pc_type=gt", "num_gpu=1", "dataloader.num_workers=0",
        "dataloader.batchsize=2", "solver.sched.args.warmup_steps=0",
        "solver.optim.args.eps=1e-6",
        "model.heads.ground_head.args.input_size=64",
        "model.heads.ground_head.args.hidden_size=32",
        "model.heads.qa_head.args.hidden_size=64",
        "model.heads.qa_head.args.mlp_size=16",
        "model.heads.qa_head.args.flat_out_size=24",
        "model.heads.qa_head.args.num_answers=6"]
# the outputs each head writes
HEAD_OUT = {
    "ground_head": ("og3d_logits", "txt_cls_logits", "obj_cls_post_logits",
                    "obj_cls_pre_logits"),
    "qa_head": ("answer_scores",),
}
CONFIGS = ("scanrefer_finetune", "nr3d_finetune", "sqa3d_finetune")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from sceneverse_tpu.data.fixture import write_synthetic_tree

    return write_synthetic_tree(tmp_path_factory.mktemp("sv"), n_scans=1,
                                n_objects=8, pts_per_obj=80)


def _first_batch(build, cfg):
    np.random.seed(11)
    random.seed(12)
    return next(iter(build(cfg, "train")))


# what the model and its losses read: both grounding configs hand the
# compiled JAX step one batch structure, so nr3d reuses scanrefer's trace
MODEL_KEYS = ("txt_ids", "txt_masks", "obj_fts", "obj_locs", "obj_masks",
              "obj_sem_masks", "obj_labels", "tgt_object_id",
              "tgt_object_label", "answer_label")


def _loss_fn(m, loss_mod, batch):
    out = m(batch)
    total, losses = loss_mod(out)
    return total, (out, losses)


# module-level transforms: their compile caches serve every config of the
# same model (the JAX model of a head config is built once, _jax_model)
_step = nnx.jit(nnx.value_and_grad(_loss_fn, has_aux=True))
_pnet = nnx.jit(lambda p, x: p(x.reshape(-1, *x.shape[2:])))
_MODELS = {}


class _Features(nnx.Module):
    """Stands in for the frozen JAX PointNet++ with the features it gave:
    the step then traces no interpret-mode SA kernel, and both sides start
    from the same object features."""

    def __init__(self, feats):
        self.feats = nnx.Variable(jnp.asarray(feats))

    def __call__(self, x):
        return self.feats[...]


def _jax_model(cfg):
    """A fresh copy of the JAX model of ``cfg``'s heads (``Rngs(0)``)."""
    from sceneverse_tpu.model import build_model as jbuild

    heads = cfg.model.heads
    key = repr([(h, heads[h].to_dict()) for h in heads.head_list])
    if key not in _MODELS:
        _MODELS[key] = nnx.split(
            nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))())
    return nnx.merge(*_MODELS[key])


@pytest.fixture(scope="module", params=CONFIGS)
def run(request, tree):
    """Both packages on one config: first batches, point features, step-1
    outputs, losses, gradients and metrics, parameters after 2 steps."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data import build_dataloader as jloader
    from sceneverse_tpu.data.datasets import scannet_qa as jqa
    from sceneverse_tpu.evaluator import build_eval as jeval
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.data import build_dataloader as tloader
    from sceneverse_tpu_torch.data.datasets import scannet_qa as tqa
    from sceneverse_tpu_torch.evaluator import build_eval as teval
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    path = os.path.join(FINETUNE, f"{request.param}.yaml")
    over = TINY + DATA + [f"data.scan_family_base={tree}"]
    jqa.SCAN_DATA.clear()  # QA scans are cached by id across trees
    tqa.SCAN_DATA.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        jcfg, tcfg = jload(path, over), tload(path, over)
        jb, tb = _first_batch(jloader, jcfg), _first_batch(tloader, tcfg)
        jm = _jax_model(jcfg)
        jm.eval()
        tm = tbuild(tcfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        loss_mod, tx, _, _ = build_optim(jcfg, jm, total_steps=10)
        arrays = {k: jnp.asarray(v) for k, v in jb.items()
                  if isinstance(v, np.ndarray)}
        inputs = {k: arrays[k] for k in MODEL_KEYS if k in arrays}

        @jax.jit
        def adamw(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        jfeats = np.array(_pnet(jm.point_encoder.point_feature_extractor,
                                arrays["obj_fts"]))
        jm.point_encoder.point_feature_extractor = _Features(jfeats)
        params = nnx.state(jm, nnx.Param)
        opt_state = jax.jit(tx.init)(params)
        tbatch = {k: torch.from_numpy(v) for k, v in tb.items()
                  if isinstance(v, np.ndarray)}
        pnet = tm.point_encoder.point_feature_extractor
        with torch.no_grad():
            tfeats = pnet(tbatch["obj_fts"].reshape(
                -1, *tbatch["obj_fts"].shape[2:])).numpy()
        # the same object features on both sides from here on
        pnet.forward = lambda x: torch.from_numpy(jfeats)
        tloss = Loss(tcfg)
        topt = GPSOptimizer(tcfg, tm, total_steps=10)
        lrs = {id(p): g["base_lr"] for g in topt.opt.param_groups
               for p in g["params"]}
        res = {"batches": (jb, tb), "missing": missing,
               "unexpected": unexpected, "feats": (jfeats, tfeats),
               "head": tcfg.model.heads.head_list[0],
               "lr": {n: lrs.get(id(p)) for n, p in tm.named_parameters()}}
        for i in range(2):
            (_, (jout, jlosses)), grads = _step(jm, loss_mod, inputs)
            g = nnx.state(grads, nnx.Param)
            params, opt_state = adamw(g, opt_state, params)
            nnx.update(jm, params)
            topt.zero_grad()
            tout = tm(tbatch)
            ttotal, tlosses = tloss(tout)
            ttotal.backward()
            if i == 0:
                keys = HEAD_OUT[res["head"]]
                res["out"] = {k: (np.asarray(jout[k]),
                                  tout[k].detach().numpy()) for k in keys}
                res["loss"] = {k: (float(jlosses[k]),
                                   float(tlosses[k].detach()))
                               for k in jlosses}
                jg = from_jax_params(_flat(g))
                res["grad"] = {n: (jg[n].numpy(), p.grad.numpy().copy())
                               for n, p in tm.named_parameters()
                               if p.grad is not None}
                # the evaluator on the step's outputs and the batch
                jev, tev = jeval(jcfg), teval(tcfg)
                jev = jev["val"] if isinstance(jev, dict) else jev
                tev = tev["val"] if isinstance(tev, dict) else tev
                res["metrics"] = (
                    {k: float(v) for k, v in jev.batch_metrics(
                        {**arrays, **{k: jout[k] for k in keys}}).items()},
                    {k: float(v) for k, v in tev.batch_metrics(
                        {**tbatch, **{k: tout[k].detach()
                                      for k in keys}}).items()})
            topt.step()
        jp = from_jax_params(_flat(nnx.state(jm, nnx.Param)))
        tp = dict(tm.named_parameters())
        res["param"] = {n: (jp[n].numpy(), tp[n].detach().numpy().copy())
                        for n in jp}
    return res


def test_first_train_batch_is_bit_equal(run):
    jb, tb = run["batches"]
    assert list(tb) == list(jb)
    for k, v in jb.items():
        if isinstance(v, np.ndarray):
            assert tb[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tb[k], v, err_msg=k)
        else:
            assert tb[k] == v, k
    assert jb["obj_fts"].shape == (2, 5, 64, 6)


def test_weights_carry_over_completely(run):
    assert run["missing"] == [] and run["unexpected"] == []
    assert any(n.startswith(run["head"]) for n in run["param"])


def test_point_features_match_jax_within_the_sa_tolerance(run):
    j, t = run["feats"]
    assert t.shape == j.shape == (10, 64)
    assert np.abs(t - j).max() <= 1e-2 * np.abs(j).max()


def test_head_outputs_match_jax(run):
    for k, (j, t) in run["out"].items():
        assert t.shape == j.shape, k
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j), err_msg=k)
        fin = np.isfinite(j)
        err = np.abs(t[fin].astype(np.float64) - j[fin]).max()
        assert err <= 1e-4 * max(1.0, np.abs(j[fin]).max()), (k, err)
    if run["head"] == "ground_head":
        jb, _ = run["batches"]
        og = run["out"]["og3d_logits"][1]
        assert (~jb["obj_masks"]).any()
        assert np.isneginf(og[~jb["obj_masks"]]).all()
        assert np.isfinite(og[jb["obj_masks"]]).all()


def test_losses_match_jax(run):
    assert run["loss"]
    for k, (j, t) in run["loss"].items():
        assert np.isfinite(t) and j > 0, k
        assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t)


def test_grads_and_params_after_two_adamw_steps(run):
    gmax = max(np.abs(j).max() for j, _ in run["grad"].values())
    assert gmax > 0
    for n, (j, t) in run["grad"].items():
        err = np.abs(t - j).max()
        assert err <= 1e-3 * np.abs(j).max() + 1e-6 * gmax, (n, err)
    moved = 0
    for n, (j, t) in run["param"].items():
        lr = run["lr"].get(n)
        if lr is None:  # frozen backbone: untouched on both sides
            continue
        err = np.abs(t - j)
        floor = 1e-4 * np.abs(j).max()
        assert (err > floor + 1e-2 * 2 * lr).sum() <= max(1, 1e-3 * err.size), n
        assert err.max() <= floor + 0.25 * 2 * lr, (n, err.max())
        moved += 1
    assert moved > 50


def test_evaluator_metrics_on_the_step_match_jax(run):
    want, got = run["metrics"]
    assert sorted(got) == sorted(want)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    if run["head"] == "ground_head":
        assert "txt_acc" in got

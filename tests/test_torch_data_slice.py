"""``configs/final/all_pretrain.yaml`` through the port's data pipeline on an
on-disk SceneVerse tree (``sceneverse_tpu.data.fixture``), at the tiny
widths of ``test_torch_slice.py``, against the JAX package:

  * the first train batch of both packages' loaders is bit-equal (the same
    global seeds before each loader's first batch);
  * with the JAX weights carried across (``ckpt/convert.py``) and the JAX
    side under ``SCENEVERSE_PALLAS_INTERPRET=1``, one train step's forward
    on that batch: the losses agree within 1e-4 * max(1, |jax|), and the
    forward outputs within 1e-4 * max(1, max|jax|) (``test_torch_slice.py``
    states why) once both models start from the same object features; the
    frozen PointNet++ is held on its own, within the SA kernels' 1e-2 *
    max|jax| (``test_torch_sa_forward.py``). Why apart: on the pipeline's
    unit-sphere objects the two sides' SA1 outputs differ by one f32 step
    (2.4e-7: the same bf16 products summed in another order), and where
    such a value sits on a bf16 rounding boundary, SA2's bf16 input lands
    one bf16 step apart (measured: 3 of 20 objects, 1.1e-3 and 4.6e-3 at
    SA2's pooled output); that moves those objects' og3d logits by 1.6e-3
    of 11.7. Standard-normal synthetic objects hold fewer points per ball
    and did not show it;
  * ``eval.save`` writes the string item ids of the real wrappers, as the
    JAX evaluator does (the port's eval loop used to drop the host batch's
    lists and wrote no row);
  * on oracle logits, the port's eval loop and JAX's ``ScanReferEval``
    both score every accuracy 1 over the real wrappers' val batches;
  * ``run_torch.py --config-name all_pretrain device=cpu`` runs two train
    steps and the val / test passes in a subprocess that imports no JAX.

The tree: 1 scan, 8 objects (5 foreground: the crop to max_obj_len - 1 = 4
runs), 80 points each (subsampled to 64), 195 train items over the five
families' sources.
"""

import json
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from test_torch_slice import OUT_KEYS, REPO, TINY, _RUN, _flat

ALL_PRETRAIN = os.path.join(REPO, "configs", "final", "all_pretrain.yaml")
ROOT_KEYS = ("scan_family_base", "rscan_base", "arkitscene_base",
             "multiscan_base", "hm_base")
DATA = ["data.args.max_obj_len=5", "data.args.max_seq_len=16",
        "data.args.max_scene_cap_len=16", "model.lm_max_predictions=4",
        "data.args.pc_type=gt", "num_gpu=1", "dataloader.num_workers=0",
        "dataloader.batchsize=4"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from sceneverse_tpu.data.fixture import write_synthetic_tree

    return write_synthetic_tree(tmp_path_factory.mktemp("sv"), n_scans=1,
                                n_objects=8, pts_per_obj=80)


def _over(tree, *extra):
    return (TINY + DATA + [f"data.{k}={tree}" for k in ROOT_KEYS]
            + list(extra))


def _first_batch(build, cfg):
    np.random.seed(11)
    random.seed(12)
    return next(iter(build(cfg, "train")))


@pytest.fixture(scope="module")
def slice_run(tree):
    """The first train batch of both loaders, and both models' outputs and
    losses on it."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data import build_dataloader as jloader
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.data import build_dataloader as tloader
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    over = _over(tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        jcfg, tcfg = jload(ALL_PRETRAIN, over), tload(ALL_PRETRAIN, over)
        jb, tb = _first_batch(jloader, jcfg), _first_batch(tloader, tcfg)
        jm = nnx.jit(lambda: jbuild(jcfg, rngs=nnx.Rngs(0)))()
        jm.eval()
        tm = tbuild(tcfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        loss_mod = build_optim(jcfg, jm, total_steps=10)[0]
        arrays = {k: v for k, v in jb.items() if isinstance(v, np.ndarray)}

        @nnx.jit
        def jstep(m, b):
            out = m(b)
            flat = b["obj_fts"].reshape(-1, *b["obj_fts"].shape[2:])
            feats = m.point_encoder.point_feature_extractor(flat)
            return out, loss_mod(out)[1], feats

        jout, jlosses, jfeats = jstep(jm, {k: jnp.asarray(v)
                                           for k, v in arrays.items()})
        tbatch = {k: torch.from_numpy(v) for k, v in tb.items()
                  if isinstance(v, np.ndarray)}
        pnet = tm.point_encoder.point_feature_extractor
        loss = Loss(tcfg)
        with torch.no_grad():
            tfeats = pnet(tbatch["obj_fts"].reshape(-1, 64, 6))
            tlosses = loss(tm(tbatch))[1]
            # the same object features on both sides from here on
            pnet.forward = lambda x: torch.from_numpy(np.array(jfeats))
            tout = tm(tbatch)
            tlosses_same = loss(tout)[1]
    return {
        "batches": (jb, tb), "missing": missing, "unexpected": unexpected,
        "feats": (np.asarray(jfeats), tfeats.numpy()),
        "out": {k: (np.asarray(jout[k]), tout[k].numpy()) for k in OUT_KEYS},
        "loss": {k: (float(jlosses[k]), float(tlosses[k]),
                     float(tlosses_same[k])) for k in jlosses},
        "n_masked": int((arrays["masked_lm_labels"] != -1).sum()),
    }


def test_first_train_batch_is_bit_equal(slice_run):
    jb, tb = slice_run["batches"]
    assert list(tb) == list(jb)
    for k, v in jb.items():
        if isinstance(v, np.ndarray):
            assert tb[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tb[k], v, err_msg=k)
        else:
            assert tb[k] == v, k
    assert jb["obj_fts"].shape == (4, 5, 64, 6)
    assert (jb["obj_fts"][~jb["obj_masks"]] == 1.0).all()  # pad objects


def test_losses_match_jax(slice_run):
    assert slice_run["missing"] == [] and slice_run["unexpected"] == []
    assert slice_run["n_masked"] > 0  # the masked-LM loss is live
    for k, (j, t, t_same) in slice_run["loss"].items():
        assert np.isfinite(t) and j > 0, k
        assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t)
        assert abs(t_same - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t_same)


def test_point_features_match_jax_within_the_sa_tolerance(slice_run):
    j, t = slice_run["feats"]
    assert t.shape == j.shape == (20, 64)
    assert np.abs(t - j).max() <= 1e-2 * np.abs(j).max()


def test_forward_outputs_match_jax(slice_run):
    for k, (j, t) in slice_run["out"].items():
        assert t.shape == j.shape, k
        err = np.abs(t.astype(np.float64) - j).max()
        assert err <= 1e-4 * max(1.0, np.abs(j).max()), (k, err)


def test_eval_save_writes_string_item_ids_as_jax(tree, tmp_path):
    """The port's eval loop against JAX's ``ScanReferEval`` on the same
    val batches, with the same stand-in for the model's og3d logits (the
    objects' x): the rows of ``results.json`` (item id, predicted box,
    correct) are equal."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data import build_dataloader as jloader
    from sceneverse_tpu.evaluator.scanrefer_eval import ScanReferEval as JEval
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_trainer

    over = _over(tree, "eval.save=True")
    trainer = build_trainer(tload(ALL_PRETRAIN, over + [
        f"exp_dir={tmp_path / 'torch'}"]), device="cpu")
    trainer.forward = lambda b: {"og3d_logits": b["obj_locs"][..., 0]}
    trainer.log = lambda *a, **k: None
    # data_aug's subsampling draws from the global RNG on every split
    np.random.seed(5)
    _, got_metrics = trainer._eval_loop("val", "val")
    jcfg = jload(ALL_PRETRAIN, over + [f"exp_dir={tmp_path / 'jax'}"])
    jev = JEval(jcfg)
    np.random.seed(5)
    for b in jloader(jcfg, "val"):
        jev.update({**b, "og3d_logits": jnp.asarray(b["obj_locs"][..., 0])})
    _, want_metrics = jev.record()
    name = "eval_results/ScanReferEval/results.json"
    want = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads((tmp_path / "torch" / name).read_text())
    assert len(want) == len(trainer.data_loaders["val"].dataset) > 0
    assert all(isinstance(r["scene_id"], str) for r in want)
    assert got == want
    assert got_metrics["og_acc"] == pytest.approx(
        float(want_metrics["og_acc"]))


def test_eval_loop_scores_oracle_logits_one_as_jax(tree, tmp_path):
    """The port's eval loop and JAX's ``ScanReferEval`` on the same val
    batches with oracle logits (the target's og3d logit 1, each object's
    class logit at its label 1): every accuracy is 1 on both sides (the
    unique / multiple ones 0 where the split holds no such item), so the
    evaluator reads the wrappers' target ids, IoU lists and labels as they
    are. With the model's og3d logits an all-zero score cannot tell a
    wrong read from an untrained model."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data import build_dataloader as jloader
    from sceneverse_tpu.evaluator.scanrefer_eval import ScanReferEval as JEval
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_trainer

    n_cls = 607

    def oracle(b, xp):
        tgt = np.asarray(b["tgt_object_id"])[:, 0]
        og = np.zeros(np.asarray(b["obj_masks"]).shape, np.float32)
        og[np.arange(len(tgt)), tgt] = 1.0
        labels = np.clip(np.asarray(b["obj_labels"]), 0, None)
        cls = np.eye(n_cls, dtype=np.float32)[labels]
        return {k: xp(v) for k, v in (("og3d_logits", og),
                                      ("obj_cls_raw_logits", cls),
                                      ("obj_cls_post_logits", cls))}

    over = _over(tree)
    trainer = build_trainer(tload(ALL_PRETRAIN, over + [
        f"exp_dir={tmp_path / 'torch'}"]), device="cpu")
    trainer.forward = lambda b: oracle(b, torch.as_tensor)
    trainer.log = lambda *a, **k: None
    np.random.seed(5)
    _, got = trainer._eval_loop("val", "val")
    jev = JEval(jload(ALL_PRETRAIN, over + [f"exp_dir={tmp_path / 'jax'}"]))
    np.random.seed(5)
    n = n_mult = 0
    for b in jloader(jev.cfg, "val"):
        jev.update({**b, **oracle(b, jnp.asarray)})
        n += len(b["is_multiple"])
        n_mult += int(np.asarray(b["is_multiple"]).sum())
    _, want = jev.record()
    assert n > 0
    expect = {k: 1.0 for k in ("og_acc", "og_acc_iou25", "og_acc_iou50",
                               "obj_cls_raw_acc", "obj_cls_post_acc")}
    for kind, count in (("unique", n - n_mult), ("multiple", n_mult)):
        for iou in ("25", "50"):
            expect[f"og_acc_iou{iou}_{kind}"] = 1.0 if count else 0.0
    assert {k: float(got[k]) for k in expect} == expect
    assert {k: float(want[k]) for k in expect} == expect


def test_run_torch_all_pretrain_cpu_two_steps_without_jax(tree, tmp_path):
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.data import get_dataset

    n_items = len(get_dataset(load_config(ALL_PRETRAIN, _over(tree)),
                              "train"))
    assert n_items == 195
    args = ["--config-path", os.path.join(REPO, "configs", "final"),
            "--config-name", "all_pretrain",
            *_over(tree, f"dataloader.batchsize={n_items // 2}"),
            "solver.epochs=1", "device=cpu", f"base_dir={tmp_path}"]
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
    assert res["test"] and all(0.0 <= v <= 1.0 for k, v in res["test"].items()
                               if k != "best_result")

"""Checkpoint save and resume of the port's trainer (``trainer/build.py``,
``ckpt/checkpoint.py``) against the JAX package's.

  1. Both trainers on the tiny ``synthetic_pretrain`` of
     ``test_torch_slice.py`` (hidden 64, 2 layers per tower, 5 x 64 points,
     batch 2, 2 steps an epoch), JAX weights carried over, dropout off: epoch
     1, a checkpoint, then a fresh trainer with ``resume=True`` runs epoch 2.
     Its logged rows (steps, losses, metrics, LR per group) and its final
     parameters agree with JAX's. The JAX side runs its Pallas kernels in
     interpret mode, as in ``test_torch_slice.py``. Tolerances: LRs 1e-6
     relative; losses and metrics 1e-3 * max(1, |jax|): epoch 2's rows read
     the parameters after 2 and 3 AdamW steps, and Adam moves an element
     whose gradient sits near eps by a visibly different fraction of its
     step on the two sides (``test_torch_slice.py``: up to 0.085 of the
     2-step span), which the losses see (measured: at most 2.7e-4 here,
     where one forward agrees to 1e-4); parameters after 4 AdamW steps, per
     tensor: at least 99% of the elements within 1e-4 * max|p| + 1e-2 *
     (4 * lr) and none off by more than 1e-4 * max|p| + 0.25 * (4 * lr)
     (measured: at most 0.49% of a tensor's elements past the first bound,
     where ``test_torch_slice.py`` saw 0.07% after 2 steps, and at most 0.136
     of the 4-step span). A resume that lost the AdamW moments or the step
     would move every element by a whole step.
  2. The port's versions of ``tests/test_trainer_e2e.py:81-165``: resume
     from ``latest.pth``, from a bare ``ckpt/`` holding only ``best.pth``
     and ``ckpt_1.pth``, from ``ckpt_path`` set to one file, and from
     scratch; no random state in a checkpoint; an overwrite while a save is
     in flight.
  3. A ``best.pth`` of the new save loads through ``load_torch_pretrain``.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_slice import CFG, PARITY, TINY, _flat

OVER = PARITY + ["data.synthetic_size=4", "solver.epochs=2",
                 "solver.epochs_per_eval=null", "solver.epochs_per_save=1"]


def _rows(trainer):
    rows = []
    trainer.logger.log = lambda row, step=None: rows.append((step, dict(row)))
    return rows


def _jax_no_dropout(model):
    from flax import nnx

    for _, m in nnx.iter_modules(model):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0


def _torch_no_dropout(model):
    from sceneverse_tpu_torch.modules.utils import Dropout

    for m in model.modules():
        if isinstance(m, (Dropout, torch.nn.Dropout)):
            m.p = 0.0


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Epoch 2's rows and final parameters of both resumed trainers."""
    from sceneverse_tpu.ckpt.checkpoint import wait_for_checkpoints
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.trainer import build_trainer as jbuild
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params, load_jax_params
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_trainer as tbuild
    from flax import nnx

    base = tmp_path_factory.mktemp("resume")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        jover = OVER + [f"exp_dir={base / 'jax'}"]
        tover = OVER + [f"exp_dir={base / 'torch'}"]
        ja = jbuild(jload(CFG, jover))
        _jax_no_dropout(ja.model)
        ta = tbuild(tload(CFG, tover), device="cpu")
        missing, unexpected = load_jax_params(
            ta.model, _flat(nnx.state(ja.model, nnx.Not(nnx.RngState))))
        assert missing == [] and unexpected == []
        _torch_no_dropout(ta.model)
        # epoch 1, then the checkpoint OpenVocabTrainer writes at
        # epochs_per_save=1
        for t in (ja, ta):
            t.exp_tracker.step()
            t.train_step(0)
            t.save("ckpt_1.pth")
        wait_for_checkpoints()

        jb = jbuild(jload(CFG, jover + ["resume=True"]))
        _jax_no_dropout(jb.model)
        tb = tbuild(tload(CFG, tover + ["resume=True"]), device="cpu")
        _torch_no_dropout(tb.model)
        out = {"resumed_from": tb.resumed_from, "ckpt": ta.ckpt_path}
        for name, t in (("jax", jb), ("torch", tb)):
            assert t.exp_tracker.epoch == 1 and t.global_step == 2, name
            rows = _rows(t)
            t.exp_tracker.step()
            t.train_step(1)
            out[name] = rows
        jb._materialize()
        jp = from_jax_params(_flat(nnx.state(jb.model, nnx.Param)))
        tp = dict(tb.model.named_parameters())
        out["param"] = {n: (jp[n].numpy(), tp[n].detach().numpy())
                        for n in jp}
        lrs = {id(p): g["base_lr"] for g in tb.optimizer.opt.param_groups
               for p in g["params"]}
        out["lr"] = {n: lrs.get(id(p)) for n, p in tb.model.named_parameters()}
    return out


def test_resume_picks_the_epoch_checkpoint(resumed):
    assert resumed["resumed_from"] == resumed["ckpt"] / "ckpt_1.pth"


def test_resumed_epoch_rows_match_jax(resumed):
    jrows, trows = resumed["jax"], resumed["torch"]
    assert [s for s, _ in trows] == [s for s, _ in jrows] == [3, 4]
    for (_, j), (_, t) in zip(jrows, trows):
        assert set(t) == set(j)
        for k, want in j.items():
            got = t[k]
            assert np.isfinite(got), k
            if "/lr/" in k:
                assert got == pytest.approx(want, rel=1e-6, abs=0.0), k
            else:
                assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (
                    k, got, want)


def test_resumed_parameters_match_jax(resumed):
    moved = 0
    for n, (j, t) in resumed["param"].items():
        lr = resumed["lr"].get(n)
        if lr is None:  # frozen backbone: untouched on both sides
            continue
        err = np.abs(t - j)
        floor = 1e-4 * np.abs(j).max()
        assert (err > floor + 1e-2 * 4 * lr).sum() <= max(1, 1e-2 * err.size), n
        assert err.max() <= floor + 0.25 * 4 * lr, (n, err.max())
        moved += 1
    assert moved > 50


# ------------------------------------------------ the port's own resume paths
def _trainer(tmp_path, *over):
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.trainer.build import build_trainer

    cfg = load_config(CFG, TINY + ["solver.epochs=1",
                                   f"exp_dir={tmp_path / 'exp'}", *over])
    return build_trainer(cfg, device="cpu")


def _same_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    return all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the tiny port trainer."""
    tmp = tmp_path_factory.mktemp("trained")
    t = _trainer(tmp)
    t.run()
    return tmp, t


@pytest.mark.parametrize("layout", ["latest", "bare_dir", "one_file",
                                    "scratch"])
def test_resume_sources(trained, tmp_path, layout):
    from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints

    _, a = trained
    a.ckpt_path = tmp_path / "exp" / "ckpt"
    over = []
    if layout == "latest":
        a.save("latest.pth")
        want = a.ckpt_path / "latest.pth"
    elif layout == "bare_dir":  # OpenVocabTrainer's: best + every-N only
        a.save("best.pth")
        a.save("ckpt_1.pth")
        wait_for_checkpoints()
        old = os.path.getmtime(a.ckpt_path / "ckpt_1.pth") - 10
        os.utime(a.ckpt_path / "best.pth", (old, old))
        want = a.ckpt_path / "ckpt_1.pth"
    elif layout == "one_file":
        a.save("ckpt_7.pth")
        want = a.ckpt_path / "ckpt_7.pth"
        over = [f"ckpt_path={want}"]
    else:
        want = None
    wait_for_checkpoints()
    b = _trainer(tmp_path, "resume=True", *over)
    assert b.resumed_from == want
    if want is None:
        assert b.exp_tracker.epoch == 0 and b.global_step == 0
        assert not _same_params(a, b)
        return
    assert b.exp_tracker.state_dict() == a.exp_tracker.state_dict()
    assert b.exp_tracker.epoch == 1 and b.global_step == a.global_step == 2
    assert _same_params(a, b)
    sa, sb = a.optimizer.opt.state_dict(), b.optimizer.opt.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert b.optimizer.step_count == a.optimizer.step_count == 2


def _leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), obj


def test_checkpoint_holds_no_random_state(trained, tmp_path):
    from sceneverse_tpu_torch.ckpt.checkpoint import load_checkpoint

    _, a = trained
    a.ckpt_path = tmp_path
    a.save("latest.pth")
    state = load_checkpoint(tmp_path / "latest.pth")  # weights_only=True
    assert set(state) == {"model", "optimizer", "tracker", "global_step"}
    for path, leaf in _leaves(state):
        low = path.lower()
        assert not any(w in low for w in ("rng", "generator", "seed")), path
        assert torch.is_tensor(leaf) or type(leaf) in (
            int, float, str, bool, type(None)), (path, type(leaf))
    assert state["tracker"]["best_result"] == -float("inf")


def test_overwrite_while_a_save_is_in_flight(trained, tmp_path):
    from sceneverse_tpu_torch.ckpt.checkpoint import (is_checkpoint,
                                                      load_checkpoint,
                                                      save_checkpoint,
                                                      wait_for_checkpoints)

    _, a = trained
    a.ckpt_path = tmp_path
    state1 = a._ckpt_state()
    state2 = dict(a._ckpt_state(), global_step=a.global_step + 100)
    path = tmp_path / "latest.pth"
    save_checkpoint(path, state1)
    save_checkpoint(path, state2)  # overwrite with save 1 possibly in flight
    save_checkpoint(tmp_path / "ckpt_1.pth", state2)
    wait_for_checkpoints()
    assert is_checkpoint(path) and is_checkpoint(tmp_path / "ckpt_1.pth")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.pth", "latest.pth"]
    assert load_checkpoint(path)["global_step"] == state2["global_step"]


def test_best_pth_loads_through_load_torch_pretrain(trained, tmp_path):
    from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints
    from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain
    from sceneverse_tpu_torch.model import build_model

    tmp, a = trained
    a.ckpt_path = tmp_path
    a.save("best.pth")
    wait_for_checkpoints()
    fresh = build_model(a.cfg, generator=torch.Generator().manual_seed(5))
    n = load_torch_pretrain(fresh, tmp_path / "best.pth")
    assert n == len(a.model.state_dict())
    sa, sb = a.model.state_dict(), fresh.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)

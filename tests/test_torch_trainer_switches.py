"""The port's trainer switches, each as the JAX package reads it, on the
tiny ``synthetic_pretrain`` of ``test_torch_slice.py`` on the CPU:

  * ``solver.log_every``: a buffer of device scalars fetched in one copy per
    ``log_every`` steps writes the same rows as a fetch every step;
  * ``debug.hard_debug`` writes nothing;
  * ``eval.save``: ``ScanReferEval``'s ``results.json`` equals the JAX
    evaluator's for the same items;
  * ``profile.enabled`` / ``profile.steps`` write a trace and end epoch 0
    after that many steps;
  * ``debug.nans`` lets a clean step through and raises on an injected NaN;
  * ``DebugTrainer`` iterates every loader without the model;
  * ``DefaultTrainer`` saves ``latest.pth`` every epoch and resumes from it;
  * every loader draws from a generator of its own, as JAX's do, and the
    train order over two epochs is JAX's.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_slice import CFG, TINY


def _trainer(tmp_path, *over, name="exp"):
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.trainer.build import build_trainer

    cfg = load_config(CFG, TINY + [f"exp_dir={tmp_path / name}", *over])
    return build_trainer(cfg, device="cpu")


def _capture(trainer):
    rows, flushes = [], []
    trainer.logger.log = lambda row, step=None: rows.append((step, dict(row)))
    flush = trainer.flush_train_logs
    # the copies made: a flush of an empty buffer copies nothing
    trainer.flush_train_logs = lambda p: (p and flushes.append(len(p))
                                          or flush(p))
    return rows, flushes


def test_log_every_writes_the_same_rows(tmp_path):
    runs = {}
    for every in (1, 4):
        t = _trainer(tmp_path, "data.synthetic_size=10",
                     f"solver.log_every={every}", name=f"e{every}")
        rows, flushes = _capture(t)
        t.train_step(0)
        runs[every] = (rows, flushes, t.history["train"])
    rows1, flushes1, hist1 = runs[1]
    rows4, flushes4, hist4 = runs[4]
    assert [s for s, _ in rows1] == [1, 2, 3, 4, 5]
    assert rows4 == rows1
    assert flushes1 == [1] * 5 and flushes4 == [4, 1]
    strip = lambda h: [{k: v for k, v in r.items() if k != "step_s"}
                       for r in h]
    assert strip(hist4) == strip(hist1)
    assert all(r["step_s"] > 0 for r in hist4)


def test_hard_debug_writes_nothing(tmp_path):
    t = _trainer(tmp_path, "debug.hard_debug=True", "solver.epochs=1")
    called = []
    t.logger.log = lambda *a, **k: called.append(a)
    t.run()
    assert called == []
    assert not (tmp_path / "exp" / "metrics.jsonl").exists()
    assert len(t.history["train"]) == 2


def test_eval_save_results_match_jax(tmp_path):
    import jax.numpy as jnp

    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.evaluator.scanrefer_eval import ScanReferEval as JEval
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.evaluator.scanrefer_eval import ScanReferEval

    over = TINY + ["eval.save=True"]
    jev = JEval(jload(CFG, over + [f"exp_dir={tmp_path / 'jax'}"]))
    tev = ScanReferEval(tload(CFG, over + [f"exp_dir={tmp_path / 'torch'}"]))
    rng = np.random.default_rng(0)
    B, O = 3, 5
    for b in range(2):
        batch = {
            "og3d_logits": rng.standard_normal((B, O)).astype(np.float32),
            "tgt_object_id": rng.integers(0, O, (B, 1)),
            "tgt_object_id_iou25": rng.integers(0, 2, (B, O)),
            "tgt_object_id_iou50": rng.integers(0, 2, (B, O)),
            "is_multiple": rng.integers(0, 2, B).astype(bool),
            "obj_boxes": rng.standard_normal((B, O, 6)).astype(np.float32),
            "obj_labels": rng.integers(0, 7, (B, O)),
            "obj_masks": np.ones((B, O), bool),
            "data_idx": np.arange(b * B, (b + 1) * B),
        }
        jev.update({k: jnp.asarray(v) for k, v in batch.items()})
        tev.update({k: torch.from_numpy(v) for k, v in batch.items()})
    jbest, jres = jev.record()
    tbest, tres = tev.record()
    name = "eval_results/ScanReferEval/results.json"
    want = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads((tmp_path / "torch" / name).read_text())
    assert len(got) == 2 * B
    assert got == want
    assert tbest == jbest
    assert tres["og_acc"] == pytest.approx(float(jres["og_acc"]))


def test_profile_writes_a_trace(tmp_path):
    t = _trainer(tmp_path, "profile.enabled=True", "profile.steps=1",
                 "data.synthetic_size=8")
    t.train_step(0)
    assert t.global_step == 1  # epoch 0 ends after the traced steps
    traces = list((tmp_path / "exp" / "profile").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    t.train_step(1)  # later epochs are not traced and run in full
    assert t.global_step == 5
    assert len(list((tmp_path / "exp" / "profile").glob("*.json"))) == 1


def test_profile_traces_k_step_chunks(tmp_path):
    """``profile.enabled`` at ``solver.steps_per_dispatch=2``: the traced
    steps run as one chunk of 2 through ``train_forward_backward_k`` and a
    tail step (epoch 0 ends after 3), and one trace holds their ops."""
    t = _trainer(tmp_path, "profile.enabled=True", "profile.steps=3",
                 "solver.steps_per_dispatch=2", "data.synthetic_size=12")
    chunks = []
    real = t.train_forward_backward_k
    t.train_forward_backward_k = lambda d, f: chunks.append(len(d)) or real(
        d, f)
    t.train_step(0)
    assert chunks == [2, 2] and t.global_step == 4  # whole chunks
    traces = list((tmp_path / "exp" / "profile").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum("aten::addmm" in str(e.get("name", "")) for e in events) > 0


@pytest.mark.parametrize("empty", [1, 3])
def test_profile_traces_again_after_an_empty_window(tmp_path, monkeypatch,
                                                    empty):
    """A window whose trace holds fewer of the port's kernels than the port
    launched (``TraceWindow.complete`` false; torch.profiler late in a long
    process) is traced again over the next ``profile.steps`` steps; after
    ``PROFILE_WINDOWS`` such windows in a row the run raises. The card's
    windows stand in here: the first ``empty`` lose one ``fps`` launch of
    5, or all of them."""
    import contextlib

    from sceneverse_tpu_torch.trainer import default_trainer
    from sceneverse_tpu_torch.utils.profiling import (PROFILE_KERNELS,
                                                      TraceWindow)

    opened = []

    @contextlib.contextmanager
    def fake_trace(log_dir, enabled=True):
        w = TraceWindow()
        yield w
        opened.append(w)
        w.launches.update(fps=5, mha_fwd=3)
        w.traced = {k: 0 for k in PROFILE_KERNELS}
        w.traced["sv_mha_fwd_kernel"] = 3
        w.traced["sv_fps_kernel"] = ((4 if len(opened) % 2 else 0)
                                     if len(opened) <= empty else 5)

    monkeypatch.setattr(default_trainer, "trace", fake_trace)
    t = _trainer(tmp_path, "profile.enabled=True", "profile.steps=1",
                 "data.synthetic_size=12")
    if empty < default_trainer.PROFILE_WINDOWS:
        t.train_step(0)
        assert len(opened) == empty + 1 and t.global_step == empty + 1
        assert t.profile_windows == opened and opened[-1].complete
        assert opened[0].missing == {"sv_fps_kernel": (4, 5)}
    else:
        with pytest.raises(RuntimeError, match="traced fewer kernels"):
            t.train_step(0)
        assert len(opened) == default_trainer.PROFILE_WINDOWS
        assert not any(w.complete for w in t.profile_windows)


def test_debug_nans_raises_on_an_injected_nan(tmp_path):
    from sceneverse_tpu_torch.trainer.build import to_device

    try:
        t = _trainer(tmp_path, "debug.nans=True")
        assert torch.is_anomaly_enabled()
        t.train_step(0)  # a clean epoch goes through
        assert len(t.history["train"]) == 2
        batch = to_device(next(iter(t.data_loaders["train"])), "cpu")
        batch["obj_locs"][0, 0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="non-finite"):
            t.train_forward_backward(batch)
    finally:
        torch.autograd.set_detect_anomaly(False)
    plain = _trainer(tmp_path, name="plain")
    assert not any(m._forward_hooks for m in plain.model.modules())


def test_debug_trainer_iterates_every_loader(tmp_path):
    t = _trainer(tmp_path, "trainer=DebugTrainer", "data.synthetic_size=6")

    def boom(*a, **k):
        raise AssertionError("DebugTrainer ran the model")

    t.model.forward = boom
    assert t.run() == {"train[0]": 3, "val[0]": 3, "test[0]": 3}


def test_default_trainer_saves_latest_every_epoch(tmp_path):
    from sceneverse_tpu_torch.ckpt.checkpoint import load_checkpoint

    over = ["trainer=DefaultTrainer", "eval.train=null",
            "eval.name=ScanReferEval", "solver.epochs=2",
            "solver.epochs_per_save=null"]
    t = _trainer(tmp_path, *over)
    saved = []
    save = t.save
    t.save = lambda name: saved.append(name) or save(name)
    t.run()
    assert saved.count("latest.pth") == 2
    state = load_checkpoint(tmp_path / "exp" / "ckpt" / "latest.pth")
    assert state["tracker"]["epoch"] == 2 and state["global_step"] == 4
    assert t.best_metric == t.evaluator.best_result
    b = _trainer(tmp_path, *over, "resume=True")
    assert b.resumed_from == tmp_path / "exp" / "ckpt" / "latest.pth"
    assert b.exp_tracker.epoch == 2


def _order(loaders, key="data_idx"):
    return [int(i) for b in loaders for i in b[key]]


def test_loaders_shuffle_as_jax_across_eval_passes():
    """Train, val, train: both train epochs come in JAX's order, the val
    pass between them drawing from the val loader's own generator."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data import build_dataloader as jloader
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_dataloader

    over = TINY + ["data.synthetic_size=12", "dataloader.batchsize=3"]
    orders = {}
    for name, load, build in (("jax", jload, jloader),
                              ("torch", tload, build_dataloader)):
        cfg = load(CFG, over)
        train, val = build(cfg, "train"), build(cfg, "val")
        orders[name] = [_order(train), _order(val), _order(train)]
    assert orders["torch"] == orders["jax"]
    assert orders["torch"][0] != orders["torch"][2]

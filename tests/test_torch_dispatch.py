"""The JAX trainer's dispatch paths in the port (``trainer/build.py``,
``trainer/default_trainer.py``): K steps per dispatch, fused eval, in-step
train metrics and packed transfer. On the CPU the K-step path runs the same
step function K times and the fused eval the same forward and sums, so both
must equal the single-step loop exactly; on the card they are CUDA graphs
(``chip_smoke.phase_graphs``). The port's versions of
``tests/test_trainer_e2e.py:201-290``, plus:

  * the port's K = 2 run (a chunk of 2 and a tail step) against the JAX
    trainer's K = 2 run on the tiny ``synthetic_pretrain`` of
    ``test_torch_slice.py``, JAX weights carried over, dropout off and
    ``SCENEVERSE_FUSED_MHA=off`` on both sides (the interpret-mode MHA
    trace would cost 15 s a model): the LRs within 1e-6 relative, the
    losses and metrics of the rows within 1e-3 * max(1, |jax|), the rule
    ``test_torch_trainer_resume.py`` holds the trainers' rows to. Its reason
    for rows past the first (Adam moves an element whose gradient sits near
    eps by a visibly different fraction of its step on the two sides) and
    the frozen PointNet++'s bf16 activations, which round differently on
    the two sides now and then: the scene contrastive loss of the first row,
    at the carried weights, is 4.4e-4 off on this batch, past the 1e-4 that
    ``test_torch_slice.py`` holds its first batch to. Then the fused eval
    of ``PretrainEval`` and ``ScanReferEval`` over a val split with a tail
    batch, after those 3 steps, against the eager loop (equal) and JAX's
    ``eval_fused`` (1e-3 * max(1, |jax|));
  * ``_pack_host`` and the device unpack, and the int32 overflow that both
    packages refuse;
  * the device LR schedule against the JAX package's (optax's) schedule,
    and the optimizer's steps taking it;
  * ``model.remat=true`` at K = 2 under "full" and under "dots" against the
    JAX trainer's ``model.remat=true`` K = 2 run (its ``nnx.remat`` inside
    the scan), as the K = 2 rows above: a chunk of 2 and a tail step,
    dropout off, the rows within ROW_TOL and the LRs within 1e-6.
K = 2 over a data-parallel world is ``tests/test_torch_ddp.py``'s (the
gloo ranks' K-step routes) and ``tests/test_torch_mp.py``'s (dp 1 x mp 2).
"""

import numpy as np
import pytest
import torch

from test_torch_slice import CFG, PARITY, TINY, _flat

OVER = PARITY + ["data.synthetic_size=7", "solver.epochs=1",
                 "solver.steps_per_dispatch=2",
                 "solver.eval_steps_per_dispatch=2"]
# losses and metrics against JAX, times max(1, |jax|): the rule of
# test_torch_trainer_resume.py (the module docstring)
ROW_TOL = 1e-3


def _port_trainer(tmp_path, *over):
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.trainer.build import build_trainer

    cfg = load_config(CFG, TINY + [f"exp_dir={tmp_path}", *over])
    return build_trainer(cfg, device="cpu")


def _rows(trainer):
    return [{k: v for k, v in r.items() if k != "step_s"}
            for r in trainer.history["train"]]


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two torch threads for this module's small steps (the suite runs
    several worker processes side by side), as before after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


FIVE = ["data.synthetic_size=10", "solver.epochs=1"]  # 5 train batches


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One epoch of 5 single steps."""
    t = _port_trainer(tmp_path_factory.mktemp("single"), *FIVE)
    t.train_step(0)
    return t


@pytest.mark.parametrize("spd", [2, 3])
def test_steps_per_dispatch_equals_single_steps(single, tmp_path, spd):
    """5 batches: K = 2 is two chunks and a tail step, K = 3 a chunk and a
    tail of 2; parameters, statistics and every log row equal K = 1's."""
    one = single
    k = _port_trainer(tmp_path / "k", *FIVE,
                      f"solver.steps_per_dispatch={spd}")
    calls = []
    real = k.train_forward_backward_k
    k.train_forward_backward_k = lambda d, f: calls.append(len(d)) or real(
        d, f)
    k.train_step(0)
    assert calls == [spd] * (5 // spd)  # the tail took the single path
    assert k.global_step == one.global_step == 5
    a, b = _state(one), _state(k)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert _rows(k) == _rows(one) and len(_rows(k)) == 5


def test_accumulation_across_chunks_equals_micro_steps(tmp_path):
    """K = 3 with gradient_accumulation_steps = 2: the chunks start at
    phases 0 and 1; six micro-steps, three updates, as single steps."""
    over = ["data.synthetic_size=12", "solver.epochs=1",
            "solver.gradient_accumulation_steps=2"]
    one = _port_trainer(tmp_path / "one", *over)
    one.train_step(0)
    k = _port_trainer(tmp_path / "k", *over, "solver.steps_per_dispatch=3")
    phases = []
    real = k.train_forward_backward_k
    k.train_forward_backward_k = lambda d, f: phases.append(
        k.optimizer.mini_step) or real(d, f)
    k.train_step(0)
    assert phases == [0, 1]
    assert k.optimizer.step_count == one.optimizer.step_count == 3
    a, b = _state(one), _state(k)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert _rows(k) == _rows(one)


@pytest.fixture(scope="module")
def seven(tmp_path_factory):
    """A trainer whose val split holds 7 items (batches 2, 2, 2, 1)."""
    return _port_trainer(tmp_path_factory.mktemp("seven"),
                         "data.synthetic_size=7",
                         "solver.eval_steps_per_dispatch=2")


def test_fused_eval_with_a_tail_equals_the_eager_loop(seven):
    """7 val items at batch 2 (2, 2, 2, 1) in groups of 2: the tail batch
    takes its own group; ``record`` equals the eager loop's."""
    t = seven
    ev = t._val_evaluator()
    groups = []
    real = t.eval_metrics_k
    t.eval_metrics_k = lambda d, f: groups.append(
        [len(x["obj_fts"]) for x in d]) or real(d, f)
    _, fused = t._eval_loop("val", "val")
    assert groups == [[2, 2], [2], [1]]
    ev.JIT_METRICS = False
    try:
        _, eager = t._eval_loop("val", "val")
    finally:
        del ev.JIT_METRICS
    assert fused == eager


def test_in_step_metrics_follow_the_evaluator(seven, monkeypatch):
    """The train evaluator's metrics run in the step unless ``eval.save``
    or ``debug.nans`` asks for host work (JAX ``_fusable_metrics``)."""
    from sceneverse_tpu_torch.config import load_config

    t = seven
    ev = t._train_evaluator()
    assert t._fusable_metrics(ev) is t._fusable_metrics(ev) is not None
    val = t._val_evaluator()
    assert t._fusable_metrics(val) is not None
    monkeypatch.setattr(val, "save", True)  # eval.save=True
    assert t._fusable_metrics(val) is None
    monkeypatch.setattr(t, "cfg", load_config(CFG, TINY + ["debug.nans=True"]))
    assert t._fusable_metrics(ev) is None
    from sceneverse_tpu_torch.evaluator import scanqa_eval

    assert scanqa_eval.ScanQAEval.JIT_METRICS
    assert not scanqa_eval.ScanQAGenEval.JIT_METRICS


# ------------------------------------------------------ against JAX's K = 2
def _no_dropout(jm, tm):
    from flax import nnx

    from sceneverse_tpu_torch.modules.utils import Dropout

    for _, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    for m in tm.modules():
        if isinstance(m, (Dropout, torch.nn.Dropout)):
            m.p = 0.0


def _k2_epochs(base, over):
    """Both trainers (JAX weights carried over, dropout off) through their
    K = 2 epoch: (each side's logged rows, whether JAX took its scan path,
    the two trainers)."""
    from flax import nnx

    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.trainer import build_trainer as jbuild
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.trainer.build import build_trainer as tbuild

    jt = jbuild(jload(CFG, OVER + over + [f"exp_dir={base / 'jax'}"]))
    tt = tbuild(tload(CFG, OVER + over + [f"exp_dir={base / 'torch'}"]),
                device="cpu")
    missing, unexpected = load_jax_params(
        tt.model, _flat(nnx.state(jt.model, nnx.Not(nnx.RngState))))
    assert missing == [] and unexpected == []
    _no_dropout(jt.model, tt.model)
    out = {}
    for name, t in (("jax", jt), ("torch", tt)):
        rows = []
        t.logger.log = lambda row, step=None, _r=rows: _r.append(
            (step, dict(row)))
        t.train_step(0)
        out[name] = rows
    out["jax_k"] = jt._compiled_train_k is not None
    return out, jt, tt


def _match_k2_rows(res):
    jrows, trows = res["jax"], res["torch"]
    assert res["jax_k"]  # JAX took its scan path for the chunk
    assert [s for s, _ in trows] == [s for s, _ in jrows] == [1, 2, 3]
    for i, ((_, j), (_, t)) in enumerate(zip(jrows, trows)):
        assert set(t) == set(j)
        for k, want in j.items():
            if "/lr/" in k:
                assert t[k] == pytest.approx(want, rel=1e-6, abs=0.0), k
            else:
                assert abs(t[k] - want) <= ROW_TOL * max(1.0, abs(want)), (
                    i, k, t[k], want)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both trainers' K = 2 epoch (one chunk, one tail step) and the fused
    eval of both evaluators on the val split (2, 2, 2, 1)."""
    base = tmp_path_factory.mktemp("dispatch")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        out, jt, tt = _k2_epochs(base, [])
        for name in ("train", "val"):
            res = {}
            for side, t in (("jax", jt), ("torch", tt)):
                ev = t.evaluator[name]
                t.eval_fused(ev, t.data_loaders["val"],
                             t._fusable_metrics(ev))
                res[side] = ev.record()[1]
                ev.reset()
            ev = tt.evaluator[name]
            for host in tt.data_loaders["val"]:
                batch = tt.device_batch(host)
                ev.update({**host, **batch, **tt.forward(batch)})
            res["eager"] = ev.record()[1]
            ev.reset()
            out[name] = res
    return out


def test_k2_log_rows_match_jax(both):
    _match_k2_rows(both)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_k2_remat_rows_match_jax_remat(tmp_path, policy):
    """``model.remat=true`` under ``policy``: the port's K = 2 epoch, whose
    towers recompute in the backward, against JAX's, whose ``nnx.remat``
    runs inside the scan."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        res, jt, tt = _k2_epochs(tmp_path, [
            "model.remat=true", f"model.remat_policy={policy}"])
    assert tt.model.remat == {"language", "grounding"}
    assert tt.model.remat_policy == policy
    _match_k2_rows(res)


@pytest.mark.parametrize("name", ["train", "val"])  # PretrainEval, ScanRefer
def test_fused_eval_matches_eager_and_jax(both, name):
    res = both[name]
    assert res["torch"] == res["eager"]
    assert set(res["torch"]) == set(res["jax"])
    for k, want in res["jax"].items():
        assert abs(res["torch"][k] - float(want)) <= ROW_TOL * max(
            1.0, abs(float(want))), (k, res["torch"][k], want)


# ------------------------------------------------------------ packing
def test_pack_host_round_trips_and_refuses_int32_overflow():
    from sceneverse_tpu.trainer.build import _pack_host as jpack
    from sceneverse_tpu_torch.trainer.build import _pack_host, _unpack_device

    rng = np.random.RandomState(0)
    arrays = {"f": rng.randn(3, 5).astype(np.float32),
              "i": rng.randint(-2 ** 31, 2 ** 31 - 1, (4,)).astype(np.int64),
              "b": rng.rand(2, 3) > 0.5, "s": np.asarray(7),
              "x": np.asarray(1.5, np.float32),
              "d": rng.randn(3).astype(np.float64),
              "u": rng.randint(0, 255, (5,)).astype(np.uint8)}
    buf, metas = _pack_host(arrays)
    assert buf.dtype == np.int32
    dev = torch.from_numpy(buf)
    got = _unpack_device(dev, metas)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        t = got[k]
        assert t.dtype == torch.from_numpy(np.asarray(a)).dtype, k
        assert tuple(t.shape) == a.shape, k
        np.testing.assert_array_equal(t.numpy(), a)
    for k in ("f", "x", "d"):  # the float leaves are views of the buffer
        assert 0 <= got[k].data_ptr() - dev.data_ptr() < buf.nbytes, k
    big = {"i": np.asarray([2 ** 31], np.int64)}
    for pack in (_pack_host, jpack):
        with pytest.raises(OverflowError, match="int32"):
            pack(big)


# ------------------------------------------------------------ LR schedule
@pytest.mark.parametrize("sched,args", [
    ("warmup_cosine", {"warmup_steps": 3}), ("warmup_cosine", {}),
    ("warmup_exp", {"warmup_steps": 2, "gamma": 0.1})])
def test_device_lr_schedule_matches_jax(sched, args):
    """The device schedule (a float64 step tensor in, tensor ops) against
    the JAX package's (optax's) at every step of a 10-step run and two
    steps past it; ratios, as ``test_torch_trainer_accum.py`` holds the host
    schedule (JAX's is f32)."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.optim.scheduler import get_schedule_fn as jsched
    from sceneverse_tpu_torch.config import load_config as tload
    from sceneverse_tpu_torch.optim.scheduler import get_schedule_fn

    over = [f"solver.sched.name={sched}",
            "solver.sched.args={" + ",".join(
                f"{k}: {v}" for k, v in args.items()) + "}"]
    fn = get_schedule_fn(tload(CFG, TINY + over), 10, on_device=True)
    want = jsched(jload(CFG, TINY + over), 10)
    for step in range(12):
        got = fn(torch.tensor(float(step), dtype=torch.float64))
        assert float(got) == pytest.approx(float(want(step)), rel=1e-6,
                                           abs=1e-7), step


def test_optimizer_steps_take_the_device_lr(seven):
    """Each optimizer step sets its groups' device LRs to ``base_lr *
    schedule(step)`` from its device step count, which it advances."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.optim.scheduler import get_schedule_fn as jsched

    opt = seven.optimizer
    fn = jsched(jload(CFG, TINY + ["data.synthetic_size=7"]),
                seven.total_steps)
    saved = {p: p.detach().clone() for p in opt.params}
    start = opt.step_count
    for step in range(start, start + 4):
        for p in opt.params:
            p.grad = torch.zeros_like(p)
        opt.step()
        for g in opt.opt.param_groups:
            assert float(g["lr"]) / g["base_lr"] == pytest.approx(
                float(fn(step)), rel=1e-6, abs=1e-7), step
        assert float(opt.step_t) == opt.step_count == step + 1
    with torch.no_grad():  # the shared trainer's parameters as they were
        for p, v in saved.items():
            p.copy_(v)

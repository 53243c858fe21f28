"""Gradient accumulation of the port (``solver.gradient_accumulation_steps``,
``optim/build.py::GPSOptimizer``) against the JAX package's
``optax.MultiSteps(chain(clip_by_global_norm, multi_transform), k)``.

  1. The optimizer alone, k = 2 over 4 micro-batches of the same numpy
     gradients on a two-group model (decay and no-decay halves): the
     parameters after every micro-step, bit-unchanged inside a group. The
     first group's micro-batch gradients have norms above ``grad_norm`` and a
     mean below it, the second group's mean lies above it, so clipping each
     micro-batch or neither would fail. Tolerance: max |port - JAX| per
     tensor <= 1e-6 * max(1, max|JAX|) (the same f32 AdamW in another order;
     one update moves a parameter by about lr = 5e-4, so 1e-6 is 0.2% of it).
  2. The trainers build the schedule over ``total_steps // k`` optimizer
     steps and keep ``total_steps`` in micro-steps, as JAX's do.
  3. A save and resume inside a group (3 micro-steps an epoch, k = 2)
     restores the running mean and the micro-step, and the next micro-step
     completes the group exactly as the uninterrupted trainer does.
  4. The same over two gloo ranks (dp 2, ``tests/_torch_accum_worker.py``):
     the file holds the global batch's running mean, and the resumed
     group ends where the uninterrupted one does.
"""

import numpy as np
import pytest
import torch

from test_torch_slice import CFG, TINY

K = 2


def _cfg(pkg, over=()):
    if pkg == "jax":
        from sceneverse_tpu.config import load_config
    else:
        from sceneverse_tpu_torch.config import load_config
    return load_config(CFG, TINY + ["solver.sched.args.warmup_steps=0",
                                    *over])


class _TorchTiny(torch.nn.Module):
    """Two optimizer groups, each with decay and no-decay parameters."""

    def __init__(self):
        super().__init__()
        self.lang_encoder = torch.nn.ModuleDict({
            "lin": torch.nn.Linear(4, 3), "norm": torch.nn.LayerNorm(3)})
        self.unified_encoder = torch.nn.ModuleDict({
            "lin": torch.nn.Linear(3, 2)})

    def get_opt_params(self):
        return [{"prefix": ("lang_encoder",), "lr": 5e-4},
                {"prefix": ("unified_encoder",), "lr": 1e-3}]

    def frozen_prefixes(self):
        return []


def _jax_tiny():
    from flax import nnx

    class Tiny(nnx.Module):
        def __init__(self, rngs):
            self.lang_encoder = nnx.Dict(
                lin=nnx.Linear(4, 3, rngs=rngs),
                norm=nnx.LayerNorm(3, rngs=rngs))
            self.unified_encoder = nnx.Dict(lin=nnx.Linear(3, 2, rngs=rngs))

        def get_opt_params(self):
            return _TorchTiny.get_opt_params(self)

        def frozen_prefixes(self):
            return []

    return Tiny(nnx.Rngs(0))


# torch name -> (JAX path, transpose)
NAMES = {
    "lang_encoder.lin.weight": (("lang_encoder", "lin", "kernel"), True),
    "lang_encoder.lin.bias": (("lang_encoder", "lin", "bias"), False),
    "lang_encoder.norm.weight": (("lang_encoder", "norm", "scale"), False),
    "lang_encoder.norm.bias": (("lang_encoder", "norm", "bias"), False),
    "unified_encoder.lin.weight": (("unified_encoder", "lin", "kernel"), True),
    "unified_encoder.lin.bias": (("unified_encoder", "lin", "bias"), False),
}


def _grads(rng, model):
    """Per micro-batch gradients {torch name: array in torch layout}: in
    each group the second micro-batch nearly cancels the first in the first
    group (mean norm < 5 < each norm) and repeats it in the second."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = []
    for group in range(2):
        g1 = {n: rng.standard_normal(s).astype(np.float32) * 6.0
              for n, s in shapes.items()}
        sign = -1.0 if group == 0 else 1.0
        g2 = {n: (sign * v + rng.standard_normal(v.shape) * 0.3).astype(
            np.float32) for n, v in g1.items()}
        out += [g1, g2]
    return out


def _norm(g):
    return float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in g.values())))


def test_accumulation_matches_optax_multisteps():
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu_torch.optim.build import GPSOptimizer

    total = 8  # micro-steps: the schedule runs over total // K updates
    jm = _jax_tiny()
    _, tx, _, _ = build_optim(_cfg("jax"), jm, total // K)
    tx = optax.MultiSteps(tx, every_k_schedule=K)
    params = nnx.to_pure_dict(nnx.state(jm, nnx.Param))
    state = tx.init(params)

    tm = _TorchTiny()
    with torch.no_grad():
        for n, p in tm.named_parameters():
            path, t = NAMES[n]
            v = np.asarray(params[path[0]][path[1]][path[2]])
            p.copy_(torch.from_numpy(v.T.copy() if t else v.copy()))
    topt = GPSOptimizer(_cfg("torch"), tm, total // K, accum=K)

    grads = _grads(np.random.default_rng(0), tm)
    grad_norm = float(_cfg("torch").solver.grad_norm)
    mean = lambda a, b: {n: (a[n] + b[n]) / 2 for n in a}
    assert min(_norm(g) for g in grads[:2]) > grad_norm > _norm(
        mean(*grads[:2]))
    assert _norm(mean(*grads[2:])) > grad_norm

    def to_jax(g):
        tree = jax.tree.map(jnp.zeros_like, params)
        for n, v in g.items():
            path, t = NAMES[n]
            tree[path[0]][path[1]][path[2]] = jnp.asarray(v.T if t else v)
        return tree

    moved = 0
    for i, g in enumerate(grads):
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        updates, state = tx.update(to_jax(g), state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        stepped = topt.step()
        assert stepped == (i % K == K - 1)
        for n, p in tm.named_parameters():
            path, t = NAMES[n]
            want = np.asarray(params[path[0]][path[1]][path[2]])
            want = want.T if t else want
            got = p.detach().numpy()
            err = np.abs(got - want).max()
            assert err <= 1e-6 * max(1.0, np.abs(want).max()), (i, n, err)
            if not stepped:  # inside a group the parameters do not move
                assert torch.equal(p.detach(), before[n]), (i, n)
            else:
                moved += int(not torch.equal(p.detach(), before[n]))
    assert topt.step_count == 2 and int(state.gradient_step) == 2
    assert moved == 2 * len(NAMES)


def test_trainers_schedule_over_optimizer_steps(tmp_path):
    from sceneverse_tpu.trainer import build_trainer as jbuild_trainer
    from sceneverse_tpu_torch.trainer.build import build_trainer

    over = ["solver.gradient_accumulation_steps=2", "solver.epochs=3",
            "data.synthetic_size=8", f"exp_dir={tmp_path}"]
    jt = jbuild_trainer(_cfg("jax", over))
    tt = build_trainer(_cfg("torch", over), device="cpu")
    assert tt.total_steps == jt.total_steps == 4 * 3
    assert tt.optimizer.accum == 2
    for s in range(tt.total_steps + 1):
        assert tt.optimizer.schedule(s) == pytest.approx(
            float(jt.schedule(s)), rel=1e-6, abs=1e-7), s
    # over 6 optimizer steps, not 12: the ratio is at its floor at step 6
    assert tt.optimizer.schedule(6) == pytest.approx(0.1)


def _no_dropout(model):
    from sceneverse_tpu_torch.modules.utils import Dropout

    for m in model.modules():
        if isinstance(m, (Dropout, torch.nn.Dropout)):
            m.p = 0.0


def test_resume_inside_a_group_continues_exactly(tmp_path):
    from sceneverse_tpu_torch.trainer.build import build_trainer, to_device

    over = ["solver.gradient_accumulation_steps=2", "solver.epochs=2",
            "data.synthetic_size=6", f"exp_dir={tmp_path}"]
    a = build_trainer(_cfg("torch", over), device="cpu")
    _no_dropout(a.model)
    a.train_step(0)  # 3 micro-steps: one update, then half a group
    assert a.optimizer.step_count == 1 and a.optimizer.mini_step == 1
    a.exp_tracker.step()
    a.save("latest.pth")

    b = build_trainer(_cfg("torch", over + ["resume=True"]), device="cpu")
    _no_dropout(b.model)
    assert b.resumed_from == a.ckpt_path / "latest.pth"
    assert b.exp_tracker.state_dict() == a.exp_tracker.state_dict()
    assert b.global_step == a.global_step == 3
    assert (b.optimizer.step_count, b.optimizer.mini_step) == (1, 1)
    for x, y in zip(a.optimizer.acc, b.optimizer.acc):
        assert torch.equal(x, y)
    assert any(bool(x.abs().max() > 0) for x in b.optimizer.acc)

    batch = next(iter(a.data_loaders["train"]))
    before = {n: p.detach().clone() for n, p in a.model.named_parameters()}
    for t in (a, b):
        t.train_forward_backward(to_device(batch, "cpu"))
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert any(not torch.equal(pa[n].detach(), before[n]) for n in pa)
    for n in pa:
        assert torch.equal(pa[n].detach(), pb[n].detach()), n
    assert b.optimizer.step_count == 2 and b.optimizer.mini_step == 0
    sa, sb = a.optimizer.opt.state_dict(), b.optimizer.opt.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_resume_inside_a_group_over_two_ranks_continues_exactly(tmp_path):
    """Two gloo ranks (dp 2), k = 2: a checkpoint written after one
    micro-step of a group holds the global batch's running mean (the sum of
    the ranks' means, within 1e-5 relative of the world of 1's), and a run
    resumed from it ends the group with the parameters of the
    uninterrupted run within 1e-6 (the same f32 sums in another order; one
    update moves a parameter by about lr = 5e-4). Before the repair every
    rank resumed with rank 0's own mean, and the dp sum doubled it."""
    import multiprocessing

    import _torch_accum_worker as W

    ctx = multiprocessing.get_context("spawn")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        procs = [ctx.Process(target=W.run, args=(r, W.WORLD,
                                                 str(tmp_path / "init"),
                                                 str(tmp_path)))
                 for r in range(W.WORLD)]
        for p in procs:
            p.start()
        try:
            one = W.interrupted(tmp_path / "w1")
        finally:
            for p in procs:
                p.join(240)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    assert [p.exitcode for p in procs] == [0] * W.WORLD
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    assert [r["world"] for r in ranks] == [(2, 0), (2, 1)]
    rel = 1e-5
    for i, want in enumerate(one["saved"]):
        summed = ranks[0]["own"][i] + ranks[1]["own"][i]
        for r in ranks:  # every rank's copy of the file
            assert torch.equal(r["saved"][i], ranks[0]["saved"][i]), i
        got = ranks[0]["saved"][i]
        assert torch.allclose(got, summed, rtol=0, atol=1e-7), i
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= rel * scale + 1e-9, i
    # the two ranks' own means differ: rank 0's alone would not do
    assert any(not torch.allclose(x, y, rtol=0, atol=1e-6) for x, y in
               zip(ranks[0]["own"], ranks[1]["own"]))
    moved = 0
    for r in ranks:
        assert r["steps"] == [(2, 0), (2, 0)]
        for n, pa in r["a"].items():
            err = (r["b"][n] - pa).abs().max().item()
            assert err <= 1e-6, (n, err)
            moved += int(not torch.equal(pa, r["before"][n]))
    assert moved > 0
    for n, pa in ranks[0]["a"].items():  # the ranks hold one model
        assert torch.equal(pa, ranks[1]["a"][n]), n

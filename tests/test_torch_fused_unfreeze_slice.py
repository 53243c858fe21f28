"""Port parity for the fused trainable-SA unfreeze step: the unfrozen
slice of ``test_torch_unfreeze_slice.py`` with ``SCENEVERSE_BN_FOLD=on`` and
``SCENEVERSE_SA_TRAIN_FUSED=on`` on both sides and 4 objects per scene, so
that at batch 2 every SA level has G * m divisible by 8 (SA3: 8 objects x 1
center) and takes the fused path (``sa_train.supported``): the JAX side
through its four Pallas kernels in interpret mode, the port through their
plain twins. A spy on ``fused_trainable_sa`` in each package counts the
levels that took it (JAX: while the step is traced).

As in ``test_torch_unfreeze_slice.py``, both optimizers take the JAX
package's PointNet++ gradients, so the two steps compare the losses and
the BatchNorm statistics, and each SA level's gradients are compared on
identical inputs and output cotangents (those of the port's step 1). float64 is ruled out
here: the fused path rounds to bf16 by definition.

Tolerances. Both sides round to bf16 at the same points, but u is summed
in another order, so now and then a bf16 rounding or a ReLU / max-pool
decision lands the other way and moves one row's term. The port alone
moves its SA2 layer-3 weight gradient by 2.9e-2 of its size when SA2's
input channels are merely permuted
(``test_port_level_grads_move_with_summation_order``); the JAX-vs-port
differences measured here are of that size at SA2 and smaller at SA1 and
SA3 (losses 4e-4 relative, BN statistics 7e-4, level gradients 4.1e-3 at
SA1, 3.1e-2 at SA2, 3.3e-3 at SA3):
  * losses of both steps: 1e-3 * max(1, |jax|);
  * BatchNorm running mean / var after each step: 2e-3 * max|jax|;
  * per-level gradients (parameters and, past SA1, inputs), ``LEVEL_TOL``:
    1e-2 at SA1 and SA3, 5e-2 at SA2, times max|jax| of the tensor, plus
    1e-6 * the level's largest gradient (the floor covers SA2's xyz
    gradient, zero where a ball holds only its center).
Time: the fixture takes ~70 s on one CPU process, most of it XLA tracing
and compiling the interpret-mode Pallas kernels of the JAX step and of
SA1's level gradients.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from torch import nn

from sceneverse_tpu.config import load_config
from sceneverse_tpu.data.build import get_dataset, numpy_collate
from sceneverse_tpu.ops.pallas import sa_train as jst
from sceneverse_tpu_torch.modules.layers import pointnet as tpn
from test_torch_slice import CFG, _flat
from test_torch_unfreeze_slice import PNET, UNFREEZE, _bn_stats

FUSED = UNFREEZE + ["data.args.max_obj_len=4"]
# per-level gradient limits on max|port - jax| / max|jax| (module docstring)
LEVEL_TOL = (1e-2, 5e-2, 1e-2)


def _level_grads_jax(sa, xyz, feats, cot, wrt_inputs):
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    args = [jnp.asarray(a) for a in (xyz, feats, cot)]

    def loss(m, x, f):
        return jnp.sum(m(x, f)[1].astype(jnp.float32) * args[2])

    argnums = (0, 1, 2) if wrt_inputs else 0
    grads = nnx.jit(nnx.grad(loss, argnums=argnums))(nnx.clone(sa), args[0],
                                                     args[1])
    gsa = grads[0] if wrt_inputs else grads
    out = {k.replace("mlps.0.", "", 0): v.numpy() for k, v in
           from_jax_params(_flat(nnx.state(gsa, nnx.Param))).items()}
    if wrt_inputs:
        out["xyz"], out["feats"] = np.asarray(grads[1]), np.asarray(grads[2])
    return out


def _level_grads_torch(sa, xyz, feats, cot, wrt_inputs):
    sa = copy.deepcopy(sa)
    x = torch.from_numpy(xyz).requires_grad_(wrt_inputs)
    f = torch.from_numpy(feats).requires_grad_(wrt_inputs)
    (sa(x, f)[1].float() * torch.from_numpy(cot)).sum().backward()
    out = {k.replace("mlps.0.", "", 0): p.grad.numpy()
           for k, p in sa.named_parameters()}
    if wrt_inputs:
        out["xyz"], out["feats"] = x.grad.numpy(), f.grad.numpy()
    return out


@pytest.fixture(scope="module")
def fused():
    """Both sides' losses, BN statistics after each step, per-level grads
    and the fused-path call counts."""
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    calls = {"jax": 0, "torch": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        mp.setenv("SCENEVERSE_BN_FOLD", "on")
        mp.setenv("SCENEVERSE_SA_TRAIN_FUSED", "on")
        # XLA attention on the JAX side (the same f32 math as its fused MHA
        # kernel, which the other slice tests hold the port's against):
        # tracing that kernel in interpret mode would double this file's time
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        for side, mod in (("jax", jst), ("torch", tpn)):
            orig = mod.fused_trainable_sa

            def spy(*a, _o=orig, _s=side, **k):
                calls[_s] += 1
                return _o(*a, **k)

            mp.setattr(mod, "fused_trainable_sa", spy)
        cfg = load_config(CFG, FUSED)
        ds = get_dataset(cfg, "train")
        items = [ds[i] for i in range(len(ds))
                 if (ds[i]["masked_lm_labels"] != -1).any()][:2]
        batch = {k: v for k, v in numpy_collate(items).items()
                 if isinstance(v, np.ndarray)}
        jm = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))()
        jm.eval()
        for _, m in nnx.iter_modules(jm):
            if isinstance(m, nnx.BatchNorm):
                m.use_running_average = False
        jsa = [nnx.clone(sa) for sa in
               jm.point_encoder.point_feature_extractor.encoder]
        tm = tbuild(cfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.train()
        levels = []  # per SA level: (module copy, xyz, feats, output)

        def capture(mod, inp, out):
            if len(levels) < 3:
                out[1].retain_grad()
                levels.append((copy.deepcopy(mod), inp[0].detach().numpy(),
                               inp[1].detach().numpy(), out[1]))

        hooks = [sa.register_forward_hook(capture)
                 for sa in tm.point_encoder.point_feature_extractor.encoder]
        loss_mod, tx, _, _ = build_optim(cfg, jm, total_steps=10)
        tloss = Loss(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        step = nnx.jit(nnx.value_and_grad(
            lambda m: loss_mod(m(jb)), has_aux=True))

        @jax.jit
        def adamw(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        params = nnx.state(jm, nnx.Param)
        opt_state = jax.jit(tx.init)(params)
        topt = GPSOptimizer(cfg, tm, total_steps=10)
        res = {"missing": missing, "unexpected": unexpected,
               "bn0": _bn_stats(tm.state_dict()), "loss": [], "bn": []}
        for i in range(2):
            (_, jlosses), grads = step(jm)
            g = nnx.state(grads, nnx.Param)
            params, opt_state = adamw(g, opt_state, params)
            nnx.update(jm, params)
            topt.zero_grad()
            ttotal, tlosses = tloss(tm(tb))
            ttotal.backward()
            res["loss"].append({k: (float(jlosses[k]),
                                    float(tlosses[k].detach()))
                                for k in jlosses})
            if i == 0:
                res["calls"] = dict(calls)
            jg = from_jax_params(_flat(g))
            with torch.no_grad():  # both optimizers take JAX's PointNet++ grads
                for n, p in tm.named_parameters():
                    if n.startswith(PNET):
                        p.grad.copy_(jg[n])
            topt.step()
            jstats = _bn_stats(from_jax_params(
                _flat(nnx.state(jm, nnx.BatchStat))))
            res["bn"].append({n: (jstats[n], t) for n, t in
                              _bn_stats(tm.state_dict()).items()})
        for h in hooks:
            h.remove()
        res["level"] = []
        for li, (tsa, xyz, feats, out) in enumerate(levels):
            cot = out.grad.numpy()
            wrt = li > 0  # SA1's input is data
            n0 = dict(calls)
            res["level"].append((
                _level_grads_jax(jsa[li], xyz, feats, cot, wrt),
                _level_grads_torch(tsa, xyz, feats, cot, wrt),
                {k: calls[k] - n0[k] for k in calls}))
            if li == 1:
                res["sa2"] = (tsa, xyz, feats, cot)
    return res


def test_fused_weights_carry_over_and_every_level_takes_the_fused_path(
        fused):
    assert fused["missing"] == [] and fused["unexpected"] == []
    # step 1: three levels on each side (JAX counts while tracing the step)
    assert fused["calls"] == {"jax": 3, "torch": 3}
    for _, _, calls in fused["level"]:
        assert calls == {"jax": 1, "torch": 1}


def test_fused_losses_match_jax(fused):
    assert len(fused["loss"]) == 2
    for step in fused["loss"]:
        for k, (j, t) in step.items():
            assert np.isfinite(t) and j > 0, k
            assert abs(t - j) <= 1e-3 * max(1.0, abs(j)), (k, j, t)


def test_fused_bn_running_statistics_each_step(fused):
    assert len(fused["bn0"]) == 2 * 9
    for stats in fused["bn"]:
        assert set(stats) == set(fused["bn0"])
        for n, (j, t) in stats.items():
            assert not np.array_equal(t, fused["bn0"][n]), n
            assert np.abs(t - j).max() <= 2e-3 * np.abs(j).max(), n


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fused_sa_level_grads_match_jax(fused, level):
    jax_g, torch_g, _ = fused["level"][level]
    assert set(jax_g) == set(torch_g)
    assert len(jax_g) == 9 + 2 * (level > 0)
    gmax = max(np.abs(j).max() for j in jax_g.values())
    worst = 0.0
    for n, j in jax_g.items():
        err = np.abs(torch_g[n] - j).max()
        worst = max(worst, (err - 1e-6 * gmax) / np.abs(j).max())
        assert err <= LEVEL_TOL[level] * np.abs(j).max() + 1e-6 * gmax, (
            n, err)
    print(f"SA{level + 1} level gradients: {worst:.3e} of max|jax|")


def test_port_level_grads_move_with_summation_order(fused):
    """Why the per-level tolerance is what it is: permuting SA2's input
    feature channels (and the conv columns that read them) is exact in real
    arithmetic but sums layer 1 in another order. The port's own gradients
    of SA2's later layers then move by more than 1e-2 of their size, the
    scale of the JAX-vs-port differences above (bf16 roundings and ReLU
    decisions that land the other way)."""
    tsa, xyz, feats, cot = fused["sa2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_BN_FOLD", "on")
        mp.setenv("SCENEVERSE_SA_TRAIN_FUSED", "on")
        base = _level_grads_torch(tsa, xyz, feats, cot, False)
        perm = np.random.RandomState(0).permutation(feats.shape[-1])
        moved = copy.deepcopy(tsa)
        with torch.no_grad():
            w = moved.mlps[0].layer0.conv.weight
            w[:, 3:] = w[:, 3:][:, torch.from_numpy(perm)]
        other = _level_grads_torch(moved, xyz, np.ascontiguousarray(
            feats[..., perm]), cot, False)
    rel = max(np.abs(other[n] - g).max() / np.abs(g).max()
              for n, g in base.items() if n.startswith("mlps.0.layer2.conv"))
    assert rel > 1e-2, rel
    print(f"summation-order move {rel:.3e}")

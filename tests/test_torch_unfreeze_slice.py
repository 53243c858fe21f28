"""Port parity for the unfrozen-PointNet++ pretrain step: the
sceneverse_tpu_torch OpenVocab model with ``model.vision.args.freeze=False``
against the JAX model and optax, with the JAX weights (and BatchNorm
statistics) carried over by ``from_jax_params``.

Setup: the widths of ``tests/test_torch_slice.py`` (hidden 64, 2 layers per
tower), 5 objects x 256 points, batch 2. The JAX side runs under
SCENEVERSE_PALLAS_INTERPRET=1, so its SA1 (N=256) goes through the
``sample_and_group`` Pallas kernel in interpret mode and its attention
through the fused MHA kernel. Both sides run with every dropout off (eval
mode) and the PointNet++ BatchNorm layers in train mode: batch statistics in
the forward, running statistics moved by each step.

Why the PointNet++ gradients are held per SA level: the forward of the two
frameworks agrees to ~1e-5 relative (BatchNorm batch moments summed in
another order), and that is enough to flip a few ReLU masks and max-pool
winners among the ~10^5 decisions per level. Each flip moves a whole row of
a weight gradient: perturbing SA1's output by 3e-5 (random, relative)
moves the port's own SA2/SA3 weight gradients by over 1e-2
(``test_pointnet_grads_move_under_forward_noise``). So the whole-model step-1
gradients are compared only for the tensors downstream of every such
decision (the towers, SA3's last layer and ``fc``), and every SA level's
gradients (parameters and inputs) are compared in float64, each level fed
the same inputs and output cotangent as the port saw in its step 1: there
the two sides make the same decisions. The AdamW steps then take the JAX
package's PointNet++ gradients on both sides, so that two steps compare the
optimizer groups and the BatchNorm statistics rather than the chaos above.

Tolerances (max abs error per tensor):
  * losses of both steps: 1e-4 * max(1, |jax|), as in ``test_torch_slice.py``;
  * step-1 gradients and parameters after 2 AdamW steps: the rules of
    ``test_torch_slice.py`` (its docstring gives the reasons);
  * per-level float64 gradients: 1e-9 * max|jax| + 1e-12 * the level's
    largest gradient (the same f64 arithmetic in another summation order;
    SA1's grouping is f32 on both sides; the floor covers SA2's xyz
    gradient, zero in exact arithmetic where a ball holds its center only);
  * BatchNorm running mean / var after each step: 1e-5 * max|jax|: f32
    batch moments of the same activations, summed in another order.
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
from test_torch_slice import CFG, TINY, _flat

UNFREEZE = TINY + [
    "data.synthetic_size=16", "data.args.max_obj_len=5",
    "data.args.max_seq_len=16", "data.args.max_scene_cap_len=16",
    "data.args.num_points=256", "model.vision.args.freeze=False",
    "model.lm_max_predictions=4", "model.split_scene_cap_tower=True",
    "solver.sched.args.warmup_steps=0", "solver.optim.args.eps=1e-6",
]
PNET = "point_encoder.point_feature_extractor."
# PointNet++ tensors downstream of every ReLU / max-pool decision
PNET_SMOOTH = (PNET + "fc.", PNET + "encoder.2.mlps.0.layer2.")
N_PNET = 3 * (3 + 3 + 3) + 2  # 3 levels x 3 layers x (conv, BN w, BN b) + fc


def _bn_stats(flat: dict) -> dict:
    return {k: np.array(v) for k, v in flat.items()
            if k.endswith(("running_mean", "running_var"))}


def _level_grads_jax(sa, xyz, feats, cot, wrt_inputs):
    """float64 gradients of sum(sa(xyz, feats)[1] * cot): {torch name:
    array} for the level's parameters, plus 'xyz'/'feats' when asked."""
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    with jax.enable_x64(True):
        sa = nnx.clone(sa)
        f64 = lambda a: (a.astype(jnp.float64)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a)
        nnx.update(sa, jax.tree.map(f64, nnx.state(sa)))
        args = [jnp.asarray(a, jnp.float64) for a in (xyz, feats, cot)]

        def loss(m, x, f):
            return jnp.sum(m(x, f)[1] * args[2])

        argnums = (0, 1, 2) if wrt_inputs else 0
        grads = nnx.grad(loss, argnums=argnums)(sa, args[0], args[1])
        gsa = grads[0] if wrt_inputs else grads
        out = {k.replace("mlps.0.", "", 0): v.numpy() for k, v in
               from_jax_params(_flat(nnx.state(gsa, nnx.Param))).items()}
        if wrt_inputs:
            out["xyz"], out["feats"] = np.asarray(grads[1]), np.asarray(grads[2])
    return out


def _level_grads_torch(sa, xyz, feats, cot, wrt_inputs):
    sa = copy.deepcopy(sa).double()
    x = torch.from_numpy(xyz).double().requires_grad_(wrt_inputs)
    f = torch.from_numpy(feats).double().requires_grad_(wrt_inputs)
    (sa(x, f)[1] * torch.from_numpy(cot).double()).sum().backward()
    out = {k.replace("mlps.0.", "", 0): p.grad.numpy()
           for k, p in sa.named_parameters()}
    if wrt_inputs:
        out["xyz"], out["feats"] = x.grad.numpy(), f.grad.numpy()
    return out


@pytest.fixture(scope="module")
def unfrozen():
    """Both sides' losses, step-1 grads, per-level f64 grads, params after
    two steps and BN statistics before and after each step."""
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        cfg = load_config(CFG, UNFREEZE)
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

        def loss_fn(m):
            total, losses = loss_mod(m(jb))
            return total, losses

        step = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))

        @jax.jit
        def adamw(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        params = nnx.state(jm, nnx.Param)
        opt_state = jax.jit(tx.init)(params)
        topt = GPSOptimizer(cfg, tm, total_steps=10)
        lrs = {id(p): g["base_lr"] for g in topt.opt.param_groups
               for p in g["params"]}
        res = {"missing": missing, "unexpected": unexpected,
               "lr": {n: lrs.get(id(p)) for n, p in tm.named_parameters()},
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
            jg = from_jax_params(_flat(g))
            if i == 0:
                res["grad"] = {n: (jg[n].numpy(), p.grad.numpy().copy())
                               for n, p in tm.named_parameters()
                               if p.grad is not None}
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
        jp = from_jax_params(_flat(nnx.state(jm, nnx.Param)))
        tp = dict(tm.named_parameters())
        res["param"] = {n: (jp[n].numpy(), tp[n].detach().numpy().copy())
                        for n in jp}
        res["level"] = []
        for li, (tsa, xyz, feats, out) in enumerate(levels):
            cot = out.grad.numpy()
            wrt = li > 0  # SA1's input is data
            res["level"].append((
                _level_grads_jax(jsa[li], xyz, feats, cot, wrt),
                _level_grads_torch(tsa, xyz, feats, cot, wrt)))
    return res


def test_unfrozen_weights_and_statistics_carry_over(unfrozen):
    assert unfrozen["missing"] == [] and unfrozen["unexpected"] == []
    pnet = {n: lr for n, lr in unfrozen["lr"].items() if n.startswith(PNET)}
    assert len(pnet) == N_PNET and set(pnet.values()) == {1e-4}


def test_unfrozen_losses_match_jax(unfrozen):
    assert len(unfrozen["loss"]) == 2
    for step in unfrozen["loss"]:
        for k, (j, t) in step.items():
            assert np.isfinite(t) and j > 0, k
            assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t)


def test_unfrozen_step1_grads_match_jax(unfrozen):
    grads = unfrozen["grad"]
    gmax = max(np.abs(j).max() for j, _ in grads.values())
    assert len([n for n in grads if n.startswith(PNET)]) == N_PNET
    checked = 0
    for n, (j, t) in grads.items():
        if n.startswith(PNET) and not n.startswith(PNET_SMOOTH):
            continue  # held per level below
        err = np.abs(t - j).max()
        assert err <= 1e-3 * np.abs(j).max() + 1e-6 * gmax, (n, err)
        checked += n.startswith(PNET)
    assert checked == 5


@pytest.mark.parametrize("level", [0, 1, 2])
def test_unfrozen_sa_level_grads_match_jax_in_float64(unfrozen, level):
    jax_g, torch_g = unfrozen["level"][level]
    assert set(jax_g) == set(torch_g)
    assert len(jax_g) == 9 + 2 * (level > 0)
    gmax = max(np.abs(j).max() for j in jax_g.values())
    for n, j in jax_g.items():
        err = np.abs(torch_g[n] - j).max()
        assert err <= 1e-9 * np.abs(j).max() + 1e-12 * gmax, (n, err)


def test_unfrozen_params_after_two_adamw_steps(unfrozen):
    moved = 0
    for n, (j, t) in unfrozen["param"].items():
        lr = unfrozen["lr"].get(n)
        if lr is None:
            continue
        err = np.abs(t - j)
        floor = 1e-4 * np.abs(j).max()
        assert (err > floor + 1e-2 * 2 * lr).sum() <= max(1, 1e-3 * err.size), n
        assert err.max() <= floor + 0.25 * 2 * lr, (n, err.max())
        moved += n.startswith(PNET)
    assert moved == N_PNET


def test_unfrozen_bn_running_statistics_each_step(unfrozen):
    assert len(unfrozen["bn0"]) == 2 * 9
    for stats in unfrozen["bn"]:
        assert set(stats) == set(unfrozen["bn0"])
        for n, (j, t) in stats.items():
            assert not np.array_equal(t, unfrozen["bn0"][n]), n
            assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), n


def test_unfrozen_backbone_optimizer_groups():
    """The backbone trains in the vision group (lr 1e-4); BatchNorm scale /
    shift and ``fc.bias`` take no weight decay, the JAX package's
    ``_is_no_decay`` rule (leaves named ``bias`` or ``scale``)."""
    from sceneverse_tpu_torch.config import load_config as port_config
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.optim.build import GPSOptimizer

    cfg = port_config(CFG, UNFREEZE)
    model = build_model(cfg)
    opt = GPSOptimizer(cfg, model, total_steps=10)
    group_of = {id(p): g for g in opt.opt.param_groups for p in g["params"]}
    pnet = [(n, p) for n, p in model.named_parameters() if n.startswith(PNET)]
    assert len(pnet) == N_PNET
    for n, p in pnet:
        assert p.requires_grad, n
        g = group_of[id(p)]
        no_decay = n.endswith(("bn.bn.weight", "bn.bn.bias", "fc.bias"))
        assert (g["base_lr"], g["weight_decay"]) == (
            1e-4, 0.0 if no_decay else 0.01), n
    assert model.frozen_prefixes() == []


def test_pointnet_grads_move_under_forward_noise():
    """Why the PointNet++ gradients are held per level: a random relative
    perturbation of SA1's output the size of the two frameworks' forward
    difference moves the port's own SA2/SA3 weight gradients by more than
    the slice rule's 1e-3 (ReLU masks and max-pool winners flip)."""
    from sceneverse_tpu_torch.modules.layers.pointnet import PointNetPP

    torch.manual_seed(0)
    pnet = PointNetPP(sa_n_points=[32, 16, None], sa_n_samples=[32, 32, None],
                      sa_radii=[0.2, 0.4, None],
                      sa_mlps=[[3, 64, 64, 128], [128, 128, 128, 256],
                               [256, 256, 512, 64]]).train()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(10, 256, 6).astype(np.float32))
    dy = torch.from_numpy(rng.randn(10, 64).astype(np.float32))
    noise = torch.from_numpy(rng.randn(10, 32, 128).astype(np.float32))
    with torch.no_grad():
        xyz1, f1 = pnet.encoder[0](x[..., :3].contiguous(), x[..., 3:])

    def grads(feats):
        pnet.zero_grad()
        xyz2, f2 = pnet.encoder[1](xyz1, feats)
        _, f3 = pnet.encoder[2](xyz2, f2)
        (pnet.fc(f3.reshape(10, -1)) * dy).sum().backward()
        return {n: p.grad.clone() for n, p in pnet.named_parameters()
                if n.startswith(("encoder.1.", "encoder.2.")) and "conv" in n}

    base, moved = grads(f1), grads(f1 * (1 + 3e-5 * noise))
    rel = max(((moved[n] - g).abs().max() / g.abs().max()).item()
              for n, g in base.items())
    assert rel > 1e-2

"""Port parity for the trainable fused set abstraction
(``sceneverse_tpu_torch/ops/sa_train.py``), the ``SCENEVERSE_BN_FOLD`` route
(``ConvBNReLU._folded``), the gates and routing of the trainable
PointNet++, and its bf16 mixed-precision policy, against the JAX package.

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode (``interpret=True``); the port runs the kernels' plain twins,
which the CPU takes because the tensors lie on the CPU. Shapes: those of
``tests/test_sa_train.py`` (G, M, NS, C = 8, 4, 8, 6, spec [6, 8, 8, 16])
and SA2's real widths (131 -> 128, 128, 256) on 128 rows.

Tolerances (max abs error over max|jax| of the tensor):
  * ``mlp_stats`` / ``mlp_pool`` values: 1e-5. Both sides round at the
    same points (bf16 operands, bf16(h) between layers and for the
    moments) and sum exact bf16 products in f32 in another order.
  * their VJPs: 1e-4. Same arithmetic; the backward sums over rows and
    channels in another order as well.
  * argmax: identical (no ties at these sizes but at 0, where both take
    the first slot).
  * composite ``fused_trainable_sa`` and ``_folded``: 1e-5 for values,
    running statistics and gradients (measured <= 1e-6). The layer-1
    moments and the fold (rsqrt of a variance that is a difference of two
    sums) run in f32 in another order.
  * bf16 PointNet++: see ``test_pointnet_bf16_follows_jax_mixed_precision``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from sceneverse_tpu.modules.layers import pointnet as jpn
from sceneverse_tpu.ops.pallas import sa_train as jst
from sceneverse_tpu_torch.modules.layers import pointnet as tpn
from sceneverse_tpu_torch.ops import sa_train as tst
from test_torch_slice import _flat

G, M, NS, C = 8, 4, 8, 6
SMALL = [C, 8, 8, 16]
SA2 = [131, 128, 128, 256]
GATES = ("SCENEVERSE_BN_FOLD", "SCENEVERSE_SA_TRAIN_FUSED",
         "SCENEVERSE_BN_BF16")


def _params(spec, seed=0):
    rng = np.random.RandomState(seed)
    return [((rng.randn(cin, h) / np.sqrt(cin)).astype(np.float32),
             rng.rand(h).astype(np.float32) + 0.5,
             rng.randn(h).astype(np.float32) * 0.1)
            for cin, h in zip(spec, spec[1:])]


def _rows(spec, rows, seed=1):
    return np.random.RandomState(seed).randn(rows, spec[0]).astype(
        np.float32)


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float32)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)


def _jax(params):
    return tuple(tuple(jnp.asarray(a) for a in p) for p in params)


def _torch(params):
    return tuple(tuple(torch.from_numpy(a).requires_grad_() for a in p)
                 for p in params)


CASES = [("small", SMALL, G * M * NS), ("sa2", SA2, 128)]


@pytest.mark.parametrize("upto", [1, 2])
@pytest.mark.parametrize("name,spec,rows", CASES)
def test_mlp_stats_and_vjp_match_jax(name, spec, rows, upto):
    params, x = _params(spec), _rows(spec, rows)
    H = spec[upto]
    rng = np.random.RandomState(7)
    dS = rng.randn(H).astype(np.float32)
    dG = (rng.randn(H, H) / H).astype(np.float32)
    (js, jg), vjp = jax.vjp(
        lambda x, p: jst.mlp_stats(x, p, upto, True),
        jnp.asarray(x).T, _jax(params))
    jdx, jdp = vjp((jnp.asarray(dS), jnp.asarray(dG)))
    tx, tp = torch.from_numpy(x).requires_grad_(), _torch(params)
    ts, tg = tst.mlp_stats(tx, tp, upto)
    assert _rel(ts, js) <= 1e-5 and _rel(tg, jg) <= 1e-5
    grads = torch.autograd.grad(
        (ts * torch.from_numpy(dS)).sum() + (tg * torch.from_numpy(dG)).sum(),
        [tx] + [t for p in tp for t in p])
    assert _rel(grads[0], np.asarray(jdx).T) <= 1e-4
    for t, j in zip(grads[1:], jax.tree.leaves(jdp)):
        if np.abs(np.asarray(j)).max() == 0:  # layers beyond upto
            assert not t.any()
        else:
            assert _rel(t, j) <= 1e-4


@pytest.mark.parametrize("name,spec,rows", CASES)
def test_mlp_pool_and_vjp_match_jax(name, spec, rows):
    params, x = _params(spec), _rows(spec, rows)
    jpooled, jarg = jst._mlp_pool_fwd_impl(jnp.asarray(x).T, _jax(params),
                                           NS, True)
    tx, tp = torch.from_numpy(x).requires_grad_(), _torch(params)
    tpooled, targ = tst.mlp_pool(tx, tp, NS)
    assert _rel(tpooled, jpooled) <= 1e-5
    assert targ.dtype == torch.int32
    assert np.array_equal(targ.numpy(), np.asarray(jarg))
    cot = np.random.RandomState(8).randn(*tpooled.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, p: jst.mlp_pool(x, p, NS, True),
                     jnp.asarray(x).T, _jax(params))
    jdx, jdp = vjp(jnp.asarray(cot))
    grads = torch.autograd.grad((tpooled * torch.from_numpy(cot)).sum(),
                                [tx] + [t for p in tp for t in p])
    assert _rel(grads[0], np.asarray(jdx).T) <= 1e-4
    for t, j in zip(grads[1:], jax.tree.leaves(jdp)):
        assert _rel(t, j) <= 1e-4


def test_mlp_pool_takes_the_first_slot_on_ties_as_jax():
    """Each center's 8 slots hold copies of 3 distinct rows, so equal
    positive maxima are common: the twin's argmax is JAX's, the first slot
    that holds the winning row (the semantics the CUDA ``sa_pool`` keeps,
    held on the card by ``test_sa_train_kernels_match_plain``)."""
    params, base = _params(SMALL), _rows(SMALL, G * M * 3)
    src = np.random.RandomState(9).randint(0, 3, (G * M, NS))
    x = base.reshape(G * M, 3, C)[np.arange(G * M)[:, None], src].reshape(
        -1, C)
    jpooled, jarg = jst._mlp_pool_fwd_impl(jnp.asarray(x).T, _jax(params),
                                           NS, True)
    tp = tuple(tuple(torch.from_numpy(a) for a in p) for p in params)
    tpooled, targ = tst.mlp_pool_plain(torch.from_numpy(x), tp, NS)
    assert _rel(tpooled, jpooled) <= 1e-5
    assert np.array_equal(targ.numpy(), np.asarray(jarg))
    same = src[:, :, None] == src[:, None, :]
    arg = targ.numpy()
    first = same.argmax(-1)  # the first slot holding each slot's row
    assert np.array_equal(np.take_along_axis(first, arg, 1), arg)
    repeated = np.take_along_axis(same.sum(-1), arg, 1) > 1
    assert (repeated & (tpooled.numpy() > 0)).sum() > 0


def test_plain_twins_repeat_the_kernels_rounding_points():
    """The twins' bf16 rounding is visible: the same chain in f32 gives
    other moments than the twin (so the parity above is not vacuous)."""
    params, x = _params(SA2), _rows(SA2, 128)
    tp = tuple(tuple(torch.from_numpy(a) for a in p) for p in params)
    xt = torch.from_numpy(x)
    s, _ = tst.mlp_stats_plain(xt, tp, 2)
    h = xt
    for w, a, b in tp[:2]:
        h = torch.relu(h @ w * a + b)
    assert (s - h.sum(0)).abs().max() > 1e-3 * h.sum(0).abs().max()


def _shared_mlps(spec, seed=0):
    """A JAX SharedMLP (train mode) and the port's, same weights."""
    jm = jpn.SharedMLP(spec, rngs=nnx.Rngs(seed))
    jm.train()
    rng = np.random.RandomState(seed + 11)
    tm = tpn.SharedMLP(spec).train()
    for jl, tl in zip(jm.layers, tm.layers()):
        # random BN affine so the fold's scale and shift are exercised
        h = jl.bn.scale.value.shape[0]
        jl.bn.scale.value = jnp.asarray(rng.rand(h).astype(np.float32) + 0.5)
        jl.bn.bias.value = jnp.asarray(rng.randn(h).astype(np.float32) * .1)
        with torch.no_grad():
            tl.conv.weight.copy_(torch.from_numpy(
                np.asarray(jl.conv.kernel.value).T.copy()))
            tl.bn.bn.weight.copy_(torch.from_numpy(
                np.asarray(jl.bn.scale.value)))
            tl.bn.bn.bias.copy_(torch.from_numpy(
                np.asarray(jl.bn.bias.value)))
    return jm, tm


def _jax_grads(fn, jm, grouped, cot):
    """Value, new BN statistics, and gradients w.r.t. the MLP's params and
    the grouped rows of sum(fn(mlp, grouped) * cot)."""
    graphdef, state = nnx.split(jm)

    def f(state, grouped):
        m = nnx.merge(graphdef, state)
        out = fn(m, grouped)
        _, new_state = nnx.split(m)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, new_state)

    (_, (out, new_state)), (gs, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(state, jnp.asarray(grouped))
    return (np.asarray(out, np.float32), _flat(nnx.state(
        nnx.merge(graphdef, new_state), nnx.BatchStat)),
        _flat(nnx.state(nnx.merge(graphdef, gs), nnx.Param)), np.asarray(gx))


def _torch_grads(fn, tm, grouped, cot):
    x = torch.from_numpy(grouped).requires_grad_()
    out = fn(tm, x)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, x.grad


def _compare(jres, tm, tout, tgx, tol):
    jout, jstats, jgrads, jgx = jres
    assert _rel(tout, jout) <= tol
    assert _rel(tgx, jgx) <= tol
    for i, l in enumerate(tm.layers()):
        bn = l.bn.bn
        pre = f"layers.{i}."
        for name, t in (("bn.mean", bn.running_mean), ("bn.var",
                                                        bn.running_var)):
            assert _rel(t, jstats[pre + name]) <= tol, pre + name
        for name, t in (("conv.kernel", l.conv.weight.grad.t()),
                        ("bn.scale", bn.weight.grad),
                        ("bn.bias", bn.bias.grad)):
            assert _rel(t, jgrads[pre + name]) <= tol, pre + name


def test_fused_trainable_sa_matches_jax(monkeypatch):
    """The composite: pooled, the BN running statistics after one call, and
    the gradients w.r.t. the grouped rows, the convs and the BN affine."""
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    rng = np.random.RandomState(3)
    grouped = rng.randn(G, M, NS, C).astype(np.float32)
    cot = rng.randn(G, M, SMALL[-1]).astype(np.float32)
    jm, tm = _shared_mlps(SMALL)
    jres = _jax_grads(lambda m, g: jst.fused_trainable_sa(
        g, m, interpret=True), jm, grouped, cot)
    tout, tgx = _torch_grads(lambda m, x: tpn.fused_trainable_sa(x, m),
                             tm, grouped, cot)
    assert tout.shape == (G, M, SMALL[-1]) and tout.dtype == torch.float32
    _compare(jres, tm, tout, tgx, 1e-5)


def test_folded_route_matches_jax(monkeypatch):
    """``SCENEVERSE_BN_FOLD=on`` at f32: the SharedMLP's values, gradients
    and running statistics through ``ConvBNReLU._folded``."""
    monkeypatch.setenv("SCENEVERSE_BN_FOLD", "on")
    rng = np.random.RandomState(4)
    grouped = rng.randn(G, M, NS, C).astype(np.float32)
    cot = rng.randn(G, M, NS, SMALL[-1]).astype(np.float32)
    jm, tm = _shared_mlps(SMALL, seed=1)
    calls = []
    orig = tpn.ConvBNReLU._folded
    monkeypatch.setattr(tpn.ConvBNReLU, "_folded",
                        lambda self, x: calls.append(1) or orig(self, x))
    jres = _jax_grads(lambda m, g: m(g), jm, grouped, cot)
    tout, tgx = _torch_grads(lambda m, x: m(x), tm, grouped, cot)
    assert len(calls) == 3
    _compare(jres, tm, tout, tgx, 1e-5)


def test_supported_follows_jax():
    for shape in [(8, 4, 8), (2, 1, 16), (2560, 32, 32), (2560, 1, 16),
                  (5, 32, 32), (3, 1, 16), (1, 4, 8)]:
        assert tst.supported(*shape) == jst.supported(*shape), shape


def test_gates_read_jax_names_at_call_time(monkeypatch):
    readers = {"SCENEVERSE_BN_FOLD": (tpn._bn_fold_enabled,
                                      jpn._bn_fold_enabled, False),
               "SCENEVERSE_SA_TRAIN_FUSED": (tpn._sa_train_fused_enabled,
                                             jpn._sa_train_fused_enabled,
                                             False),
               "SCENEVERSE_BN_BF16": (tpn._bn_bf16, None, True)}
    for name, (port, ref, default) in readers.items():
        monkeypatch.delenv(name, raising=False)
        assert port() is default
        for v in ("1", "on", "ON", "true", "off", "0", "no", ""):
            monkeypatch.setenv(name, v)
            want = v.lower() in ("1", "on", "true")
            assert port() is want, (name, v)
            if ref is not None:
                assert ref() is want
    monkeypatch.delenv("SCENEVERSE_BN_BF16")
    monkeypatch.setenv("SCENEVERSE_BN_BF16", "off")
    x = torch.zeros(2, 8)
    with torch.autocast("cpu", torch.bfloat16):
        assert tpn.bn_out_dtype(x) == torch.float32
    monkeypatch.setenv("SCENEVERSE_BN_BF16", "on")
    with torch.autocast("cpu", torch.bfloat16):
        assert tpn.bn_out_dtype(x) == torch.bfloat16
    assert tpn.bn_out_dtype(x) == torch.float32


@pytest.mark.parametrize("fold,fused,train,route", [
    ("off", "off", True, "literal"), ("off", "on", True, "literal"),
    ("on", "off", True, "folded"), ("on", "on", True, "fused"),
    ("on", "on", False, "literal"),
])
def test_routing_by_gates(monkeypatch, fold, fused, train, route):
    """Which route a trainable SA level takes, and that the literal route
    with the gates off is today's computation, bit for bit."""
    monkeypatch.setenv("SCENEVERSE_BN_FOLD", fold)
    monkeypatch.setenv("SCENEVERSE_SA_TRAIN_FUSED", fused)
    seen = []
    orig = tpn.fused_trainable_sa
    monkeypatch.setattr(tpn, "fused_trainable_sa", lambda *a: seen.append(
        "fused") or orig(*a))
    orig_fold = tpn.ConvBNReLU._folded
    monkeypatch.setattr(tpn.ConvBNReLU, "_folded", lambda self, x: seen.append(
        "folded") or orig_fold(self, x))
    torch.manual_seed(0)
    sa = tpn.PointnetSAModule(npoint=None, radius=None, nsample=None,
                              mlp=[5, 16, 16, 32]).train(train)
    rng = np.random.RandomState(5)
    xyz = torch.from_numpy(rng.randn(8, 16, 3).astype(np.float32))
    feats = torch.from_numpy(rng.randn(8, 16, 5).astype(np.float32))
    _, out = sa(xyz, feats)
    assert out.shape == (8, 1, 32)
    assert set(seen) == ({route} if route != "literal" else set())
    if route == "literal":
        g = torch.cat([xyz, feats], -1)[:, None]
        for layer in sa.mlps[0].layers():
            bn = layer.bn.bn
            if train:
                # train mode runs the layer in float64 and rounds its output
                # once (ConvBNReLU.forward)
                h = g.double() @ layer.conv.weight.double().t()
                rows = h.reshape(-1, h.shape[-1])
                mean = rows.sum(0) / rows.shape[0]
                var = torch.clamp_min((rows * rows).sum(0) / rows.shape[0]
                                      - mean * mean, 0)
            else:
                h = layer.conv(g)
                mean, var = bn.running_mean, bn.running_var
            g = torch.relu((h - mean) * (torch.rsqrt(var + bn.eps)
                                         * bn.weight) + bn.bias).float()
        assert torch.equal(out, g.amax(dim=2))


PNET_ARGS = dict(sa_n_points=[32, 16, None], sa_n_samples=[32, 32, None],
                 sa_radii=[0.2, 0.4, None],
                 sa_mlps=[[3, 32, 32, 64], [64, 64, 64, 128],
                          [128, 128, 128, 64]])


def test_pointnet_bf16_follows_jax_mixed_precision(monkeypatch):
    """The unfrozen PointNet++ in train mode under mixed precision: the JAX
    model after ``enable_mixed_precision`` against the port under
    ``torch.autocast("cpu", torch.bfloat16)``, same weights. Both return
    bf16. Tolerance 4 bf16 steps (2^-8 each) of max|jax|: both round at the
    same points (bf16 convs and fc, bf16 BatchNorm output), but the
    frameworks' bf16 matmuls accumulate in another order, so a value on a
    rounding boundary lands one step apart and BatchNorm's 1/std carries
    such steps through three levels and ``fc`` (measured 1.7 steps here,
    3.0 at worst over three seeds)."""
    from sceneverse_tpu.utils.precision import enable_mixed_precision
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    jm = jpn.PointNetPP(**PNET_ARGS, rngs=nnx.Rngs(0))
    jm.train()
    enable_mixed_precision(jm)
    tm = tpn.PointNetPP(**PNET_ARGS)
    missing, unexpected = tm.load_state_dict(from_jax_params(
        _flat(nnx.state(jm, nnx.Not(nnx.RngState)))), strict=False)
    assert [k for k in missing if "num_batches" not in k] == []
    assert unexpected == []
    tm.train()
    x = np.random.RandomState(6).randn(4, 256, 6).astype(np.float32)
    jout = jm(jnp.asarray(x))
    with torch.autocast("cpu", torch.bfloat16):
        tout = tm(torch.from_numpy(x))
    assert jout.dtype == jnp.bfloat16
    assert tout.dtype == torch.bfloat16
    jo = np.asarray(jout, np.float32)
    err = np.abs(tout.float().detach().numpy() - jo).max()
    assert err <= 4 * 2.0 ** -8 * np.abs(jo).max(), err

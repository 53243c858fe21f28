"""Port parity for the PointNet++ variant library (``PointnetSAModuleMSG``,
``PointnetSAModuleVotes``, ``PointnetSAModuleMSGVotes``,
``PointnetFPModule``, ``PointnetLFPModuleMSG``) and ``three_nn`` /
``three_interpolate``, mirroring ``tests/test_pointnet_variants.py`` and
``tests/test_pointops.py`` against the JAX package.

Setup: B = 2 clouds of 64 standard-normal points with 8 features, 16
centers, radii 0.5 / 1.0 (a few points a ball, some balls with one), the
JAX modules' own initialisation carried by ``from_jax_params`` (every
parameter lands, none is left, MSG's scales 1.. included), BatchNorm in
eval mode with random running statistics; the SharedMLP without BatchNorm
(``bn=False``: a conv bias) in the FP case that asks for it. Forward and
the gradients of a random projection of the outputs with respect to the
points, the features and every parameter, f32 on both sides: eval
BatchNorm makes no batch-order decision, and at these sizes no max-pool or
ReLU lies within f32 rounding of a tie (a flip would show as a gradient
far off, not as a small error).

Tolerances: FPS, ball-query and 3-NN indices exactly equal; values and
gradients max|port - jax| <= 1e-5 * max(1, max|jax|) (the same f32
formulas in another summation order). ``sample_uniformly``'s draws differ
from JAX's threefry stream by design, so it is held on its rule: every
slot a point of its ball's kept set, the kept slots unchanged, the count
``ret_unique_cnt`` returns.

``three_nn``'s distances carry no gradient in the port, as the reference's
CUDA op gives none; JAX differentiates through them (NaN where an unknown
point coincides with a known one, ROADMAP.md section C), so the FP
module's gradient with respect to the points is not compared (its
features' and parameters' are)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from test_torch_modules import carry, close
from test_torch_slice import _flat

B, N, C, M = 2, 64, 8, 16


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3).astype(np.float32),
            rng.randn(B, N, C).astype(np.float32))


def _set_bn_stats(jm, seed):
    """Random eval-mode running statistics on every JAX BatchNorm."""
    rng = np.random.RandomState(seed)
    for _, m in jm.iter_modules():
        if isinstance(m, nnx.BatchNorm):
            m.mean[...] = jnp.asarray(rng.randn(*m.mean.shape) * 0.2,
                                      jnp.float32)
            m.var[...] = jnp.asarray(rng.rand(*m.var.shape) + 0.5,
                                     jnp.float32)


def _pair(jcls, tcls, seed=0, **kw):
    jm = jcls(rngs=nnx.Rngs(seed), **kw)
    _set_bn_stats(jm, seed)
    tm = tcls(**kw)
    carry(jm, tm)
    return jm, tm


def _grads(jm, tm, jcall, tcall, arrays, grad_inputs, out_index=1):
    """Outputs and the gradients of sum(out * w) on both sides: (port
    outputs, jax outputs, [(port grad, jax grad) for each input in
    ``grad_inputs`` and each parameter])."""
    jouts = jcall(jm, *map(jnp.asarray, arrays))
    out = jouts[out_index] if isinstance(jouts, tuple) else jouts
    w = np.random.RandomState(9).randn(*out.shape).astype(np.float32)

    def loss(m, *a):
        o = jcall(m, *a)
        return jnp.sum((o[out_index] if isinstance(o, tuple) else o) * w)

    argnums = (0, *[1 + i for i in grad_inputs])
    jg = nnx.jit(nnx.grad(loss, argnums=argnums))(
        jm, *map(jnp.asarray, arrays))
    tin = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_inputs:
        tin[i].requires_grad_(True)
    touts = tcall(tm, *tin)
    tout = touts[out_index] if isinstance(touts, tuple) else touts
    (tout * torch.from_numpy(w)).sum().backward()
    pairs = [(tin[i].grad, jg[1 + k]) for k, i in enumerate(grad_inputs)]
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    jp = from_jax_params(_flat(nnx.state(jg[0], nnx.Param)))
    params = dict(tm.named_parameters())
    assert set(jp) == set(params)
    pairs += [(params[n].grad, jp[n]) for n in params]
    return touts, jouts, pairs


def _check(pairs):
    for got, want in pairs:
        assert got is not None
        close(got, want)


def test_sa_msg_matches_jax():
    from sceneverse_tpu.modules.layers.pointnet import PointnetSAModuleMSG as J
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetSAModuleMSG as Tm

    kw = dict(npoint=M, radii=[0.5, 1.0, 1.5], nsamples=[8, 16, 4],
              mlps=[[C, 16], [C, 32, 16], [C, 8]])
    jm, tm = _pair(J, Tm, 0, **kw)
    assert [k for k in dict(tm.named_parameters())
            if k.startswith("mlps.1.layer1.")]  # scales past 0 carried
    xyz, feats = _inputs(0)
    call = lambda m, x, f: m(x, f)
    t, j, pairs = _grads(jm, tm, call, call, (xyz, feats), (0, 1))
    assert t[1].shape == (B, M, 16 + 16 + 8)
    close(t[0].detach(), j[0])
    close(t[1].detach(), j[1])
    _check(pairs)


def test_sa_msg_group_all_matches_jax():
    from sceneverse_tpu.modules.layers.pointnet import PointnetSAModuleMSG as J
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetSAModuleMSG as Tm

    kw = dict(npoint=None, radii=[None, None], nsamples=[None, None],
              mlps=[[C, 16], [C, 8]])
    jm, tm = _pair(J, Tm, 1, **kw)
    xyz, feats = _inputs(1)
    call = lambda m, x, f: m(x, f)
    t, j, pairs = _grads(jm, tm, call, call, (xyz, feats), (0, 1))
    assert t[0] is None and t[1].shape == (B, 1, 24)
    close(t[1].detach(), j[1])
    _check(pairs)


VOTES = [("max", False, False), ("avg", True, False), ("rbf", True, True)]


@pytest.mark.parametrize(
    "pooling,normalize,given", VOTES,
    ids=[f"{p}{'-norm' if n else ''}{'-inds' if g else ''}"
         for p, n, g in VOTES])
def test_sa_votes_matches_jax(pooling, normalize, given):
    from sceneverse_tpu.modules.layers.pointnet import \
        PointnetSAModuleVotes as J
    from sceneverse_tpu.ops.pointops import furthest_point_sample
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetSAModuleVotes as Tm

    kw = dict(mlp=[C, 16, 16], npoint=M, radius=0.8, nsample=8,
              pooling=pooling, normalize_xyz=normalize)
    jm, tm = _pair(J, Tm, 2, **kw)
    xyz, feats = _inputs(2)
    inds = (np.random.RandomState(3).randint(0, N, (B, M)).astype(np.int32)
            if given else None)
    jcall = lambda m, x, f: m(x, f, inds=None if inds is None
                              else jnp.asarray(inds))
    tcall = lambda m, x, f: m(x, f, inds=None if inds is None
                              else torch.from_numpy(inds))
    t, j, pairs = _grads(jm, tm, jcall, tcall, (xyz, feats), (0, 1))
    want_inds = inds if given else np.asarray(
        furthest_point_sample(jnp.asarray(xyz), M))
    np.testing.assert_array_equal(t[2].numpy(), want_inds)
    np.testing.assert_array_equal(np.asarray(j[2]), want_inds)
    close(t[0].detach(), j[0])
    close(t[1].detach(), j[1])
    _check(pairs)


def test_sa_msg_votes_matches_jax():
    from sceneverse_tpu.modules.layers.pointnet import \
        PointnetSAModuleMSGVotes as J
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetSAModuleMSGVotes as Tm

    kw = dict(mlps=[[C, 16], [C, 16]], npoint=8, radii=[0.5, 1.0],
              nsamples=[4, 8])
    jm, tm = _pair(J, Tm, 4, **kw)
    xyz, feats = _inputs(4)
    call = lambda m, x, f: m(x, f)
    t, j, pairs = _grads(jm, tm, call, call, (xyz, feats), (0, 1))
    assert t[1].shape == (B, 8, 32)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    close(t[1].detach(), j[1])
    _check(pairs)


@pytest.mark.parametrize("known,bn", [(True, True), (True, False),
                                      (False, True)],
                         ids=["three-nn", "three-nn-no-bn", "broadcast"])
def test_fp_matches_jax(known, bn):
    from sceneverse_tpu.modules.layers.pointnet import PointnetFPModule as J
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetFPModule as Tm

    jm, tm = _pair(J, Tm, 5, mlp=[C + 4, 12, 12], bn=bn)
    assert (tm.mlps[0].layer0.bn is None) == (not bn)
    xyz, feats = _inputs(5)
    rng = np.random.RandomState(6)
    kxyz = xyz[:, ::4] + 0.01  # no unknown point is a known one
    kfeats = rng.randn(B, 16 if known else 1, 4).astype(np.float32)

    def call(m, u, uf, kf, k=kxyz):
        k = (jnp.asarray(k) if isinstance(u, jax.Array)
             else torch.from_numpy(k)) if known else None
        return m(u, k, uf, kf)

    t, j, pairs = _grads(jm, tm, call, call, (xyz, feats, kfeats), (1, 2),
                         out_index=0)
    assert t.shape == (B, N, 12)
    close(t.detach(), j)
    _check(pairs)


def test_lfp_msg_matches_jax():
    from sceneverse_tpu.modules.layers.pointnet import \
        PointnetLFPModuleMSG as J
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetLFPModuleMSG as Tm

    kw = dict(mlps=[[C, 16], [C, 16, 16]], radii=[0.8, 1.2],
              nsamples=[8, 4], post_mlp=[16 + 4, 24])
    jm, tm = _pair(J, Tm, 7, **kw)
    assert "post_mlp.layer0.bn.bn.weight" in dict(tm.named_parameters())
    xyz, feats = _inputs(7)
    xyz2 = xyz[:, :M] + 0.05
    feats2 = np.random.RandomState(8).randn(B, M, 4).astype(np.float32)
    call = lambda m, x2, x1, f2, f1: m(x2, x1, f2, f1)
    t, j, pairs = _grads(jm, tm, call, call, (xyz2, xyz, feats2, feats),
                         (0, 1, 2, 3), out_index=0)
    assert t.shape == (B, M, 48)
    close(t.detach(), j)
    _check(pairs)


def test_three_nn_matches_jax_with_ties():
    """Indices exactly (a duplicated known point: the lower index first, as
    ``lax.top_k`` orders equal values), distances to 1e-5."""
    from sceneverse_tpu.ops.pointops import three_nn as jnn
    from sceneverse_tpu_torch.ops.pointops import three_nn as tnn

    rng = np.random.RandomState(11)
    unknown = rng.randn(B, 20, 3).astype(np.float32)
    known = rng.randn(B, 10, 3).astype(np.float32)
    known[:, 7] = known[:, 2]  # an exact tie
    unknown[:, 0] = known[:, 2]  # at distance 0 from both copies
    jd, ji = jnn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = tnn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[:, 0, :2].numpy() == [2, 7]).all()
    close(td, jd)


def test_three_interpolate_matches_jax_with_grads():
    from sceneverse_tpu.ops.pointops import three_interpolate as jti
    from sceneverse_tpu_torch.ops.pointops import three_interpolate as tti

    rng = np.random.RandomState(12)
    feats = rng.randn(B, 10, 6).astype(np.float32)
    idx = rng.randint(0, 10, (B, 20, 3)).astype(np.int32)
    weight = rng.rand(B, 20, 3).astype(np.float32)
    w = rng.randn(B, 20, 6).astype(np.float32)
    jout, jgrads = jax.value_and_grad(
        lambda f, wt: jnp.sum(jti(f, jnp.asarray(idx), wt) * w),
        argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(weight))
    tf = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(weight).requires_grad_(True)
    out = (tti(tf, torch.from_numpy(idx), tw) * torch.from_numpy(w)).sum()
    out.backward()
    close(out.detach(), jout)
    close(tf.grad, jgrads[0])
    close(tw.grad, jgrads[1])


def test_sample_uniformly_refills_pads_by_the_rule():
    """Every slot holds a point of its ball's first min(hits, S) points, the
    slots below that count keep ball query's, a generator replays its draws,
    and ``ret_unique_cnt`` is min(hits, S)."""
    from sceneverse_tpu_torch.modules.layers.pointnet import (
        PointnetSAModuleVotes, _query_group)
    from sceneverse_tpu_torch.ops.pointops import ball_query

    xyz, _ = (torch.from_numpy(a) for a in _inputs(13))
    centers = xyz[:, :M]
    r, S = 0.8, 8
    idx0 = ball_query(r, S, xyz, centers)
    d2 = ((xyz[:, None] - centers[:, :, None]) ** 2).sum(-1)
    cnt = (d2 < r * r).sum(-1).clamp(1, S)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        _, gxyz = _query_group(xyz, centers, None, r, S, True,
                               sample_uniformly=True, generator=g)
        pts = gxyz + centers[:, :, None]
        # recover each slot's point: the nearest point of the cloud
        idx = torch.cdist(pts.reshape(B, -1, 3), xyz).argmin(-1).reshape(
            B, M, S)
        draws.append(idx)
        for b in range(B):
            for m in range(M):
                kept = set(idx0[b, m, :cnt[b, m]].tolist())
                assert set(idx[b, m].tolist()) <= kept
                assert idx[b, m, :cnt[b, m]].tolist() == \
                    idx0[b, m, :cnt[b, m]].tolist()
    assert torch.equal(draws[0], draws[1])
    assert (cnt < S).any()  # some balls had pads to refill
    sa = PointnetSAModuleVotes(mlp=[0, 8], npoint=M, radius=r, nsample=S,
                               sample_uniformly=True, ret_unique_cnt=True)
    sa.eval()
    _, out, _, got = sa(xyz, None)
    centers = xyz.gather(1, _[..., None].long().expand(-1, -1, 3))
    d2 = ((xyz[:, None] - centers[:, :, None]) ** 2).sum(-1)
    assert torch.equal(got, (d2 < r * r).sum(-1).clamp_max(S).int())
    assert out.shape == (B, M, 8) and got.dtype == torch.int32
    with pytest.raises(ValueError):
        PointnetSAModuleVotes(mlp=[0, 8], npoint=M, radius=r, nsample=S,
                              ret_unique_cnt=True)


def test_three_nn_distances_carry_no_gradient():
    """The FP weights take no gradient through ``three_nn``'s distances in
    the port (the reference's CUDA op has none); JAX differentiates through
    them and its point gradients are NaN where an unknown point is a known
    one, as in every FP level whose known points were sampled from its
    unknown ones (ROADMAP.md section C)."""
    from sceneverse_tpu.ops import pointops as jp
    from sceneverse_tpu_torch.ops import pointops as tp

    rng = np.random.RandomState(14)
    unknown = rng.randn(1, 6, 3).astype(np.float32)
    known = unknown[:, :3].copy()
    feats = rng.randn(1, 3, 4).astype(np.float32)

    def jloss(u, k):
        d, i = jp.three_nn(u, k)
        r = 1.0 / (d + 1e-8)
        return jp.three_interpolate(jnp.asarray(feats), i,
                                    r / r.sum(2, keepdims=True)).sum()

    gu, gk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(unknown),
                                            jnp.asarray(known))
    assert np.isnan(np.asarray(gu)).any() and np.isnan(np.asarray(gk)).any()
    u = torch.from_numpy(unknown).requires_grad_(True)
    d, i = tp.three_nn(u, torch.from_numpy(known))
    assert not d.requires_grad and i.dtype == torch.int32
    np.testing.assert_array_equal(d[0, :3, 0].numpy(), 0.0)


CARRIED = {
    "PointnetSAModuleMSG": dict(npoint=4, radii=[0.5, 1.0, 2.0],
                                nsamples=[4, 8, 8],
                                mlps=[[C, 8], [C, 8, 8], [C, 4]]),
    "PointnetSAModuleVotes": dict(mlp=[C, 8, 8], npoint=4, radius=0.5,
                                  nsample=4),
    "PointnetSAModuleMSGVotes": dict(mlps=[[C, 8], [C, 8]], npoint=4,
                                     radii=[0.5, 1.0], nsamples=[4, 8]),
    "PointnetFPModule": dict(mlp=[C, 8, 8], bn=False),
    "PointnetLFPModuleMSG": dict(mlps=[[C, 8], [C, 8]], radii=[0.5, 1.0],
                                 nsamples=[4, 8], post_mlp=[8, 8]),
    "EntitySpatialCrossEncoder": dict(hidden_size=32, num_attention_heads=4,
                                      num_layers=2),
    "UnifiedSpatialCrossEncoderV1": dict(hidden_size=32,
                                         num_attention_heads=4,
                                         num_layers=2),
    "CLIPLanguageEncoder": dict(output_dim=768, num_hidden_layers=1,
                                use_projection=True),
}


@pytest.mark.parametrize("name", list(CARRIED))
def test_from_jax_params_carries_every_variant_module(name):
    """Every JAX parameter (and BatchNorm statistic) of each new module
    lands on a tensor of the port's module of the same name, with the
    same shape; none is unexpected and none of the port's is left."""
    import importlib

    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    where = {"EntitySpatialCrossEncoder": "grounding.unified_encoder",
             "UnifiedSpatialCrossEncoderV1": "grounding.unified_encoder",
             "CLIPLanguageEncoder": "language.clip"}.get(
        name, "layers.pointnet")
    jcls = getattr(importlib.import_module(
        f"sceneverse_tpu.modules.{where}"), name)
    tcls = getattr(importlib.import_module(
        f"sceneverse_tpu_torch.modules.{where}"), name)
    abstract = nnx.eval_shape(lambda: jcls(rngs=nnx.Rngs(0),
                                           **CARRIED[name]))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            nnx.state(abstract, nnx.Not(nnx.RngState)))[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path]
        flat[".".join(names[:-1] if names[-1] == "value" else names)] = \
            np.zeros(leaf.shape, np.float32)
    got = from_jax_params(flat)
    own = {k: v for k, v in tcls(**CARRIED[name]).state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(own), (set(got) ^ set(own))
    for k, v in got.items():
        assert tuple(v.shape) == tuple(own[k].shape), k

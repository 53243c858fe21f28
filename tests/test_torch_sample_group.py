"""Port parity for the trainable SA front end: the sceneverse_tpu_torch
``fused_sample_and_group`` / ``sample_and_group`` (plain twins on the CPU)
against the JAX package's Pallas kernel in interpret mode and its custom
VJP, on numpy-seeded inputs.

Tolerances: FPS and ball-query indices identical. ``grouped`` and
``new_xyz`` within rtol 1e-6 in exact mode (a one-hot gather and one f32
subtraction on both sides) and within one bf16 rounding step (2^-8
relative) in fast mode. Gradients within 1e-5 * max|grad|: both sides
scatter-add the same cotangents, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sceneverse_tpu.ops.pallas.sample_group import (
    fused_sample_and_group as jax_fused,
    sample_and_group as jax_sample_and_group,
)
from sceneverse_tpu_torch.ops.sample_group import (
    fused_sample_and_group,
    sample_and_group,
    sample_and_group_plain,
)

SHAPES = [(3, 64, 6, 8, 4, 0.7), (2, 128, 6, 16, 8, 0.5)]


def _points(kind, G, N, C, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(G, N, C).astype(np.float32)
    if kind == "origin_pad":
        pts += 3.0
        pts[:, N * 5 // 8:, :3] = 0.0  # near-origin points: never FPS picks
    elif kind == "all_pad":
        pts[-1, :, :3] = 0.0  # an object made of padding only
    return pts


CASES = [(kind, *shape, exact)
         for kind in ("random", "origin_pad", "all_pad")
         for shape in SHAPES for exact in (True, False)]


@pytest.mark.parametrize("kind,G,N,C,m,ns,r,exact", CASES)
def test_fused_sample_and_group_matches_jax(kind, G, N, C, m, ns, r, exact):
    pts = _points(kind, G, N, C)
    want = [np.asarray(a) for a in jax_fused(
        jnp.asarray(pts), m, ns, r, interpret=True, exact=exact)]
    got = [a.numpy() for a in fused_sample_and_group(
        torch.from_numpy(pts), m, ns, r, exact)]
    names = ["grouped", "new_xyz", "fps_idx", "bq_idx"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    rtol = 1e-6 if exact else 2.0 ** -8
    np.testing.assert_allclose(got[0], want[0], rtol=rtol,
                               atol=rtol * np.abs(pts).max())
    if kind == "origin_pad":
        assert (got[2] < N * 5 // 8).all()
    if kind == "all_pad":
        assert (got[2][-1] == 0).all()


@pytest.mark.parametrize("G,N,C,m,ns,r", SHAPES)
@pytest.mark.parametrize("exact", [True, False])
def test_sample_and_group_backward_matches_jax_vjp(G, N, C, m, ns, r, exact):
    rng = np.random.RandomState(1)
    pts = _points("random", G, N, C)
    dg = rng.randn(G, m, ns, C).astype(np.float32)
    dn = rng.randn(G, m, 3).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p: jax_sample_and_group(p, m, ns, r, exact, True),
        jnp.asarray(pts))
    want = np.asarray(vjp((jnp.asarray(dg), jnp.asarray(dn)))[0])
    tp = torch.from_numpy(pts).requires_grad_(True)
    grouped, new_xyz = sample_and_group(tp, m, ns, r, exact)
    torch.autograd.backward([grouped, new_xyz],
                            [torch.from_numpy(dg), torch.from_numpy(dn)])
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(tp.grad.numpy() - want).max() <= 1e-5 * scale


def test_fast_mode_is_exact_mode_rounded_to_bf16():
    pts = torch.from_numpy(_points("random", 2, 128, 6))
    exact = sample_and_group_plain(pts, 16, 8, 0.5, True)
    fast = sample_and_group_plain(pts, 16, 8, 0.5, False)
    assert torch.equal(exact[2], fast[2]) and torch.equal(exact[3], fast[3])
    rel = ((fast[0] - exact[0]).abs().max() / pts.abs().max()).item()
    assert 0 < rel <= 2.0 ** -8

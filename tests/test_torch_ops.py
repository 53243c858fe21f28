"""Port parity: plain-torch point ops and pairwise geometry against
sceneverse_tpu.ops (JAX, CPU). Indices must match exactly; calc_pairwise_locs
to 1e-6 (same f32 formulas, only the 3-term reduction order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sceneverse_tpu.ops import geometry as jgeo
from sceneverse_tpu.ops import pointops as jpo
from sceneverse_tpu_torch.ops import geometry as tgeo
from sceneverse_tpu_torch.ops import pointops as tpo


def _pts(seed, B=3, N=96, C=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    x[:, 7:11, :3] = 1e-3  # near-origin pads
    return x


@pytest.mark.parametrize("npoint", [1, 8, 32])
def test_fps_exact_indices(npoint):
    x = _pts(0)
    want = np.asarray(jpo.furthest_point_sample(jnp.asarray(x), npoint))
    got = tpo.furthest_point_sample(torch.tensor(x), npoint).numpy()
    np.testing.assert_array_equal(got, want)


def _fps_edge(kind, N, seed=3):
    """Three objects of N points; the last is all padding (FPS repeats
    index 0). "grid": coordinates on a coarse grid, so that many distances
    tie and, at npoint = N, most steps pick among zero distances."""
    rng = np.random.RandomState(seed)
    if kind == "grid":
        x = (rng.randint(-2, 3, size=(3, N, 3)) * 0.5).astype(np.float32)
    else:
        x = rng.randn(3, N, 3).astype(np.float32)
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("npoint", ["one", "all"])
@pytest.mark.parametrize("N", [17, 1000])
@pytest.mark.parametrize("kind", ["randn", "grid"])
def test_fps_plain_edge_cases_match_jax(kind, N, npoint):
    """``fps_plain`` (the twin the ``fps`` kernel is held to bit for bit)
    against JAX ``furthest_point_sample``: N no multiple of 32, npoint 1 and
    N, ties and an all-pad object."""
    from sceneverse_tpu_torch.ops.sa_forward import fps_plain

    x = _fps_edge(kind, N)
    m = 1 if npoint == "one" else N
    want = np.asarray(jpo.furthest_point_sample(jnp.asarray(x), m))
    ctr, idx = fps_plain(torch.tensor(x), m)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        ctr.numpy(), np.asarray(jpo.gather_points(jnp.asarray(x),
                                                  jnp.asarray(want))))
    assert (want[-1] == 0).all()


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.8, 16), (2.0, 128)])
def test_ball_query_and_grouping_exact(radius, nsample):
    x = _pts(1)
    feats = np.random.RandomState(2).randn(*x.shape[:2], 5).astype(np.float32)
    centers = x[:, ::6]
    want = np.asarray(jpo.ball_query(radius, nsample, jnp.asarray(x),
                                     jnp.asarray(centers)))
    got = tpo.ball_query(radius, nsample, torch.tensor(x),
                         torch.tensor(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    gw = np.asarray(jpo.group_points(jnp.asarray(feats), jnp.asarray(want)))
    gt = tpo.group_points(torch.tensor(feats), torch.tensor(got)).numpy()
    np.testing.assert_array_equal(gt, gw)
    idx = np.asarray(jpo.furthest_point_sample(jnp.asarray(x), 4))
    np.testing.assert_array_equal(
        tpo.gather_points(torch.tensor(feats), torch.tensor(idx)).numpy(),
        np.asarray(jpo.gather_points(jnp.asarray(feats), jnp.asarray(idx))))


def test_calc_pairwise_locs_center():
    rng = np.random.RandomState(4)
    c = rng.randn(2, 9, 3).astype(np.float32)
    c[1, 3] = c[1, 2]  # coincident objects: the eps path
    want = np.asarray(jgeo.calc_pairwise_locs(jnp.asarray(c), None))
    got = tgeo.calc_pairwise_locs(torch.tensor(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

"""The premise of the SA kernel's compaction (``sv_sa_fwd``, behind both
``sa_group_mlp_pool`` and ``sa_dense_pool``), on the CPU: the in-ball
(center, point) pairs alone, listed center-major, through layer 1 with
each branch's affine, ``_mlp23`` and a per-center segment max give

  * the plain twins ``sa_dense_pool_plain`` and ``sa_group_mlp_pool_plain``
    bit for bit (the same per-row arithmetic on fewer rows), and
  * the JAX Pallas kernels ``_kernel_dense_batched`` and ``_kernel``
    (interpret mode) within 1e-2 * max|pooled|, the tolerance and reason
    of ``test_torch_sa_forward.py``.

Cases: SA2 widths (131 -> 128, 128, 256) with empty balls (radius 0:
``d2 < 0`` holds for no point, so every ball takes pair (c, 0)) and with
balls that hold every point; SA1 widths with more in-ball points than
nsample. ``compact_sa_plain`` is a test-only function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sceneverse_tpu.ops.pallas import sa_forward as jsa
from sceneverse_tpu_torch.ops import sa_forward as tsa
from sceneverse_tpu_torch.ops.pointops import _sq3
from test_torch_sa_forward import _points, _weights


def compact_sa_plain(pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3,
                     radius, nsample):
    """The kernel's plan in plain PyTorch: each center's first
    min(nsample, N) in-ball points (strict d2 < r^2) in index order, pair
    (c, 0) for an empty ball, the pairs center-major through the MLP, then
    the max over each center's rows."""
    G, N, _ = pts.shape
    m = centers.shape[1]
    pw, cw1 = tsa._layer1(pts, centers, w1n)
    d = pts[:, None, :, :3] - centers[:, :, None, :]
    d2 = _sq3(d[..., 0], d[..., 1], d[..., 2])  # (G, m, N)
    within = d2 < torch.tensor(radius * radius, dtype=torch.float32)
    keep = within & (within.cumsum(-1) <= min(nsample, N))
    keep[..., 0] |= ~within.any(-1)
    gi, ci, pi = keep.nonzero(as_tuple=True)  # center-major
    if nsample >= N:  # dense branch
        u = a1 * (pw[gi, pi] - cw1[gi, ci]) + b1
    else:
        u = a1 * pw[gi, pi] + (b1 - a1 * cw1[gi, ci])
    h3 = tsa._mlp23(tsa._bf16(torch.relu(u)), w2n, a2, b2, w3n, a3, b3)
    out = torch.zeros((G * m, h3.shape[1]))
    out.scatter_reduce_(0, (gi * m + ci)[:, None].expand_as(h3), h3, "amax",
                        include_self=False)
    return out.view(G, m, -1), int(keep.sum())


CASES = {
    # name: (G, N, C, npoint, nsample, radius, xyz scale, spec)
    "sa2": (8, 32, 131, 16, 32, 0.4, 0.3, [131, 128, 128, 256]),
    "sa2_empty": (8, 32, 131, 16, 32, 0.0, 0.3, [131, 128, 128, 256]),
    "sa2_all_in": (8, 32, 131, 16, 32, 50.0, 0.3, [131, 128, 128, 256]),
    "sa1_truncated": (8, 256, 6, 32, 8, 0.5, 0.5, [6, 64, 64, 128]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compaction_matches_plain_twins_and_jax(name, monkeypatch):
    G, N, C, m, ns, r, sc, spec = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name) + 11)
    pts = _points(rng, G, N, C, sc)
    ws = _weights(rng, spec)
    dense = ns >= N
    ran = []
    kname = "_kernel_dense_batched" if dense else "_kernel"
    kern = getattr(jsa, kname)
    monkeypatch.setattr(jsa, kname,
                        lambda *a, **k: ran.append(1) or kern(*a, **k))
    jp, jx = jsa.fused_sa_forward(jnp.asarray(pts), m, ns, r,
                                  *map(jnp.asarray, ws), interpret=True,
                                  block_objects=G, split_fps=True,
                                  dense_batched=dense)
    assert ran  # JAX ran the kernel named, not a fallback
    centers = torch.tensor(np.asarray(jx))
    tp = torch.tensor(pts)
    ops = tsa.prepare_weights(*map(torch.tensor, ws))
    got, rows = compact_sa_plain(tp, centers, *ops, radius=r, nsample=ns)
    want = tsa.sa_group_mlp_pool_plain(tp, centers, *ops, radius=r,
                                       nsample=ns)
    assert torch.equal(got, want)
    if dense:
        assert torch.equal(got, tsa.sa_dense_pool_plain(tp, centers, *ops,
                                                        radius=r))
    jp = np.asarray(jp)
    assert np.abs(got.numpy() - jp).max() <= 1e-2 * np.abs(jp).max()
    # what each case exercises: the rows the compaction keeps
    d = tp[:, None, :, :3] - centers[:, :, None, :]
    inball = (_sq3(d[..., 0], d[..., 1], d[..., 2]) < r * r).sum(-1)
    if name == "sa2_empty":
        assert (inball == 0).all() and rows == G * m
    elif name == "sa2_all_in":
        assert (inball == N).all() and rows == G * m * N
    elif name == "sa1_truncated":
        assert (inball > ns).any() and rows == int(inball.clamp(1, ns).sum())
    else:
        assert 0 < rows < G * m * N // 2

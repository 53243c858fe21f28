"""Point-cloud sampling and grouping ops in plain PyTorch (channels-last).

Port of ``sceneverse_tpu/ops/pointops.py`` with the same CUDA-reference
semantics; these are the oracle for FPS and grouping (the fused SA kernel in
``ops/sa_forward.py`` is held against the same rules):

  * FPS: ``idx[0] = 0``; points with ``|p|^2 <= 1e-3`` are never candidates;
    min-distance initialised to 1e10; ties go to the lowest index.
  * ball query: strict ``d2 < r^2``, the first ``nsample`` hits in index
    order, slots past the hit count padded with the first hit, all zeros for
    an empty ball.
  * three_nn: the 3 nearest known points, nearer first, ties to the lower
    index (``lax.top_k``'s order); ``three_interpolate`` the weighted sum of
    their features, differentiable through the gather.
"""

from __future__ import annotations

import torch


def _sq3(dx, dy, dz):
    """((dx^2 + dy^2) + dz^2) as separate rounded ops (no fused multiply-add),
    the order the JAX ops and the CUDA kernels use."""
    return (dx * dx + dy * dy) + dz * dz


@torch.no_grad()
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices (sceneverse_tpu pointops.py:35)."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = _sq3(x, y, z) > 1e-3
    mindist = torch.full((B, N), 1e10, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    old = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        last = xyz[rows, old]  # (B, 3)
        d = _sq3(x - last[:, 0:1], y - last[:, 1:2], z - last[:, 2:3])
        mindist = torch.where(valid, torch.minimum(mindist, d), mindist)
        cand = torch.where(valid, mindist, torch.full_like(mindist, -1.0))
        old = torch.argmax(cand, dim=1)  # first max = lowest index
        idxs[:, j] = old.to(torch.int32)
    return idxs


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(
        *idx.shape, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    flat = gather_points(points, idx.reshape(B, M * S))
    return flat.reshape(B, M, S, points.shape[-1])


@torch.no_grad()
def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` in-ball indices in index order, padded with the first
    hit (sceneverse_tpu pointops.py:142). (B, N, 3), (B, M, 3) -> (B, M, S)."""
    N = xyz.shape[1]
    diff = new_xyz[:, :, None, :] - xyz[:, None, :, :]
    d2 = _sq3(diff[..., 0], diff[..., 1], diff[..., 2])  # (B, M, N)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    within = d2 < r2
    order = torch.arange(N, device=xyz.device, dtype=torch.int32)
    key = torch.where(within, order, order + N)
    k = min(nsample, N)
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx >= N, idx - N, idx)
    count = within.sum(-1, dtype=torch.int32)
    first = idx[..., :1]
    if k < nsample:
        idx = torch.cat([idx, first.expand(*first.shape[:-1], nsample - k)], -1)
    slots = torch.arange(nsample, device=xyz.device, dtype=torch.int32)
    filled = slots[None, None, :] < count[..., None]
    return torch.where(filled, idx, first).to(torch.int32)


@torch.no_grad()
def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, n, 3), (B, m, 3) -> (sqrt distances (B, n, 3), int32 indices
    (B, n, 3)) of each unknown point's 3 nearest known points (sceneverse_tpu
    pointops.py:185): three passes of a first-minimum argmin, so equal
    distances go to the lower index as ``lax.top_k`` orders them."""
    diff = unknown[:, :, None, :] - known[:, None, :, :]
    d2 = _sq3(diff[..., 0], diff[..., 1], diff[..., 2])  # (B, n, m)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, torch.inf)
    dist = torch.cat(dists, -1)
    return (torch.sqrt(torch.clamp_min(dist, 0.0)),
            torch.cat(idxs, -1).to(torch.int32))


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C) features, (B, n, 3) indices and weights -> (B, n, C): the
    weighted sum of the 3 gathered rows (sceneverse_tpu pointops.py:205)."""
    return torch.sum(group_points(features, idx) * weight[..., None], dim=2)

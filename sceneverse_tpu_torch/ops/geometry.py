"""Pairwise spatial features for the spatial attention (port of
``sceneverse_tpu/ops/geometry.py``): [norm-dist, dz/dist, dist2d/dist,
dy/dist2d, dx/dist2d] with per-scene max-distance normalisation, in the
'center' and 'vertical_bottom' modes, and the raw (center, size) pairs of
the 'mlp' mode."""

from __future__ import annotations

import torch


def _dists(locs, eps):
    """(sqrt(|d|^2 + eps), sqrt(|d_xy|^2 + eps)) of (B, L, L, 3) offsets."""
    return (torch.sqrt(torch.sum(locs * locs, dim=3) + eps),
            torch.sqrt(torch.sum(locs[..., :2] * locs[..., :2], dim=3) + eps))


def calc_pairwise_locs(obj_centers: torch.Tensor, obj_whls=None,
                       eps: float = 1e-10, pairwise_rel_type: str = "center",
                       spatial_dist_norm: bool = True,
                       spatial_dim: int = 5) -> torch.Tensor:
    """(B, L, 3) centers [(B, L, 3) box sizes] -> (B, L, L, spatial_dim), or
    (B, L, L, 12) for 'mlp' (both objects' centers and sizes)."""
    if pairwise_rel_type == "mlp":
        obj_locs = torch.cat([obj_centers, obj_whls], dim=2)  # (B, L, 6)
        L = obj_locs.shape[1]
        return torch.cat([obj_locs[:, :, None].expand(-1, -1, L, -1),
                          obj_locs[:, None].expand(-1, L, -1, -1)], dim=3)
    if pairwise_rel_type not in ("center", "vertical_bottom"):
        raise NotImplementedError(
            f"unsupported pairwise_rel_type {pairwise_rel_type}")
    locs = obj_centers[:, :, None, :] - obj_centers[:, None, :, :]
    dists, dists_2d = _dists(locs, eps)
    if spatial_dist_norm:
        max_d = torch.amax(dists.reshape(dists.shape[0], -1), dim=1)
        norm_d = dists / max_d[:, None, None]
    else:
        norm_d = dists
    if spatial_dim == 1:
        return norm_d[..., None]
    if pairwise_rel_type == "center":
        vert, vert_d, vert_d2 = locs, dists, dists_2d
    else:  # the vertical terms from the boxes' bottom centers
        bottom = obj_centers.clone()
        bottom[:, :, 2] = obj_centers[:, :, 2] - obj_whls[:, :, 2]
        vert = bottom[:, :, None, :] - bottom[:, None, :, :]
        vert_d, vert_d2 = _dists(vert, eps)
    feats = torch.stack([
        norm_d,
        vert[..., 2] / vert_d,
        vert_d2 / vert_d,
        locs[..., 1] / dists_2d,
        locs[..., 0] / dists_2d,
    ], dim=3)
    if spatial_dim == 4:
        feats = feats[..., 1:]
    return feats


def calc_pairwise_locs_mv(obj_centers: torch.Tensor,
                          pairwise_rel_type: str = "center",
                          spatial_dist_norm: bool = True,
                          spatial_dim: int = 5) -> torch.Tensor:
    """Multi-view variant (reference modules/utils.py:89-114): centers
    only."""
    return calc_pairwise_locs(obj_centers, None,
                              pairwise_rel_type=pairwise_rel_type,
                              spatial_dist_norm=spatial_dist_norm,
                              spatial_dim=spatial_dim)

"""PointNet++ encoder, frozen and trainable routes.

Port of sceneverse_tpu/modules/layers/pointnet.py. Module names follow the
original SceneVerse torch state dict (``encoder.N.mlps.0.layerK.conv``,
``.bn.bn``), so converted checkpoints load by name.

Frozen route (``set_fused_frozen``; eval BatchNorm, no gradients): SA levels
with a sample count run through the fused SA kernels (``ops/sa_forward.py``,
:266-301 there); the GroupAll level runs the folded bf16-operand /
f32-accumulate matmul chain of :307-333.

Trainable route (the JAX package's default gates, :335-402 there): SA1
(N >= 256) samples and groups through ``ops/sample_group.py``; smaller
levels (SA2) take plain point ops, with FPS indices from the ``fps`` kernel
and ``torch.gather`` carrying the feature gradient; GroupAll is one
``(B, 1, N, C)`` group. Every level then runs the literal f32
Linear -> BatchNorm -> ReLU chain and a max over the samples.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from sceneverse_tpu_torch.ops.pointops import (ball_query, gather_points,
                                              group_points)
from sceneverse_tpu_torch.ops.sa_forward import (_bf16, fold_shared_mlp, fps,
                                                fused_sa_forward)
from sceneverse_tpu_torch.ops.sample_group import sample_and_group


class _BatchNorm(nn.Module):
    """``bn.bn`` nesting of the reference's BatchNorm2d wrapper."""

    def __init__(self, dim: int):
        super().__init__()
        self.bn = nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """flax ``nnx.BatchNorm`` over every axis but the last.

        Train mode normalises with the batch's biased variance in flax's
        fast form, ``max(E[h^2] - E[h]^2, 0)``, and moves the running
        statistics by ``0.9 * old + 0.1 * batch`` with that same biased
        variance (``torch.nn.BatchNorm1d`` would store the unbiased one), so
        the update is written out here. Eval mode uses the running
        statistics."""
        bn = self.bn
        if bn.training:
            rows = h.reshape(-1, h.shape[-1])
            mean = rows.mean(0)
            var = torch.clamp_min((rows * rows).mean(0) - mean * mean, 0.0)
            with torch.no_grad():
                bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
                bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
                bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean, bn.running_var
        return (h - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class ConvBNReLU(nn.Module):
    """1x1 conv (no bias, BN follows) + BatchNorm + ReLU."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.conv = nn.Linear(din, dout, bias=False)
        self.bn = _BatchNorm(dout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    def __init__(self, spec: List[int]):
        super().__init__()
        for i in range(len(spec) - 1):
            self.add_module(f"layer{i}", ConvBNReLU(spec[i], spec[i + 1]))

    def layers(self):
        return list(self.children())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction; ``npoint=None`` is GroupAll."""

    def __init__(self, *, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], mlp: List[int], use_xyz: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz = use_xyz
        self.fused_frozen = False
        spec = list(mlp)
        if use_xyz:
            spec[0] += 3
        self.mlps = nn.ModuleList([SharedMLP(spec)])

    def _cat(self, xyz, features):
        if features is not None and self.use_xyz:
            return torch.cat([xyz, features], -1)
        return features if features is not None else xyz

    @staticmethod
    def _points(xyz, features):
        """xyz-first points for the sampling front ends."""
        return torch.cat([xyz, features], -1) if features is not None else xyz

    def forward(self, xyz, features):
        if self.fused_frozen:
            with torch.no_grad():
                return self._frozen(xyz, features)
        if self.npoint is not None and xyz.shape[1] >= 256:
            # grouped in f32, as the kernel computes it (exact mode, the JAX
            # package's default); the MLP runs in the points' type
            grouped, new_xyz = (t.to(xyz.dtype) for t in sample_and_group(
                self._points(xyz, features), self.npoint, self.nsample,
                self.radius))
            if not self.use_xyz and features is not None:
                grouped = grouped[..., 3:]
        elif self.npoint is not None:
            _, fps_idx = fps(xyz.detach().contiguous(), self.npoint)
            new_xyz = gather_points(xyz, fps_idx)
            idx = ball_query(self.radius, self.nsample, xyz.detach(),
                             new_xyz.detach())
            grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                feats = group_points(features, idx)
                grouped = (torch.cat([grouped_xyz, feats], -1)
                           if self.use_xyz else feats)
            else:
                grouped = grouped_xyz
        else:
            new_xyz = None
            grouped = self._cat(xyz, features)[:, None]  # (B, 1, N, C)
        return new_xyz, self.mlps[0](grouped).amax(dim=2)

    def _frozen(self, xyz, features):
        layers = fold_shared_mlp(self.mlps[0])
        if self.npoint is not None:
            if len(layers) != 3:
                raise NotImplementedError("fused SA needs a 3-layer MLP")
            (w1, s1), (w2, s2), (w3, s3) = layers
            pooled, new_xyz = fused_sa_forward(
                self._points(xyz, features), self.npoint, self.nsample,
                self.radius, w1, s1, w2, s2, w3, s3)
            return new_xyz, pooled
        # GroupAll: folded bf16-operand / f32-accumulate matmul chain
        g = self._cat(xyz, features)
        B, N, C = g.shape
        h = g.reshape(B * N, C).float()
        for li, (w, ab) in enumerate(layers):
            y = _bf16(h) @ _bf16(w).t()
            h = torch.relu(y * ab[:, 0] + ab[:, 1])
            if li + 1 < len(layers):
                h = _bf16(h)
        return None, h.reshape(B, N, -1).amax(dim=1, keepdim=True)


class PointNetPP(nn.Module):
    """(B, P, 3 + C) point clouds -> (B, D) embeddings
    (reference modules/layers/pointnet.py:22-63)."""

    def __init__(self, sa_n_points: list, sa_n_samples: list, sa_radii: list,
                 sa_mlps: list, use_xyz: bool = True):
        super().__init__()
        self.encoder = nn.ModuleList([
            PointnetSAModule(npoint=p, radius=r, nsample=s, mlp=m,
                             use_xyz=use_xyz)
            for p, s, r, m in zip(sa_n_points, sa_n_samples, sa_radii, sa_mlps)
        ])
        out_n = sa_n_points[-1] if sa_n_points[-1] is not None else 1
        self.fc = nn.Linear(out_n * sa_mlps[-1][-1], sa_mlps[-1][-1])

    def set_fused_frozen(self):
        """Route every level through the frozen kernels (valid only with
        eval BatchNorm and no gradients: the GPS freeze configuration)."""
        for sa in self.encoder:
            sa.fused_frozen = True

    def forward(self, features):
        with torch.autocast(features.device.type, enabled=False):
            features = features.float()
            xyz = features[..., :3].contiguous()
            feats = features[..., 3:] if features.shape[-1] > 3 else None
            for sa in self.encoder:
                xyz, feats = sa(xyz, feats)
            return self.fc(feats.reshape(feats.shape[0], -1))

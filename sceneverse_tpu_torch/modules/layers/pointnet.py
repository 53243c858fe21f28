"""PointNet++ encoder, frozen and trainable routes.

Port of sceneverse_tpu/modules/layers/pointnet.py. Module names follow the
original SceneVerse torch state dict (``encoder.N.mlps.0.layerK.conv``,
``.bn.bn``), so converted checkpoints load by name.

Frozen route (``set_fused_frozen``; eval BatchNorm, no gradients): SA levels
with a sample count run through the fused SA kernels (``ops/sa_forward.py``,
:266-301 there), SA2 through the dense stage ``sa_dense_pool`` when
``SCENEVERSE_SA2_BATCHED`` is on; the GroupAll level runs the folded
bf16-operand / f32-accumulate matmul chain of :307-333.

Trainable route (:335-402 there): SA1 (N >= 256) samples and groups through
``ops/sample_group.py``, in the fast mode (bf16-rounded gather) when
``SCENEVERSE_PALLAS_FAST`` was set as the module was built; smaller levels (SA2) take plain point ops, with FPS
indices from the ``fps`` kernel and ``torch.gather`` carrying the feature
gradient; GroupAll is one ``(B, 1, N, C)`` group. The SharedMLP then runs
one of three ways, chosen at call time by the JAX package's gates
(``_bn_fold_enabled``, ``_sa_train_fused_enabled``, :76-115 there):
  * both off (the default): the literal Linear -> BatchNorm -> ReLU chain
    and a max over the samples;
  * ``SCENEVERSE_BN_FOLD=on``: train-mode BatchNorm folded analytically
    into the conv epilogue (``ConvBNReLU._folded``);
  * both on, in train mode, at shapes ``sa_train.supported`` takes: the
    fused trainable SA (``ops/sa_train.py``), three passes over the grouped
    rows that keep h1-h3 out of device memory.

Mixed precision follows the JAX package's ``enable_mixed_precision``
(``utils/precision.py`` there): under a bf16 autocast the convs and ``fc``
compute in bf16, BatchNorm takes its batch moments and running statistics
in f32 and returns bf16 (``SCENEVERSE_BN_BF16``, default on), ReLU and the
max-pool run in that type. The point ops, the grouping and the frozen
kernels keep their own f32 / bf16 numerics with autocast off.

Train-mode BatchNorm is synchronised over a data-parallel world on all
three routes (``parallel/mesh.py::global_sums``: the rows' sums, sums of
squares or Gram, and the row count, summed over the ranks in one
collective before the moments are formed), as the JAX package's global
batch makes it; the running statistics move identically on every rank.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
from torch import nn

from sceneverse_tpu_torch.ops import sa_train
from sceneverse_tpu_torch.ops.pointops import (ball_query, gather_points,
                                              group_points)
from sceneverse_tpu_torch.ops.sa_forward import (_bf16, fold_shared_mlp, fps,
                                                fused_sa_forward)
from sceneverse_tpu_torch.ops.sample_group import sample_and_group
from sceneverse_tpu_torch.parallel import mesh


def _gate(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() in ("1", "on", "true")


def _bn_fold_enabled() -> bool:
    """``SCENEVERSE_BN_FOLD`` (default off): train-mode BatchNorm folded
    analytically into the conv epilogue (``ConvBNReLU._folded``); also a
    precondition of the fused trainable SA. Read at call time."""
    return _gate("SCENEVERSE_BN_FOLD", "off")


def _sa_train_fused_enabled() -> bool:
    """``SCENEVERSE_SA_TRAIN_FUSED`` (default off): the fused trainable SA
    of ``ops/sa_train.py``, which keeps h1-h3 out of device memory. It stays
    off until a bench on the card shows that it beats the literal route."""
    return _gate("SCENEVERSE_SA_TRAIN_FUSED", "off")


def _sa2_batched_enabled() -> bool:
    """``SCENEVERSE_SA2_BATCHED`` (default off, as in the JAX package): a
    frozen SA level with fewer than 256 points whose samples take every
    point (nsample >= N, SA2) runs the dense stage ``sa_dense_pool``
    instead of ``sa_group_mlp_pool``. Read at call time."""
    return _gate("SCENEVERSE_SA2_BATCHED", "off")


def _bn_bf16() -> bool:
    """``SCENEVERSE_BN_BF16`` (default on): under mixed precision BatchNorm
    returns bf16; its statistics stay f32."""
    return _gate("SCENEVERSE_BN_BF16", "on")


def bn_out_dtype(x: torch.Tensor) -> torch.dtype:
    """BatchNorm's output type: bf16 under a bf16 autocast (with
    ``SCENEVERSE_BN_BF16`` on), else the input's type promoted to f32."""
    dev = x.device.type
    if (torch.is_autocast_enabled(dev)
            and torch.get_autocast_dtype(dev) == torch.bfloat16
            and _bn_bf16()):
        return torch.bfloat16
    return torch.promote_types(x.dtype, torch.float32)


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _no_autocast(t: torch.Tensor):
    return torch.autocast(t.device.type, enabled=False)


class _BatchNorm(nn.Module):
    """``bn.bn`` nesting of the reference's BatchNorm2d wrapper."""

    def __init__(self, dim: int):
        super().__init__()
        self.bn = nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's rule, ``0.9 * old + 0.1 * batch``, with the biased batch
        variance (``torch.nn.BatchNorm1d`` would store the unbiased one)."""
        bn = self.bn
        with torch.no_grad():
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """flax ``nnx.BatchNorm`` over every axis but the last.

        Train mode normalises with the batch's biased variance in flax's
        fast form, ``max(E[h^2] - E[h]^2, 0)``, over the rows of every
        rank, and moves the running statistics by ``update_running``. Eval
        mode uses the running statistics. Moments and normalisation are f32
        whatever ``h`` is (flax's ``_compute_stats`` / ``_normalize``); the
        result is cast to ``bn_out_dtype``."""
        bn = self.bn
        out_dtype = bn_out_dtype(h)
        with _no_autocast(h):
            h32 = _at_least_f32(h)
            if bn.training:
                rows = h32.reshape(-1, h32.shape[-1])
                (s, q), n = mesh.global_sums(
                    (rows.sum(0), (rows * rows).sum(0)), rows.shape[0])
                mean = s / n
                var = torch.clamp_min(q / n - mean * mean, 0.0)
                self.update_running(mean, var)
            else:
                mean, var = bn.running_mean, bn.running_var
            y = (h32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        return y.to(out_dtype)


class ConvBNReLU(nn.Module):
    """1x1 conv (no bias, BN follows) + BatchNorm + ReLU."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.conv = nn.Linear(din, dout, bias=False)
        self.bn = _BatchNorm(dout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn.bn.training and _bn_fold_enabled():
            return self._folded(x)
        return torch.relu(self.bn(self.conv(x)))

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """The ``SCENEVERSE_BN_FOLD`` route (JAX ``pointnet.py:174-211``):
        the batch moments of ``conv(x)`` are exact functions of the input's
        mean and Gram ``E[x x^T]`` (f32, full precision: TF32 must be off,
        as ``Precision.HIGHEST`` is in JAX), so BatchNorm becomes a
        per-channel affine in the conv's epilogue. The running statistics
        move by flax's rule with this biased ``var_h``; the input moments
        are over the rows of every rank."""
        bn = self.bn.bn
        out_dtype = bn_out_dtype(x)
        with _no_autocast(x):
            xr = _at_least_f32(x.reshape(-1, x.shape[-1]))
            (s, g), n = mesh.global_sums((xr.sum(0), xr.t() @ xr),
                                         xr.shape[0])
            mu_in, gram = s / n, g / n
            a, b, mean_h, var_h = sa_train.fold_moments(
                _at_least_f32(self.conv.weight.t()), mu_in, gram, bn.weight,
                bn.bias, bn.eps)
            self.bn.update_running(mean_h, var_h)
        h = self.conv(x)  # compute dtype: bf16 under autocast
        with _no_autocast(x):
            return torch.relu(h * a + b).to(out_dtype)


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


def _fused_route(mlp: SharedMLP, grouped: torch.Tensor) -> bool:
    """JAX ``pointnet.py:382-395``: both gates on, three layers, every
    BatchNorm affine and in train mode, and a shape ``supported`` takes."""
    layers = mlp.layers()
    return (_sa_train_fused_enabled() and _bn_fold_enabled()
            and len(layers) == 3
            and all(l.bn.bn.training and l.bn.bn.weight is not None
                    and l.bn.bn.bias is not None for l in layers)
            and sa_train.supported(*grouped.shape[:3]))


def fused_trainable_sa(grouped: torch.Tensor, mlp: SharedMLP) -> torch.Tensor:
    """SharedMLP of three ConvBNReLU layers, BatchNorm in train mode, and
    the max over the samples, fused (JAX ``sa_train.py:577-647``) through
    ``sa_train.fused_trainable_sa_fn``.

    grouped (G, m, ns, C), empty slots padded with a copy of the first hit,
    so the pool needs no mask. Moves each layer's running statistics by
    ``_BatchNorm.update_running``; returns (G, m, H3) in BatchNorm's output
    type."""
    G, m, ns, C = grouped.shape
    layers = mlp.layers()
    if len(layers) != 3:
        raise ValueError("fused_trainable_sa needs a 3-layer SharedMLP")
    out_dtype = bn_out_dtype(grouped)
    x = grouped.reshape(G * m * ns, C).float().contiguous()
    convs = tuple(layer.conv.weight.t() for layer in layers)
    bns = tuple((l.bn.bn.weight, l.bn.bn.bias, l.bn.bn.eps) for l in layers)
    pooled, stats = sa_train.fused_trainable_sa_fn(x, convs, bns, ns)
    for layer, (mh, vh) in zip(layers, stats):
        layer.bn.update_running(mh.detach(), vh.detach())
    return pooled.reshape(G, m, -1).to(out_dtype)


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction; ``npoint=None`` is GroupAll."""

    def __init__(self, *, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], mlp: List[int], use_xyz: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz = use_xyz
        self.fused_frozen = False
        # JAX pointnet.py:249-253: read once, when the module is built.
        # exact: the gathered points keep f32 (eval, checkpoint parity);
        # fast (SCENEVERSE_PALLAS_FAST set): the trainable SA1 route rounds
        # them to bf16, lossless for a bf16 first layer
        self.pallas_exact = os.environ.get("SCENEVERSE_PALLAS_FAST", "") == ""
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

    def _group(self, xyz, features):
        """(new_xyz, grouped (B, M, S, C)), autocast off: point ops and
        grouping keep their own numerics."""
        if self.npoint is not None and xyz.shape[1] >= 256:
            # grouped in f32 as the kernel computes it, exact or fast as the
            # module was built (JAX pointnet.py:335-348); the MLP runs in the
            # points' type
            grouped, new_xyz = (t.to(xyz.dtype) for t in sample_and_group(
                self._points(xyz, features), self.npoint, self.nsample,
                self.radius, self.pallas_exact))
            if not self.use_xyz and features is not None:
                grouped = grouped[..., 3:]
            return new_xyz, grouped
        if self.npoint is not None:
            _, fps_idx = fps(xyz.detach().contiguous(), self.npoint)
            new_xyz = gather_points(xyz, fps_idx)
            idx = ball_query(self.radius, self.nsample, xyz.detach(),
                             new_xyz.detach())
            grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is None:
                return new_xyz, grouped_xyz
            feats = group_points(features, idx)
            return new_xyz, (torch.cat([grouped_xyz, feats], -1)
                             if self.use_xyz else feats)
        return None, self._cat(xyz, features)[:, None]  # (B, 1, N, C)

    def forward(self, xyz, features):
        if self.fused_frozen:
            with torch.no_grad(), _no_autocast(xyz):
                return self._frozen(xyz, features)
        with _no_autocast(xyz):
            new_xyz, grouped = self._group(xyz, features)
        mlp = self.mlps[0]
        if _fused_route(mlp, grouped):
            return new_xyz, fused_trainable_sa(grouped, mlp)
        return new_xyz, mlp(grouped).amax(dim=2)

    def _frozen(self, xyz, features):
        layers = fold_shared_mlp(self.mlps[0])
        if self.npoint is not None:
            if len(layers) != 3:
                raise NotImplementedError("fused SA needs a 3-layer MLP")
            (w1, s1), (w2, s2), (w3, s3) = layers
            # JAX pointnet.py:284-296 and sa_forward.py:645-646
            dense = (xyz.shape[1] < 256 and _sa2_batched_enabled()
                     and self.nsample >= xyz.shape[1])
            pooled, new_xyz = fused_sa_forward(
                self._points(xyz, features), self.npoint, self.nsample,
                self.radius, w1, s1, w2, s2, w3, s3, dense_batched=dense)
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
        features = features.float()
        xyz = features[..., :3].contiguous()
        feats = features[..., 3:] if features.shape[-1] > 3 else None
        for sa in self.encoder:
            xyz, feats = sa(xyz, feats)
        return self.fc(feats.reshape(feats.shape[0], -1))

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

The SA / FP variant library (``PointnetSAModuleMSG``,
``PointnetSAModuleVotes``, ``PointnetSAModuleMSGVotes``,
``PointnetFPModule``, ``PointnetLFPModuleMSG``; JAX :457-702) runs the
literal route over plain point ops; ``SharedMLP(bn=False)`` gives its
convs a bias and no BatchNorm.

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
from sceneverse_tpu_torch.ops.pointops import (_sq3, ball_query,
                                              furthest_point_sample,
                                              gather_points, group_points,
                                              three_interpolate, three_nn)
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


def _moment_sums(rows: torch.Tensor):
    """(column sums (C,), Gram ``rows^T rows`` (C, C)) of rows (R, C),
    accumulated in float64 and left there: a float64 sum of f32 terms
    rounds to the same f32 in any order, so a rank split (whose partial
    sums ``global_sums`` adds) or another CPU's blocking gives the same
    moments."""
    r = rows.double()
    return r.sum(0), r.t() @ r


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
            mean, var = (t.to(bn.running_mean.dtype) for t in (mean, var))
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """flax ``nnx.BatchNorm`` over every axis but the last.

        Train mode normalises with the batch's biased variance in flax's
        fast form, ``max(E[h^2] - E[h]^2, 0)``, over the rows of every
        rank, and moves the running statistics by ``update_running``. The
        sums and the moments are taken in float64 and rounded once
        (``_moment_sums``). Eval
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
                    (rows.sum(0, dtype=torch.float64),
                     (rows * rows).sum(0, dtype=torch.float64)),
                    rows.shape[0])
                mean = s / n
                var = torch.clamp_min(q / n - mean * mean, 0.0)
                mean, var = mean.to(h32.dtype), var.to(h32.dtype)
                self.update_running(mean, var)
            else:
                mean, var = bn.running_mean, bn.running_var
            y = (h32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        return y.to(out_dtype)


class ConvBNReLU(nn.Module):
    """1x1 conv + BatchNorm + ReLU; the conv has a bias only without
    BatchNorm (``bn=False``: conv + ReLU)."""

    def __init__(self, din: int, dout: int, bn: bool = True):
        super().__init__()
        self.conv = nn.Linear(din, dout, bias=not bn)
        self.bn = _BatchNorm(dout) if bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is None:
            return torch.relu(self.conv(x))
        if not self.bn.bn.training:
            return torch.relu(self.bn(self.conv(x)))
        if _bn_fold_enabled():
            return self._folded(x)
        if torch.is_autocast_enabled(x.device.type):
            return torch.relu(self.bn(self.conv(x)))
        # train mode without autocast: the layer in float64, its output
        # rounded once, for the reason ``_folded`` gives
        xd = x.to(torch.promote_types(x.dtype, torch.float64))
        h = torch.nn.functional.linear(xd, self.conv.weight.to(xd.dtype))
        return torch.relu(self.bn(h)).to(_at_least_f32(x).dtype)

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """The ``SCENEVERSE_BN_FOLD`` route (JAX ``pointnet.py:174-211``):
        the batch moments of ``conv(x)`` are exact functions of the input's
        mean and Gram ``E[x x^T]`` (full precision: TF32 must be off, as
        ``Precision.HIGHEST`` is in JAX), so BatchNorm becomes a per-channel
        affine in the conv's epilogue. The running statistics move by
        flax's rule with this biased ``var_h``; the input moments are over
        the rows of every rank, summed in float64 (``_moment_sums``).

        Without autocast the layer runs in float64 and rounds its output
        once: its weight gradient is the difference of two row sums of
        like size (the product's and the fold's, which takes the batch
        mean back out), and in f32 the order of those sums (a rank split)
        moved it by 2-3e-5 of its size (``tests/test_torch_ddp.py``, this
        route and the literal one, which ``forward`` runs in float64 for
        the same reason). Under a bf16 autocast the conv computes in bf16
        from f32 moments."""
        bn = self.bn.bn
        out_dtype = bn_out_dtype(x)
        wide = not torch.is_autocast_enabled(x.device.type)
        with _no_autocast(x):
            xr = x.reshape(-1, x.shape[-1])
            xr = xr.double() if wide else _at_least_f32(xr)
            (s, g), n = mesh.global_sums(_moment_sums(xr),
                                         xr.shape[0])
            w = self.conv.weight.to(xr.dtype).t()
            a, b, mean_h, var_h = sa_train.fold_moments(
                w, (s / n).to(xr.dtype), (g / n).to(xr.dtype), bn.weight,
                bn.bias, bn.eps)
            self.bn.update_running(mean_h, var_h)
            if wide:
                y = torch.relu((xr @ w) * a + b)
                return y.reshape(*x.shape[:-1], -1).to(out_dtype)
        h = self.conv(x)  # bf16 under autocast
        with _no_autocast(x):
            return torch.relu(h * a + b).to(out_dtype)


class SharedMLP(nn.Module):
    def __init__(self, spec: List[int], bn: bool = True):
        super().__init__()
        for i in range(len(spec) - 1):
            self.add_module(f"layer{i}", ConvBNReLU(spec[i], spec[i + 1], bn))

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
            and all(l.bn is not None and l.bn.bn.training
                    and l.bn.bn.weight is not None
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
        features = _at_least_f32(features)
        xyz = features[..., :3].contiguous()
        feats = features[..., 3:] if features.shape[-1] > 3 else None
        for sa in self.encoder:
            xyz, feats = sa(xyz, feats)
        return self.fc(feats.reshape(feats.shape[0], -1))


# ---------------------------------------------------------------------------
# The SA / FP variant library (JAX pointnet.py:457-702; reference
# pointnet2_modules.py:78-496): MSG, Votes and FP modules. No GPS config
# builds them. They run the plain point ops of ops/pointops.py, as the JAX
# variants run its plain XLA ops, grouping with autocast off.
# ---------------------------------------------------------------------------


def _in_ball(xyz, new_xyz, radius):
    """(B, M, N) strict ``d2 < r^2`` of every point against every center."""
    d = xyz[:, None, :, :] - new_xyz[:, :, None, :]
    return _sq3(d[..., 0], d[..., 1], d[..., 2]) < torch.tensor(
        radius * radius, dtype=torch.float32)


def _query_group(xyz, new_xyz, features, radius, nsample, use_xyz,
                 normalize_xyz=False, sample_uniformly=False,
                 generator=None):
    """QueryAndGroup (JAX ``pointnet.py:457-490``; reference
    pointnet2_utils.py:291-373), channels-last: (grouped (B, M, S, C'),
    grouped_xyz (B, M, S, 3)). ``sample_uniformly`` refills the pad slots
    (ball query pads with the first hit) with uniform draws from ``generator``
    over the ball's first min(hits, S) points, the same rule as JAX's: a
    slot below the ball's count keeps its point, slot s above takes
    ``idx[floor(u_s * count)]``. The draws themselves differ from JAX's
    threefry stream by design."""
    with torch.no_grad():
        idx = ball_query(radius, nsample, xyz.detach(), new_xyz.detach())
        if sample_uniformly:
            cnt = _in_ball(xyz.detach(), new_xyz.detach(), radius).sum(-1)
            cnt = cnt.clamp(1, nsample)[..., None]  # empty ball: {0}
            u = torch.rand(idx.shape, generator=generator,
                           device=idx.device)
            slot = torch.floor(u * cnt).long()
            resampled = torch.gather(idx, 2, slot)
            keep = torch.arange(nsample, device=idx.device) < cnt
            idx = torch.where(keep, idx, resampled)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        return grouped_xyz, grouped_xyz
    feats = group_points(features, idx)
    return (torch.cat([grouped_xyz, feats], -1) if use_xyz else feats,
            grouped_xyz)


def _group_all(xyz, features, use_xyz):
    """GroupAll: one center holding every point, (B, 1, N, C)."""
    if features is not None and use_xyz:
        return torch.cat([xyz, features], -1)[:, None]
    return (features if features is not None else xyz)[:, None]


def _scale_mlps(mlps, use_xyz, bn):
    return nn.ModuleList([
        SharedMLP([spec[0] + 3 if use_xyz else spec[0]] + list(spec[1:]), bn)
        for spec in mlps])


def _sample(xyz, npoint, inds=None):
    """(new_xyz, inds): the FPS centers (or the given ``inds``) gathered with
    their gradient; (None, inds) for GroupAll."""
    if npoint is None:
        return None, inds
    if inds is None:
        inds = furthest_point_sample(xyz.detach(), npoint)
    return gather_points(xyz, inds), inds


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale grouping (JAX ``pointnet.py:493-530``; reference
    pointnet2_modules.py:78-124): one FPS, then per (radius, nsample, mlp)
    scale a ball query, SharedMLP and max-pool; the scales' features
    concatenated on the channel axis."""

    def __init__(self, *, npoint: Optional[int], radii: List[float],
                 nsamples: List[int], mlps: List[List[int]], bn: bool = True,
                 use_xyz: bool = True):
        super().__init__()
        assert len(radii) == len(nsamples) == len(mlps)
        self.npoint = npoint
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.use_xyz = use_xyz
        self.mlps = _scale_mlps(mlps, use_xyz, bn)

    def _scales(self, xyz, new_xyz, features):
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            with _no_autocast(xyz):
                grouped = (_query_group(xyz, new_xyz, features, radius,
                                        nsample, self.use_xyz)[0]
                           if new_xyz is not None
                           else _group_all(xyz, features, self.use_xyz))
            outs.append(mlp(grouped).amax(dim=2))
        return torch.cat(outs, -1)

    def forward(self, xyz, features):
        new_xyz, _ = _sample(xyz, self.npoint)
        return new_xyz, self._scales(xyz, new_xyz, features)


class PointnetSAModuleVotes(nn.Module):
    """Single-scale SA with the vote-index passthrough and max / avg / rbf
    pooling (JAX ``pointnet.py:533-609``; reference
    pointnet2_modules.py:164-272). Returns (new_xyz, features, inds), and
    the in-ball count min(hits, nsample) with ``ret_unique_cnt``. The
    ``sample_uniformly`` refills draw from ``generator`` when one is passed,
    else from the module's own stream (``seed``, made on the points' device
    at the first call), which each call advances, as JAX's
    ``resample_rngs``."""

    def __init__(self, *, mlp: List[int], npoint: Optional[int] = None,
                 radius: Optional[float] = None,
                 nsample: Optional[int] = None, bn: bool = True,
                 use_xyz: bool = True, pooling: str = "max",
                 sigma: Optional[float] = None, normalize_xyz: bool = False,
                 sample_uniformly: bool = False,
                 ret_unique_cnt: bool = False, seed: int = 0):
        super().__init__()
        if ret_unique_cnt and not sample_uniformly:
            raise ValueError("ret_unique_cnt needs sample_uniformly "
                             "(reference pointnet2_utils.py:311-312)")
        if pooling not in ("max", "avg", "rbf"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.pooling, self.use_xyz = pooling, use_xyz
        self.sample_uniformly = sample_uniformly
        self.ret_unique_cnt = ret_unique_cnt
        self.sigma = sigma if sigma is not None else (
            radius / 2 if radius is not None else None)
        self.normalize_xyz = normalize_xyz
        self.seed, self.generator = seed, None
        self.mlps = _scale_mlps([mlp], use_xyz and bool(mlp), bn)

    def _generator(self, device):
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(self.seed)
        return self.generator

    def forward(self, xyz, features, inds=None, generator=None):
        if inds is not None and inds.shape[1] != self.npoint:
            raise ValueError(f"inds of {inds.shape[1]} centers, npoint "
                             f"{self.npoint}")
        new_xyz, inds = _sample(xyz, self.npoint, inds)
        with _no_autocast(xyz):
            if new_xyz is not None:
                if self.sample_uniformly and generator is None:
                    generator = self._generator(xyz.device)
                grouped, grouped_xyz = _query_group(
                    xyz, new_xyz, features, self.radius, self.nsample,
                    self.use_xyz, normalize_xyz=self.normalize_xyz,
                    sample_uniformly=self.sample_uniformly,
                    generator=generator)
            else:
                grouped = _group_all(xyz, features, self.use_xyz)
                grouped_xyz = xyz[:, None]
        h = self.mlps[0](grouped)  # (B, M, S, C')
        if self.pooling == "max":
            out = h.amax(dim=2)
        elif self.pooling == "avg":
            out = h.mean(dim=2)
        else:  # RBF-weighted sum over nsample (reference :264-268)
            rbf = torch.exp(-torch.sum(grouped_xyz ** 2, -1)
                            / (self.sigma ** 2) / 2)
            out = torch.sum(h * rbf[..., None], dim=2) / float(self.nsample)
        if not self.ret_unique_cnt:
            return new_xyz, out, inds
        with torch.no_grad():
            cnt = _in_ball(xyz.detach(), new_xyz.detach(), self.radius).sum(
                -1).clamp_max(self.nsample).to(torch.int32)
        return new_xyz, out, inds, cnt


class PointnetSAModuleMSGVotes(nn.Module):
    """MSG set abstraction with the vote-index passthrough (JAX
    ``pointnet.py:612-636``; reference pointnet2_modules.py:274-354)."""

    def __init__(self, *, mlps: List[List[int]], npoint: Optional[int],
                 radii: List[float], nsamples: List[int], bn: bool = True,
                 use_xyz: bool = True):
        super().__init__()
        self.msg = PointnetSAModuleMSG(npoint=npoint, radii=radii,
                                       nsamples=nsamples, mlps=mlps, bn=bn,
                                       use_xyz=use_xyz)
        self.npoint = npoint

    def forward(self, xyz, features, inds=None):
        new_xyz, inds = _sample(xyz, self.npoint, inds)
        return new_xyz, self.msg._scales(xyz, new_xyz, features), inds


class PointnetFPModule(nn.Module):
    """Feature propagation (JAX ``pointnet.py:639-665``; reference
    pointnet2_modules.py:356-416): inverse-distance weights over the 3
    nearest known points, the interpolated known features concatenated with
    the unknown points' own, a SharedMLP. The distances carry no gradient,
    as the reference's CUDA ``three_nn`` gives none (``ops/pointops.py``)."""

    def __init__(self, *, mlp: List[int], bn: bool = True):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP(mlp, bn)])

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown (B, n, 3); known (B, m, 3) or None (``known_feats``
        broadcast to every point); unknown_feats (B, n, C1) or None;
        known_feats (B, m, C2) -> (B, n, mlp[-1])."""
        with _no_autocast(unknown):
            if known is not None:
                dist, idx = three_nn(unknown, known)
                recip = 1.0 / (dist + 1e-8)
                weight = recip / torch.sum(recip, dim=2, keepdim=True)
                interp = three_interpolate(known_feats, idx, weight)
            else:
                interp = known_feats.expand(-1, unknown.shape[1], -1)
        feats = (torch.cat([interp, unknown_feats], -1)
                 if unknown_feats is not None else interp)
        return self.mlps[0](feats[:, :, None, :])[:, :, 0, :]


class PointnetLFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation from xyz1 onto xyz2 (JAX
    ``pointnet.py:668-702``; reference pointnet2_modules.py:418-496): per
    scale, xyz1's features grouped around xyz2, SharedMLP and max-pool,
    xyz2's own features concatenated, the shared ``post_mlp``; the scales
    concatenated."""

    def __init__(self, *, mlps: List[List[int]], radii: List[float],
                 nsamples: List[int], post_mlp: List[int], bn: bool = True,
                 use_xyz: bool = True):
        super().__init__()
        assert len(mlps) == len(nsamples) == len(radii)
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.use_xyz = use_xyz
        self.post_mlp = SharedMLP(post_mlp, bn)
        self.mlps = _scale_mlps(mlps, use_xyz, bn)

    def forward(self, xyz2, xyz1, features2, features1):
        """xyz2 (B, N2, 3), xyz1 (B, N1, 3), features2 (B, N2, C2) or None,
        features1 (B, N1, C1) or None -> (B, N2, sum of post_mlp[-1])."""
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            with _no_autocast(xyz1):
                grouped, _ = _query_group(xyz1, xyz2, features1, radius,
                                          nsample, self.use_xyz)
            h = mlp(grouped).amax(dim=2)
            if features2 is not None:
                h = torch.cat([h, features2], -1)
            outs.append(self.post_mlp(h[:, :, None, :])[:, :, 0, :])
        return torch.cat(outs, -1)


@torch.no_grad()
def init_pointnet_weights(pnet: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal convs and ``fc``, zero biases, in module order."""
    for m in pnet.modules():
        if isinstance(m, nn.Linear):
            std = (2.0 / m.weight.shape[1]) ** 0.5
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()

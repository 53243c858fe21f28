"""PointNet++ set-abstraction front end for the trainable backbone: FPS,
ball query and grouping, with a gradient to the input points.

Port of ``sceneverse_tpu/ops/pallas/sample_group.py`` (TPU kernel
``_kernel``, :39-159, behind ``fused_sample_and_group`` and the custom-VJP
``sample_and_group``). Two hand-written CUDA kernels run it:

``fps`` (``csrc/sa_kernels.cu``, shared with the frozen route)
    the FPS half of ``_kernel`` (:49-98). Its selection rule is the TPU
    kernel's: near-origin points are never candidates, the lowest index wins
    a tie, an all-pad object repeats index 0.

``ball_group`` (``csrc/sample_group.cu``)
    the ball-query and grouping half (:100-159). Persistent blocks (one
    wave: SMs x blocks per SM) walk the objects; the next object's (N, C)
    rows and centers are in flight (``cp.async``, 16-byte copies where
    aligned, a second buffer where two fit in shared memory) while the
    current one is scanned and written. Per object the block builds x, y, z
    planes beside the rows (conflict-free loads for the scan); per chunk of
    32 centers a warp tests 4 centers per pass over the planes (one set of
    loads, four ``__ballot_sync``, no rank work for an empty ballot; the
    scan ``sv_ball_scan4`` is the one ``sv_sa_fwd`` runs) and stops for a
    center once its ball is full. Each center keeps the first ``nsample``
    points with strict ``d2 < r^2`` (``d2 = (dx^2 + dy^2) + dz^2`` without
    FMA contraction, as the plain twin computes it), padded with the first
    hit (point 0 for an empty ball). A chunk's indices and grouped rows are
    contiguous in the outputs: the block writes them with 16-byte stores
    where aligned, at C = 6 two whole rows a thread, else one float a
    thread, each thread following its element's (center, sample, channel)
    by a fixed advance, no integer divide per element. Where one buffer and
    the planes do not fit in the 227 KB of shared memory, the block stages
    the rows alone and a warp lists one center a pass from them, so the
    wrapper takes every object of ``4 (N C + 8 nsample)`` bytes up to
    227 KB (at C = 6, nsample = 32: N up to 9642). Bound:
    bytes. At SA1 (G=2560, N=1024, C=6, m=ns=32) it reads 63 MB of points
    and writes 63 MB of grouped values and 10.5 MB of indices, about 41 us
    at 3.35 TB/s; on the path's standard-normal data almost no ball fills,
    so each warp scans all N points for its 4 centers, about as many
    instruction issues again.

``grouped`` is centered xyz ++ raw channels 3.. (the TPU kernel's :237-243).
``exact=False`` is the JAX package's ``SCENEVERSE_PALLAS_FAST`` mode: the
gathered values round to bf16 and the centering subtracts the f32 centers
(:136-158). The backward is the deterministic scatter-add of ``_sg_bwd``
(:269-283), plain PyTorch here as XLA is there; on the slice it never runs,
because SA1's input is data and needs no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sceneverse_tpu_torch.ops import _build
from sceneverse_tpu_torch.ops.pointops import ball_query, group_points
from sceneverse_tpu_torch.ops.sa_forward import _bf16, fps, fps_plain

_MAX_SMEM = 227 * 1024


# --------------------------------------------------------------- plain twins
def ball_group_plain(pts: torch.Tensor, centers: torch.Tensor, nsample: int,
                     radius: float, exact: bool = True):
    """pts (G, N, C) f32, centers (G, m, 3) f32 -> grouped (G, m, ns, C),
    bq_idx (G, m, ns) int32."""
    idx = ball_query(radius, nsample, pts[..., :3].contiguous(), centers)
    src = pts if exact else _bf16(pts)
    g = group_points(src, idx)
    grouped = torch.cat([g[..., :3] - centers[:, :, None, :], g[..., 3:]], -1)
    return grouped, idx


def sample_and_group_plain(pts: torch.Tensor, npoint: int, nsample: int,
                           radius: float, exact: bool = True):
    """Plain twin of ``fused_sample_and_group`` from ``ops/pointops.py``."""
    new_xyz, fps_idx = fps_plain(pts[..., :3].contiguous(), npoint)
    grouped, bq_idx = ball_group_plain(pts, new_xyz, nsample, radius, exact)
    return grouped, new_xyz, fps_idx, bq_idx


# ------------------------------------------------------------ kernel wrapper
def _lib():
    lib = _build.load_library("sample_group")
    if not hasattr(lib, "_bound"):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ball_group_fn = _build.bind(lib, "sv_ball_group",
                                        [P, P, I, I, I, I, I, F, I, P, P, P])
        lib.smem_fn = _build.bind(lib, "sv_ball_group_smem", [I, I, I, I])
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _smem(N: int, C: int, m: int, nsample: int) -> int:
    return _lib().smem_fn(N, C, m, nsample)


def ball_group(pts: torch.Tensor, centers: torch.Tensor, nsample: int,
               radius: float, exact: bool = True):
    """Ball query + grouping around given centers; see the module doc."""
    if not pts.is_cuda:
        return ball_group_plain(pts, centers, nsample, radius, exact)
    _build.require_cuda(pts, "ball_group.pts", (torch.float32,), 3)
    _build.require_cuda(centers, "ball_group.centers", (torch.float32,), 3)
    G, N, C = pts.shape
    m = centers.shape[1]
    if C < 3 or centers.shape[0] != G or centers.shape[2] != 3:
        raise ValueError(f"ball_group: pts {tuple(pts.shape)} and centers "
                         f"{tuple(centers.shape)} must be (G, N, C>=3), "
                         "(G, m, 3)")
    if nsample < 1:
        raise ValueError(f"ball_group: nsample={nsample}")
    lib = _lib()
    smem = _smem(N, C, m, nsample)
    if smem > _MAX_SMEM:
        raise ValueError(f"ball_group: {smem} B of shared memory needed, the "
                         f"card has {_MAX_SMEM}")
    grouped = torch.empty((G, m, nsample, C), device=pts.device,
                          dtype=torch.float32)
    idx = torch.empty((G, m, nsample), device=pts.device, dtype=torch.int32)
    if G == 0 or m == 0:
        return grouped, idx
    code = lib.ball_group_fn(
        pts.data_ptr(), centers.data_ptr(), G, N, C, m, nsample,
        float(radius * radius), int(bool(exact)), grouped.data_ptr(),
        idx.data_ptr(), _build.stream_ptr(pts))
    _build.LAUNCHES["ball_group"] += 1
    _build.check(code, "ball_group")
    return grouped, idx


def fused_sample_and_group(pts: torch.Tensor, npoint: int, nsample: int,
                           radius: float, exact: bool = True):
    """(G, N, C) f32 xyz-first -> grouped (G, m, ns, C), new_xyz (G, m, 3),
    fps_idx (G, m) int32, bq_idx (G, m, ns) int32."""
    pts = pts.detach().float().contiguous()
    if not pts.is_cuda:
        return sample_and_group_plain(pts, npoint, nsample, radius, exact)
    new_xyz, fps_idx = fps(pts[..., :3].contiguous(), npoint)
    grouped, bq_idx = ball_group(pts, new_xyz, nsample, radius, exact)
    return grouped, new_xyz, fps_idx, bq_idx


def sample_and_group_bwd(fps_idx, bq_idx, dgrouped, dnew, shape):
    """VJP of (grouped, new_xyz) w.r.t. pts: ``dpts[bq] += dgrouped`` and
    ``dpts[fps, :3] += dnew - sum_s dgrouped[..., :3]``."""
    G, N, C = shape
    base = (torch.arange(G, device=dgrouped.device) * N)[:, None]
    bq_flat = (bq_idx.reshape(G, -1).long() + base).reshape(-1)
    fps_flat = (fps_idx.long() + base).reshape(-1)
    dpts = torch.zeros((G * N, C), dtype=dgrouped.dtype,
                       device=dgrouped.device)
    dpts.index_add_(0, bq_flat, dgrouped.reshape(-1, C))
    dcenter = dnew.reshape(-1, 3) - dgrouped[..., :3].sum(2).reshape(-1, 3)
    dpts[:, :3].index_add_(0, fps_flat, dcenter)
    return dpts.reshape(G, N, C)


class _SampleAndGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, npoint, nsample, radius, exact):
        grouped, new_xyz, fps_idx, bq_idx = fused_sample_and_group(
            pts, npoint, nsample, radius, exact)
        ctx.save_for_backward(fps_idx, bq_idx)
        ctx.shape = tuple(pts.shape)
        return grouped, new_xyz

    @staticmethod
    def backward(ctx, dgrouped, dnew):
        fps_idx, bq_idx = ctx.saved_tensors
        dpts = sample_and_group_bwd(fps_idx, bq_idx, dgrouped, dnew, ctx.shape)
        return dpts, None, None, None, None


def sample_and_group(pts: torch.Tensor, npoint: int, nsample: int,
                     radius: float, exact: bool = True):
    """Differentiable front end: (G, N, C) -> (grouped (G, m, ns, C),
    new_xyz (G, m, 3))."""
    return _SampleAndGroup.apply(pts, npoint, nsample, radius, exact)

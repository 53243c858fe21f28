"""Frozen set-abstraction forward: FPS + ball query + grouping + 3-layer
SharedMLP (eval BatchNorm folded) + max-pool.

Port of ``sceneverse_tpu/ops/pallas/sa_forward.py::fused_sa_forward``
(TPU kernel ``_kernel`` with ``_fps_inline``, and ``_fps_kernel(_t)`` for
``split_fps``, and ``_kernel_dense_batched`` for ``dense_batched``). Two
hand-written CUDA kernels (``csrc/sa_kernels.cu``):

``fps``
    replaces ``_fps_inline`` / ``_fps_kernel_t``. One block per object, the
    object's xyz and running min-distance in shared memory, a serial
    ``npoint`` loop with a block-wide argmax (ties to the lowest index).
    Bound: the serial chain of ``npoint`` block reductions (two barriers per
    step), not bytes or FLOPs; the design keeps every step on-chip and runs
    all objects' chains in parallel, one per block.

``sa_group_mlp_pool`` and ``sa_dense_pool`` (one kernel, ``sv_sa_fwd``)
    replace the body of ``_kernel`` (selection branch nsample < N for SA1,
    dense branch nsample >= N for SA2) and ``_kernel_dense_batched`` (the
    SA2 dense stage of the ``SCENEVERSE_SA2_BATCHED`` route), which compute
    the same function: ``sa_dense_pool`` is the dense branch. Persistent
    blocks (one wave: SMs x blocks per SM; 8 warps, 2 per SM at SA1
    widths, 16 warps, 1 per SM at SA2) walk the objects. Bound: the bf16
    products of the in-ball pairs, or the points read; on the card the
    per-object phases (staging, ball query, barriers) weigh as much.

    * weights: w2 and w3 (bf16, 8 + 16 KB at SA1, 32 + 64 KB at SA2) go to
      shared memory once per block with ``cp.async``, not once per tile.
    * pairs: a warp scans the object's staged points for up to 4 centers
      at once with ``__ballot_sync`` and lists each one's first
      ``min(nsample, N)`` in-ball points (strict d2 < r^2) in index order;
      an empty ball lists point 0. The lists are compacted center-major:
      only in-ball pairs reach the MLP.
    * layer 1 (the w1-fold; each branch's affine bit for bit with
      ``__fmul_rn`` / ``__fadd_rn`` on the CUDA cores): the dense branch
      ``relu(a1 (pw - cw) + b1)``, the selection branch ``relu(a1 pw + (b1
      - a1 cw))``; cw = bf16(c) @ w1[:3] once per center; pw = bf16(bf16(p)
      @ w1) once per point from one ``mma.sync`` product where the table
      fits (SA2, C = 131), else per pair as an f32 FMA chain (SA1, C = 6);
      h1 goes to shared memory as bf16 in the A layout of ``ldmatrix``.
    * layers 2-3 on the tensor cores: 64-row tiles, 2 rows of warps of 32
      rows, 32 columns of layer 3 (16 of layer 2) a warp,
      ``mma.sync.m16n8k16`` bf16 with f32 accumulators in registers; u a +
      b and ReLU on the accumulators; h2 rounds to bf16 into shared memory.
    * pool from the registers: the f32 h3 of a warp's 8-row slots (the
      rows g of mma's C fragment) whose rows all hold one center merge in
      registers, a butterfly of shuffles takes the max over the slot's
      rows, then one shared ``atomicMax`` per value on the bits of the
      non-negative float; a slot of several centers sends each row to its
      own center. The max is order-free: two runs are bit-identical. The
      pooled (G, m, H3) is written once per object.

Numerics are the TPU kernel's, not a float32 XLA pipeline's: weights are
cast to bf16, per-point layer-1 projections round to bf16, activations round
to bf16 between layers, accumulation is f32. Pad-with-first slots only
duplicate members of a max-pool, so the kernel skips them; that changes
nothing in the output.
"""

from __future__ import annotations

import ctypes

import torch

from sceneverse_tpu_torch.ops import _build
from sceneverse_tpu_torch.ops.pointops import (_sq3, ball_query,
                                              furthest_point_sample)

_SUPPORTED_WIDTHS = ((64, 64, 128), (128, 128, 256))
_MAX_SMEM = 227 * 1024


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fold_shared_mlp(shared_mlp):
    """(wT (H, Cin), [scale, shift] (H, 2)) per layer of a SharedMLP with
    frozen/eval BatchNorm: BN(conv(x)) = conv(x) * a + b with
    a = gamma / sqrt(var + eps), b = beta - mean * a
    (sceneverse_tpu ops/pallas/sa_forward.py:736-753)."""
    params = []
    for layer in shared_mlp.layers():
        w = layer.conv.weight  # (dout, din)
        bn = layer.bn.bn
        a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        b = bn.bias - bn.running_mean * a
        params.append((w, torch.stack([a, b], dim=1)))
    return params


# --------------------------------------------------------------- plain twins
def fps_plain(xyz: torch.Tensor, npoint: int):
    """(G, N, 3) f32 -> (new_xyz (G, npoint, 3), idx (G, npoint) int32)."""
    idx = furthest_point_sample(xyz, npoint)
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None]
    return xyz.float()[rows, idx.long()], idx


def _mlp23(g, w2n, a2, b2, w3n, a3, b3):
    """Layers 2-3 on bf16-valued f32 activations: exact bf16 products,
    f32 accumulation, bf16 round trip between the layers."""
    h = _bf16(torch.relu((g @ w2n.float()) * a2 + b2))
    return torch.relu((h @ w3n.float()) * a3 + b3)


def _layer1(pts, centers, w1n):
    """Per-point projection bf16(bf16(p) @ w1) (G, N, H1) and centering
    term bf16(c) @ w1[:3] (G, m, H1), f32 accumulation."""
    w1f = w1n.float()
    return _bf16(_bf16(pts) @ w1f), _bf16(centers) @ w1f[:3]


def sa_dense_pool_plain(pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3,
                        radius: float):
    """Plain twin of the ``sa_dense_pool`` kernel, and the dense branch of
    ``sa_group_mlp_pool_plain`` (operands as there): every (center, point)
    pair through the MLP, the max over the in-ball points (strict
    d2 < r^2); an empty ball takes pair (c, 0)."""
    with torch.autocast(pts.device.type, enabled=False):
        pw, cw1 = _layer1(pts, centers, w1n)
        diff = pts[:, None, :, :3] - centers[:, :, None, :]
        d2 = _sq3(diff[..., 0], diff[..., 1], diff[..., 2])  # (G, m, N)
        within = d2 < torch.tensor(radius * radius, dtype=torch.float32)
        g = _bf16(torch.relu(a1 * (pw[:, None] - cw1[:, :, None]) + b1))
        h3 = _mlp23(g, w2n, a2, b2, w3n, a3, b3)  # (G, m, N, H3)
        pooled = torch.where(within[..., None], h3,
                             torch.full_like(h3, -3.0e38)).amax(dim=2)
        empty = ~within.any(dim=2)
        return torch.where(empty[..., None], h3[:, :, 0], pooled)


def sa_group_mlp_pool_plain(pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3,
                            b3, radius: float, nsample: int):
    """Plain twin of the ``sa_group_mlp_pool`` kernel (same rounding points).

    pts (G, N, C) f32 xyz-first; centers (G, m, 3) f32; w_in (Cin, H) bf16;
    a_i, b_i (H,) f32. Returns pooled (G, m, H3) f32."""
    G, N, _ = pts.shape
    if nsample >= N:  # dense branch: every in-ball point is a group member
        return sa_dense_pool_plain(pts, centers, w1n, a1, b1, w2n, a2, b2,
                                   w3n, a3, b3, radius)
    with torch.autocast(pts.device.type, enabled=False):
        pw, cw1 = _layer1(pts, centers, w1n)
        idx = ball_query(radius, nsample, pts[..., :3].contiguous(), centers)
        gh = torch.gather(
            pw[:, None].expand(G, idx.shape[1], N, pw.shape[-1]), 2,
            idx.long()[..., None].expand(*idx.shape, pw.shape[-1]))
        g = _bf16(torch.relu(a1 * gh + (b1 - a1 * cw1[:, :, None])))
        return _mlp23(g, w2n, a2, b2, w3n, a3, b3).amax(dim=2)


# ------------------------------------------------------------ kernel wrappers
def _lib():
    lib = _build.load_library("sa_kernels")
    if not hasattr(lib, "_bound"):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fps_fn = _build.bind(lib, "sv_fps", [P, I, I, I, P, P, P])
        lib.smem_fn = _build.bind(lib, "sv_sa_fwd_smem", [I] * 7)
        lib.sa_fn = _build.bind(
            lib, "sv_sa_fwd",
            [P] * 12 + [I, I, I, I, I, I, F, P])
        lib._bound = True
    return lib


def fps(xyz: torch.Tensor, npoint: int):
    """Furthest point sampling: (G, N, 3) f32 -> (new_xyz, idx int32)."""
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint)
    _build.require_cuda(xyz, "fps.xyz", (torch.float32,), 3)
    G, N, three = xyz.shape
    if three != 3 or not 1 <= npoint <= N:
        raise ValueError(f"fps: bad shape {tuple(xyz.shape)} npoint={npoint}")
    if 4 * N * 4 > _MAX_SMEM:
        raise ValueError(f"fps: N={N} exceeds shared memory")
    new_xyz = torch.empty((G, npoint, 3), device=xyz.device,
                          dtype=torch.float32)
    idx = torch.empty((G, npoint), device=xyz.device, dtype=torch.int32)
    if G == 0:
        return new_xyz, idx
    code = _lib().fps_fn(xyz.data_ptr(), G, N, npoint, new_xyz.data_ptr(),
                         idx.data_ptr(), _build.stream_ptr(xyz))
    _build.LAUNCHES["fps"] += 1
    _build.check(code, "fps")
    return new_xyz, idx


def _check_sa(name, pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3):
    """Raise unless the operands are what the SA kernels take; returns
    (G, N, C, m, (H1, H2, H3))."""
    _build.require_cuda(pts, f"{name}.pts", (torch.float32,), 3)
    _build.require_cuda(centers, f"{name}.centers", (torch.float32,), 3)
    G, N, C = pts.shape
    m = centers.shape[1]
    hs = (w1n.shape[1], w2n.shape[1], w3n.shape[1])
    for wn, w, cin in (("w1", w1n, C), ("w2", w2n, hs[0]),
                       ("w3", w3n, hs[1])):
        _build.require_cuda(w, f"{name}.{wn}", (torch.bfloat16,), 2)
        if w.shape[0] != cin:
            raise ValueError(f"{name}.{wn}: {tuple(w.shape)} does not take "
                             f"{cin} input channels")
    for tn, t, h in (("a1", a1, hs[0]), ("b1", b1, hs[0]), ("a2", a2, hs[1]),
                     ("b2", b2, hs[1]), ("a3", a3, hs[2]), ("b3", b3, hs[2])):
        _build.require_cuda(t, f"{name}.{tn}", (torch.float32,), 1)
        if t.shape[0] != h:
            raise ValueError(f"{name}.{tn}: expected ({h},)")
    if centers.shape[0] != G or centers.shape[2] != 3 or C < 3:
        raise ValueError(f"{name}: centers must be (G, m, 3)")
    return G, N, C, m, hs


def _sa_fwd(name, pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3,
            radius, nsample):
    """Launch ``sv_sa_fwd`` for the entry ``name``, counted once and under
    a profiler range of that name, since both entries share the kernel."""
    G, N, C, m, hs = _check_sa(name, pts, centers, w1n, a1, b1, w2n, a2, b2,
                               w3n, a3, b3)
    if hs not in _SUPPORTED_WIDTHS:
        raise ValueError(f"{name}: widths {hs} not instantiated (supported "
                         f"{_SUPPORTED_WIDTHS})")
    if not (1 <= N <= 65535 and m <= 32767 and nsample >= 1):
        raise ValueError(f"{name}: N={N}, m={m} or nsample={nsample} out of "
                         "range")
    if any(w.data_ptr() % 16 for w in (w1n, w2n, w3n)):
        raise ValueError(f"{name}: weights must be 16-byte aligned")
    lib = _lib()
    smem = lib.smem_fn(N, C, m, nsample, *hs)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: {smem} B of shared memory needed, the card "
                         f"has {_MAX_SMEM}")
    pooled = torch.empty((G, m, hs[2]), device=pts.device,
                         dtype=torch.float32)
    if G == 0:
        return pooled
    with torch.profiler.record_function(name):
        code = lib.sa_fn(
            pts.data_ptr(), centers.data_ptr(),
            w1n.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            w2n.data_ptr(), a2.data_ptr(), b2.data_ptr(),
            w3n.data_ptr(), a3.data_ptr(), b3.data_ptr(),
            pooled.data_ptr(), G, N, C, m, nsample, hs[0],
            float(radius * radius), _build.stream_ptr(pts))
    _build.LAUNCHES[name] += 1
    _build.check(code, name)
    return pooled


def sa_group_mlp_pool(pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3,
                      radius: float, nsample: int):
    """Ball query + grouping + 3-layer folded MLP + max-pool per center."""
    if not pts.is_cuda:
        return sa_group_mlp_pool_plain(pts, centers, w1n, a1, b1, w2n, a2, b2,
                                       w3n, a3, b3, radius, nsample)
    return _sa_fwd("sa_group_mlp_pool", pts, centers, w1n, a1, b1, w2n, a2,
                   b2, w3n, a3, b3, radius, nsample)


def sa_dense_pool(pts, centers, w1n, a1, b1, w2n, a2, b2, w3n, a3, b3,
                  radius: float):
    """Dense SA stage: every in-ball (center, point) pair through the folded
    MLP, the max over them, pair (c, 0) for an empty ball: the dense branch
    of ``sa_group_mlp_pool`` (nsample = N), which it equals bit for bit.
    Operands as there."""
    if not pts.is_cuda:
        return sa_dense_pool_plain(pts, centers, w1n, a1, b1, w2n, a2, b2,
                                   w3n, a3, b3, radius)
    return _sa_fwd("sa_dense_pool", pts, centers, w1n, a1, b1, w2n, a2, b2,
                   w3n, a3, b3, radius, pts.shape[1])


def prepare_weights(w1, s1, w2, s2, w3, s3):
    """Public (H, Cin) kernels + (H, 2) affines -> the kernels' operands:
    natural-layout (Cin, H) bf16 weights and contiguous f32 scale/shift."""
    out = []
    for w, s in ((w1, s1), (w2, s2), (w3, s3)):
        out += [w.t().contiguous().to(torch.bfloat16),
                s[:, 0].float().contiguous(), s[:, 1].float().contiguous()]
    return out


@torch.no_grad()
def fused_sa_forward(pts: torch.Tensor, npoint: int, nsample: int,
                     radius: float, w1, s1, w2, s2, w3, s3,
                     dense_batched: bool = False):
    """Frozen-SA forward with the JAX package's public contract.

    pts (G, N, C) f32 xyz-first; w_i (H_i, Cin_i); s_i (H_i, 2) [scale,
    shift]. ``dense_batched`` (which needs nsample >= N) takes the dense
    stage ``sa_dense_pool``, the port of ``_kernel_dense_batched``. Returns
    pooled (G, npoint, H3) f32 and new_xyz (G, npoint, 3)."""
    pts = pts.float().contiguous()
    new_xyz, _ = fps(pts[..., :3].contiguous(), npoint)
    ops = prepare_weights(w1, s1, w2, s2, w3, s3)
    if dense_batched:
        if nsample < pts.shape[1]:
            raise ValueError("dense_batched needs nsample >= N")
        pooled = sa_dense_pool(pts, new_xyz, *ops, radius=radius)
    else:
        pooled = sa_group_mlp_pool(pts, new_xyz, *ops, radius=radius,
                                   nsample=nsample)
    return pooled, new_xyz

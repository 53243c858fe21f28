"""Fused multi-head attention for the GPS towers, forward and backward.

Port of ``sceneverse_tpu/ops/pallas/mha.py::fused_mha`` (TPU kernels
``_mha_fwd_kernel`` and ``_mha_bwd_kernel`` under a ``jax.custom_vjp``) as a
``torch.autograd.Function`` over two hand-written CUDA kernels
(``csrc/mha_kernels.cu``):

``mha_fwd``
    softmax(q k^T * scale + pad [+ cond gate]) v with prob-dropout; writes o
    and the f32 logsumexp. Grid (L/64, B*H), 8 warps: a block owns 64 query
    rows of one head and keeps their whole score rows in a 64 x T f32 slab
    in shared memory (77 KB at T = 300), the TPU kernel's whole-row design
    cut to fit a Hopper block (the TPU kernel's (L, T) tile is 352 KB at
    L = T = 300). K and then V stream through a two-stage ``cp.async`` ring
    in 32-key tiles; each warp turns its block of q.k sums into logits
    (scale, pad, gate) as it lands. A row pass then takes each row's exact
    max and sum, writes lse, and stores the normalised, v-dtype-rounded,
    dropped probabilities in place; then p.v runs over the V tiles. No
    online rescaling, so the rounding points are the TPU kernel's.
``mha_bwd``
    flash-style recompute from lse: p = exp(s - lse), delta = rowsum(do*o),
    ds = p (dp - delta). Two launches, no float atomics: the first owns 64
    query rows, computes delta once per row (into a (B, H, L) f32 scratch
    the wrapper allocates), walks 32-key (K, V) tiles and accumulates dq and
    the gate gradient dsw (summed per row inside one warp); the second owns
    64 keys, walks 32-row (Q, dO) tiles and accumulates dv = a^T do and
    dk = ds^T q. Deterministic: two runs agree bit for bit.

Every product runs on the tensor cores (``nvcuda::wmma``, f32 sums): bf16
m16n16k16 for bf16 operands; for f32 operands 3xTF32, each operand split
into big = tf32_rna(x) and small = tf32_rna(x - big) and the product formed
as small.big + big.small + big.big on m16n16k8 TF32 fragments, about f32
accuracy (single-pass TF32 keeps ~3 digits and would break the f32
tolerance). The elementwise work (pad, gate, exp, dropout counter) needs
each element's (row, key), and wmma fragments have no documented element
layout, so scores pass through shared memory, as in ``flash_attn.cu``; the
forward's slab holds them anyway. Shared memory per block at f32 / bf16:
forward 114 / 97 KB at T = 300 (T <= 768 fits), dq 90 / 62 KB, dk/dv
87 / 64 KB: two blocks of 8 warps per SM; registers and spills, from
ptxas, are in the note at the head of ``csrc/mha_kernels.cu``.
Bound on the card: the products at 165 TFLOP/s (3xTF32) or 989 (bf16);
wgmma and TMA are later work. No (B, H, L, T) score, probability, gate or
dropout-mask tensor ever reaches device memory.

Routing (``fused_mha_enabled``, ``fused_mha_supported``) is the JAX
package's: the gate ``SCENEVERSE_FUSED_MHA`` (default on) and its head
layout predicate decide whether a layer takes this kernel at all.

Semantics kept from the TPU kernel: packed (B, L, H*dh) heads (head h at
column h*dh; the TPU's 128-lane block packing is not ported), an f32
additive pad row even for bf16 inputs (HF's ``finfo(f32).min`` overflows
bf16), the 'cond' gate ``max(log_sigmoid(sw . [1, locs]), log 1e-6)`` forced
to log 1e-6 at padded keys, probabilities rounded to v's dtype before the
dropout mask and the PV product, and the dropout stream of
``_uniform01_hash`` (murmur3 finalizer over ``r*T + c`` with seed
``seed + b*H + h``), so kernel, plain twin and the JAX interpret mode draw
the same mask. The seed is a (1,) int64 tensor on the operands' device
(``modules/utils.py::AttentionSeed`` draws it from a device generator),
and the kernels read it from device memory: a CUDA graph that replays a
launch then draws a new mask on every replay, where a seed passed by value
would be frozen into the graph.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from sceneverse_tpu_torch.ops import _build

LOG1E6 = math.log(1e-6)
NEG = -1e30
_MAX_SMEM = 227 * 1024
_DTYPES = (torch.float32, torch.bfloat16)
_GATE_ENV = "SCENEVERSE_FUSED_MHA"


def fused_mha_enabled() -> bool:
    """``SCENEVERSE_FUSED_MHA`` (default on, as in the JAX package): the
    towers' attention layers take this fused kernel. ``off`` is the JAX
    package's exact mode for evaluating reference checkpoints: the layers
    take the flash kernel (``ops/attention.py``, when its gate is on and
    dropout is inactive) or the plain attention with ``softmax_lowp``.
    Read at call time."""
    return os.environ.get(_GATE_ENV, "on").lower() in ("1", "on", "true")


def fused_mha_supported(d_model: int, n_heads: int) -> bool:
    """The JAX package's routing predicate (``mha.py:97-121`` there): the
    TPU kernel packs heads into 128-lane blocks and takes D <= 128,
    dh % 128 == 0, or 128 % dh == 0 with D % 128 == 0; other layouts take
    the other attention paths. Where this holds and the port's kernel lacks
    the head width, ``fused_mha`` raises on the card."""
    if d_model % n_heads:
        return False
    dh = d_model // n_heads
    return (d_model <= 128 or dh % 128 == 0
            or (128 % dh == 0 and d_model % 128 == 0))


# --------------------------------------------------------------- plain twins
def dropout_keep_mask(B, H, L, T, seed: torch.Tensor, keep: float, device):
    """(B, H, L, T) bool keep-mask from the counter hash of the TPU kernel's
    interpret mode (uint32 arithmetic carried in int64); ``seed`` a (1,)
    int64 tensor on ``device``, read on the device."""
    M = 0xFFFFFFFF
    bh = torch.arange(B * H, device=device, dtype=torch.int64).view(B, H, 1, 1)
    s = (seed.reshape(1, 1, 1, 1).to(torch.int64) + bh) & M
    r = torch.arange(L, device=device, dtype=torch.int64).view(1, 1, L, 1)
    c = torch.arange(T, device=device, dtype=torch.int64).view(1, 1, 1, T)
    x = (r * T + c + s * 0x9E3779B9) & M
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u < torch.tensor(keep, dtype=torch.float32)


def _heads(x, H):  # (B, L, H*dh) -> (B, H, L, dh) f32
    B, L, D = x.shape
    return x.reshape(B, L, H, D // H).transpose(1, 2).float()


def _merge(x, dtype):  # (B, H, L, dh) -> (B, L, H*dh)
    B, H, L, dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * dh).to(dtype)


def _scores(q, k, padadd, sw, locs, H, scale):
    """f32 logits (B, H, L, T) [+ gate]; returns (s, z, ls) (z, ls None
    without the gate)."""
    s = (_heads(q, H) @ _heads(k, H).transpose(-1, -2)) * scale
    pad = padadd[:, None, None, :]
    s = s + pad
    if sw is None:
        return s, None, None
    z = sw[..., 0:1]
    for d in range(5):
        z = z + sw[..., d + 1:d + 2] * locs[:, None, :, :, d]
    ls = torch.nn.functional.logsigmoid(z)
    loc = torch.where(pad < -1.0, torch.full_like(ls, LOG1E6),
                      torch.clamp(ls, min=LOG1E6))
    return s + loc, z, ls


def mha_fwd_plain(q, k, v, padadd, sw, locs, n_heads, scale, rate, seed):
    """Plain twin of the ``mha_fwd`` kernel: returns (o, lse (B, H, L))."""
    with torch.autocast(q.device.type, enabled=False):
        B, L, _ = q.shape
        T = k.shape[1]
        s, _, _ = _scores(q, k, padadd, sw, locs, n_heads, scale)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        tot = p.sum(-1, keepdim=True)
        lse = (m + torch.log(tot))[..., 0]
        pn = (p / tot).to(v.dtype)
        if rate > 0.0:
            keep = 1.0 - rate
            mask = dropout_keep_mask(B, n_heads, L, T, seed, keep, q.device)
            inv = torch.tensor(1.0 / keep, dtype=v.dtype, device=q.device)
            pn = torch.where(mask, pn * inv, torch.zeros_like(pn)).to(v.dtype)
        o = pn.float() @ _heads(v, n_heads)
        return _merge(o, q.dtype), lse


def mha_bwd_plain(q, k, v, padadd, sw, locs, do, o, lse, n_heads, scale, rate,
                  seed):
    """Plain twin of the ``mha_bwd`` kernels: (dq, dk, dv, dsw or None)."""
    with torch.autocast(q.device.type, enabled=False):
        B, L, _ = q.shape
        T = k.shape[1]
        cdt = q.dtype
        s, z, ls = _scores(q, k, padadd, sw, locs, n_heads, scale)
        p = torch.exp(s - lse[..., None])
        doh = _heads(do, n_heads)
        delta = (doh * _heads(o, n_heads)).sum(-1, keepdim=True)
        a = p.to(cdt)
        dp = doh @ _heads(v, n_heads).transpose(-1, -2)
        if rate > 0.0:
            keep = 1.0 - rate
            mask = dropout_keep_mask(B, n_heads, L, T, seed, keep, q.device)
            inv = torch.tensor(1.0 / keep, dtype=cdt, device=q.device)
            a = torch.where(mask, a * inv, torch.zeros_like(a)).to(cdt)
            dp = torch.where(mask, dp * (1.0 / keep), torch.zeros_like(dp))
        dv = a.float().transpose(-1, -2) @ doh
        ds = p * (dp - delta)
        dsw = None
        if sw is not None:
            active = (ls > LOG1E6) & (padadd[:, None, None, :] >= -1.0)
            dz = torch.where(active, ds * torch.sigmoid(-z),
                             torch.zeros_like(ds))
            dsw = torch.stack([dz.sum(-1)] + [
                (dz * locs[:, None, :, :, d]).sum(-1) for d in range(5)], -1)
        dsb = ds.to(cdt).float()
        dq = (dsb @ _heads(k, n_heads)) * scale
        dk = (dsb.transpose(-1, -2) @ _heads(q, n_heads)) * scale
        return (_merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype),
                dsw)


# ------------------------------------------------------------ kernel wrappers
def _lib():
    lib = _build.load_library("mha_kernels")
    if not hasattr(lib, "_bound"):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fwd_fn = _build.bind(
            lib, "sv_mha_fwd",
            [I, I, P, P, P, P, P, P, P, P, I, I, I, I, F, F, F, P, P])
        lib.bwd_fn = _build.bind(
            lib, "sv_mha_bwd",
            [I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F,
             F, F, P, P])
        lib._bound = True
    return lib


def mha_smem_bytes(L: int, T: int, dh: int, elem: int = 4) -> int:
    """Dynamic shared memory of the largest of the three launches at
    operands of ``elem`` bytes (``csrc/mha_kernels.cu``): the forward's
    64 x (max(ceil16(T), 64) + 4) f32 score slab plus a 64-row and two
    32-row operand tiles; the backward launches need a fixed amount (no L or
    T term)."""
    row = (dh + 16 // elem) * elem  # one staged operand row
    fwd = 4 * 64 * (max(-(-T // 16) * 16, 64) + 4) + 128 * row
    dq = 256 * row + 4 * 2 * 64 * 36 + (64 * 40 * elem if elem == 2 else 0) \
        + 4 * 64 * 8
    dkv = 256 * row + 4 * 2 * 32 * 68 + (2 * 32 * row if elem == 2 else 0) \
        + 4 * 64
    return max(fwd, dq, dkv)


def _check_operands(q, k, v, padadd, sw, locs, n_heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(t, f"mha.{name}", _DTYPES, 3)
        if t.data_ptr() % 16:  # rows are staged by 16-byte cp.async copies
            raise ValueError(f"mha.{name}: address not 16-byte aligned")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("mha: q, k, v must share one dtype")
    B, L, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, D) or v.shape != (B, T, D) or D % n_heads:
        raise ValueError(f"mha: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} H={n_heads}")
    dh = D // n_heads
    if dh != 64:
        raise ValueError(f"mha: head width {dh} not instantiated (only 64)")
    if mha_smem_bytes(L, T, dh, q.element_size()) > _MAX_SMEM:
        raise ValueError(f"mha: L={L}, T={T} exceed the kernel's shared "
                         "memory")
    _build.require_cuda(padadd, "mha.pad", (torch.float32,), 2)
    if padadd.shape != (B, T):
        raise ValueError("mha: pad row must be (B, T)")
    if sw is not None:
        _build.require_cuda(sw, "mha.sw", (torch.float32,), 4)
        _build.require_cuda(locs, "mha.locs", (torch.float32,), 4)
        if sw.shape != (B, n_heads, L, 6) or locs.shape != (B, L, T, 5):
            raise ValueError("mha: gate needs sw (B,H,L,6), locs (B,L,T,5)")
    return B, L, T, D, dh


def _inv_keep(rate, dtype):
    if rate <= 0.0:
        return 1.0, 1.0
    inv = 1.0 / (1.0 - rate)
    return float(torch.tensor(inv, dtype=dtype).float()), inv


def _seed_ptr(seed, rate, q):
    """The device address of the (1,) int64 seed; None without dropout."""
    if rate <= 0.0:
        return None
    if not (torch.is_tensor(seed) and seed.is_cuda and seed.dtype == torch.int64
            and seed.numel() == 1 and seed.device == q.device):
        raise TypeError("mha: dropout needs its seed as a (1,) int64 tensor "
                        f"on {q.device}, got {seed!r}")
    return seed.data_ptr()


def mha_fwd(q, k, v, padadd, sw, locs, n_heads: int, scale: float,
            rate: float = 0.0, seed: torch.Tensor | None = None):
    """Fused attention forward: (o (B, L, D) in q.dtype, lse (B, H, L) f32).
    ``seed`` is a (1,) int64 tensor on q's device when ``rate`` > 0."""
    if not q.is_cuda:
        return mha_fwd_plain(q, k, v, padadd, sw, locs, n_heads, scale, rate,
                             seed)
    B, L, T, D, dh = _check_operands(q, k, v, padadd, sw, locs, n_heads)
    o = torch.empty_like(q)
    lse = torch.empty((B, n_heads, L), device=q.device, dtype=torch.float32)
    inv_t, _ = _inv_keep(rate, q.dtype)
    code = _lib().fwd_fn(
        int(q.dtype == torch.bfloat16), dh, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), padadd.data_ptr(), sw.data_ptr() if sw is not None else None,
        locs.data_ptr() if sw is not None else None, o.data_ptr(),
        lse.data_ptr(), B, n_heads, L, T, float(scale), float(rate), inv_t,
        _seed_ptr(seed, rate, q), _build.stream_ptr(q))
    _build.LAUNCHES["mha_fwd"] += 1
    _build.check(code, "mha_fwd")
    return o, lse


def mha_bwd(q, k, v, padadd, sw, locs, do, o, lse, n_heads: int,
            scale: float, rate: float = 0.0, seed: torch.Tensor | None = None):
    """Fused attention backward: (dq, dk, dv, dsw (B, H, L, 6) f32 or None);
    ``seed`` the forward's."""
    if not q.is_cuda:
        return mha_bwd_plain(q, k, v, padadd, sw, locs, do, o, lse, n_heads,
                             scale, rate, seed)
    B, L, T, D, dh = _check_operands(q, k, v, padadd, sw, locs, n_heads)
    for name, t in (("do", do), ("o", o)):
        _build.require_cuda(t, f"mha.{name}", (q.dtype,), 3)
        if t.shape != q.shape or t.data_ptr() % 16:
            raise ValueError(f"mha.{name}: expected {tuple(q.shape)} at a "
                             "16-byte aligned address")
    _build.require_cuda(lse, "mha.lse", (torch.float32,), 3)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsw = (torch.empty((B, n_heads, L, 6), device=q.device,
                       dtype=torch.float32) if sw is not None else None)
    # delta = rowsum(do * o), written by the dq launch, read by dk/dv
    delta = torch.empty((B, n_heads, L), device=q.device, dtype=torch.float32)
    inv_t, inv_f = _inv_keep(rate, q.dtype)
    code = _lib().bwd_fn(
        int(q.dtype == torch.bfloat16), dh, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), padadd.data_ptr(), sw.data_ptr() if sw is not None else None,
        locs.data_ptr() if sw is not None else None, do.data_ptr(),
        o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsw.data_ptr() if dsw is not None else None,
        delta.data_ptr(), B, n_heads, L, T, float(scale), float(rate), inv_t,
        inv_f, _seed_ptr(seed, rate, q), _build.stream_ptr(q))
    _build.LAUNCHES["mha_bwd"] += 1
    _build.check(code, "mha_bwd")
    return dq, dk, dv, dsw


class FusedMHA(torch.autograd.Function):
    """Autograd wrapper: forward saves (q, k, v, pad, sw, locs, o, lse);
    backward runs the recompute kernels (sceneverse_tpu mha.py:348-444)."""

    @staticmethod
    def forward(ctx, q, k, v, padadd, sw, locs, n_heads, scale, rate, seed):
        with torch.autocast(q.device.type, enabled=False):
            o, lse = mha_fwd(q, k, v, padadd, sw, locs, n_heads, scale, rate,
                             seed)
        ctx.save_for_backward(q, k, v, padadd, sw, locs, o, lse, seed)
        ctx.cfg = (n_heads, scale, rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, padadd, sw, locs, o, lse, seed = ctx.saved_tensors
        n_heads, scale, rate = ctx.cfg
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dsw = mha_bwd(q, k, v, padadd, sw, locs,
                                      do.to(q.dtype).contiguous(), o, lse,
                                      n_heads, scale, rate, seed)
        return dq, dk, dv, None, dsw, None, None, None, None, None


def fused_mha(q, k, v, n_heads: int, key_padding_mask=None,
              pad_additive=None, gate_sw=None, locs=None,
              dropout_rate: float = 0.0, seed: torch.Tensor | None = None, *,
              scale: float):
    """softmax(q k^T * scale [+ cond gate] + pad) @ v with the public
    contract of ``sceneverse_tpu.ops.pallas.mha.fused_mha``.

    q (B, L, H*dh), k/v (B, T, H*dh) packed heads, f32 or bf16;
    ``key_padding_mask`` (B, T) bool, True = pad key, or ``pad_additive``
    (B, T) additive row; ``gate_sw`` (B, H, L, 6) with ``locs`` (B, L, T, 5)
    enables the 'cond' gate; ``dropout_rate`` needs a ``seed``, a (1,)
    int64 tensor on q's device.
    Returns (B, L, H*dh) in q.dtype."""
    B, L, D = q.shape
    T = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_mha: dtype {q.dtype} not supported")
    if D % n_heads:
        raise ValueError(f"D={D} not divisible by n_heads={n_heads}")
    if pad_additive is not None:
        padadd = pad_additive.float()
    elif key_padding_mask is not None:
        # Python scalars: a device tensor made from a host value would copy
        # and synchronise the stream on every call
        padadd = torch.where(key_padding_mask.bool(), NEG, 0.0).float()
    else:
        padadd = torch.zeros((B, T), device=q.device)
    sw = lc = None
    if gate_sw is not None:
        sw = gate_sw.float().contiguous()
        lc = locs.float().detach().contiguous()
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    v = v.to(q.dtype)
    k = k.to(q.dtype)
    return FusedMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          padadd.detach().contiguous(), sw, lc, n_heads,
                          float(scale), float(dropout_rate),
                          seed if dropout_rate > 0.0 else None)

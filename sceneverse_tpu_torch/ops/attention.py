"""Masked multi-head flash attention, forward and backward.

Port of ``sceneverse_tpu/ops/pallas/attention.py::masked_mha``, which runs
the JAX library's TPU flash-attention kernels
(``jax/experimental/pallas/ops/tpu/flash_attention.py``: the forward
``_flash_attention_kernel`` and, through the library's custom VJP, the
backward ``_flash_attention_dkv_kernel`` and ``_flash_attention_dq_kernel``).
Two hand-written CUDA kernels (``csrc/flash_attn.cu``) replace them:

``flash_fwd``
    softmax(q k^T [+ ab] + mask) v with the library's rounding points: q
    (pre-scaled by the wrapper), k and v in bf16, scores accumulated in
    f32, an online f32 softmax over key tiles of ``BK`` keys, the
    unnormalised probabilities rounded to bf16 for the p.v product (f32
    accumulation), o divided by the row sum and rounded to bf16; saves the
    row sum ``l`` and row max ``m``. Grid (Lq/64, B*H), four warps, each
    owning 16 query rows whose scores, probabilities, running max and sum
    and output stay in registers: ``mma.sync`` m16n8k16 bf16 fragments
    (documented layouts), the q.k^T accumulators repacked in registers as
    the A operand of p.v, the row max and sum two quad shuffles per row.
    Q is loaded once; K and V tiles are double-buffered by ``cp.async`` so
    the next tile's load overlaps the current products (46 KB of shared
    memory, up to four blocks per SM). The walk stops after the tile that
    holds the batch row's last valid key: later tiles are all pads and
    change no bit (alpha = 1, p = 0) of a row with a valid key.
``flash_bwd``
    the library's backward from the saved l and m: p = exp(s - m) * (1/l),
    di = sum(o * do) (f32), dv = bf16(p)^T do, dp = do v^T,
    ds = p (dp - di), dk = bf16(ds)^T q, dq = bf16(ds) k, d ab = ds. Two
    launches, so that no float atomics are needed and two runs agree bit
    for bit, both on the forward's design (mma.sync fragments in
    registers, cp.async double buffers, 16-byte row stores). The first
    grids over query tiles: each warp computes di of its 16 rows from o
    and do (written for the second launch; the library computes it beside
    its kernels) and writes dq and d ab. The second grids over key tiles
    and writes dk and dv from the transposes k q^T and v do^T, so that
    p^T and ds^T repack in registers as A operands. dq, dk and dv are
    rounded to bf16, as the library returns them in q's type. Both skip
    the key tiles past a batch row's last valid key exactly (p = 0 there:
    zero dk, dv, d ab). Shared memory 55,824 and 56,848 bytes a block,
    whatever the shape.

Bound on the card: at the GPS lengths (L = 50-300, dh = 64) the forward
moves q, k, v and o once (0.018 ms at L=300, B=32, H=12, at 3.35 TB/s)
and its bf16 products take half that at the tensor-core rate, so a block's
fixed latency (loads it cannot hide, at most 5 key tiles) sets its time;
the design keeps every (L, T) score, probability and ds tile out of device
memory.

Masking: the library expresses key padding as segment ids (pad keys
segment 0) and adds ``where(mask, 0, -0.7 * FLT_MAX)`` to the scores; the
port adds the same value at pad keys. The library pads L to a multiple of
128 and masks the padded keys the same way; the kernel instead masks by
bounds (keys past Lk take no part). For a real query that has at least one
valid key the two are the same. A query whose keys are all pads (no GPS
path has one) gets the mean of v over the Lk keys (every score rounds to
the same -0.7 * FLT_MAX), where the library's mean also runs over its
zero padding.
"""

from __future__ import annotations

import ctypes
import os

import torch

from sceneverse_tpu_torch.ops import _build

_GATE_ENV = "SCENEVERSE_FLASH_ATTN"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BK = 64  # key tile of the forward kernel, and of its twin's online softmax
_HEAD_DIM = 64


def flash_enabled() -> bool:
    """``SCENEVERSE_FLASH_ATTN`` (default off, as in the JAX package): the
    towers' attention layers take ``masked_mha`` when their probability
    dropout is inactive. Read at call time."""
    return os.environ.get(_GATE_ENV, "off").lower() in ("1", "on", "true")


# --------------------------------------------------------------- plain twins
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _scores(q, k, key_pad, ab):
    """f32 (B, H, Lq, Lk) scores: q k^T [+ ab] + the library's pad mask."""
    s = q.float() @ k.float().transpose(-1, -2)
    if ab is not None:
        s = s + ab.float()
    if key_pad is not None:
        s = s + torch.where(key_pad[:, None, None, :], MASK_VALUE, 0.0)
    return s


def flash_fwd_plain(q, k, v, key_pad=None, ab=None):
    """Plain twin of the ``flash_fwd`` kernel.

    q, k, v (B, H, L, dh) bf16 (q pre-scaled); key_pad (B, Lk) bool, True =
    pad key; ab (B, H, Lq, Lk) f32. Returns (o (B, H, Lq, dh) bf16,
    l (B, H, Lq) f32, m (B, H, Lq) f32), with the kernel's online softmax
    over key tiles of ``BK`` keys."""
    with torch.autocast(q.device.type, enabled=False):
        s_all = _scores(q, k, key_pad, ab)
        B, H, Lq, Lk = s_all.shape
        m = torch.full((B, H, Lq), -torch.inf, device=q.device)
        l = torch.zeros((B, H, Lq), device=q.device)
        acc = torch.zeros((B, H, Lq, v.shape[-1]), device=q.device)
        for j in range(0, Lk, BK):
            s = s_all[..., j:j + BK]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + _bf16(p) @ v[..., j:j + BK, :].float()
            m = m_new
        o = (acc / l[..., None]).to(torch.bfloat16)
        return o, l, m


def flash_bwd_plain(q, k, v, key_pad, ab, o, l, m, do):
    """Plain twin of the ``flash_bwd`` kernels: (dq, dk, dv bf16, d ab f32
    or None), from the saved l and m and the bf16 cotangent do."""
    with torch.autocast(q.device.type, enabled=False):
        s = _scores(q, k, key_pad, ab)
        p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
        dof = do.float()
        di = (o.float() * dof).sum(-1, keepdim=True)
        dv = _bf16(p).transpose(-1, -2) @ dof
        dp = dof @ v.float().transpose(-1, -2)
        ds = (dp - di) * p
        dsb = _bf16(ds)
        dk = dsb.transpose(-1, -2) @ q.float()
        dq = dsb @ k.float()
        bf = torch.bfloat16
        return dq.to(bf), dk.to(bf), dv.to(bf), (ds if ab is not None else None)


# ------------------------------------------------------------ kernel wrappers
def _lib():
    lib = _build.load_library("flash_attn")
    if not hasattr(lib, "_bound"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fwd_fn = _build.bind(lib, "sv_flash_fwd",
                                 [P, P, P, P, P, P, P, P, I, I, I, I, P])
        lib.bwd_fn = _build.bind(
            lib, "sv_flash_bwd",
            [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P])
        lib._bound = True
    return lib


def _check(q, k, v, key_pad, ab):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(t, f"flash.{name}", (torch.bfloat16,), 4)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, dh) or v.shape != k.shape or Lq < 1 or Lk < 1:
        raise ValueError(f"flash: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if dh != _HEAD_DIM:
        raise ValueError(f"flash: head width {dh} not instantiated (only "
                         f"{_HEAD_DIM})")
    if key_pad is not None:
        _build.require_cuda(key_pad, "flash.key_pad", (torch.bool,), 2)
        if key_pad.shape != (B, Lk):
            raise ValueError("flash: key_pad must be (B, Lk)")
    if ab is not None:
        _build.require_cuda(ab, "flash.ab", (torch.float32,), 4)
        if ab.shape != (B, H, Lq, Lk):
            raise ValueError("flash: ab must be (B, H, Lq, Lk)")
    return B, H, Lq, Lk


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, key_pad=None, ab=None):
    """Flash attention forward: (o bf16, l f32, m f32), see
    ``flash_fwd_plain``."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, key_pad, ab)
    B, H, Lq, Lk = _check(q, k, v, key_pad, ab)
    o = torch.empty_like(q)
    l = torch.empty((B, H, Lq), device=q.device, dtype=torch.float32)
    m = torch.empty_like(l)
    code = _lib().fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         _ptr(key_pad), _ptr(ab), o.data_ptr(), l.data_ptr(),
                         m.data_ptr(), B * H, H, Lq, Lk, _build.stream_ptr(q))
    _build.LAUNCHES["flash_fwd"] += 1
    _build.check(code, "flash_fwd")
    return o, l, m


def flash_bwd(q, k, v, key_pad, ab, o, l, m, do):
    """Flash attention backward: (dq, dk, dv bf16, d ab f32 or None), see
    ``flash_bwd_plain``."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, key_pad, ab, o, l, m, do)
    B, H, Lq, Lk = _check(q, k, v, key_pad, ab)
    for name, t in (("o", o), ("do", do)):
        _build.require_cuda(t, f"flash.{name}", (torch.bfloat16,), 4)
        if t.shape != q.shape:
            raise ValueError(f"flash.{name}: expected {tuple(q.shape)}")
    for name, t in (("l", l), ("m", m)):
        _build.require_cuda(t, f"flash.{name}", (torch.float32,), 3)
        if t.shape != (B, H, Lq):
            raise ValueError(f"flash.{name}: expected {(B, H, Lq)}")
    # di = sum(o * do), written by the dq launch for the dk/dv launch
    di = torch.empty_like(l)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dab = torch.empty_like(ab) if ab is not None else None
    code = _lib().bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         _ptr(key_pad), _ptr(ab), l.data_ptr(), m.data_ptr(),
                         o.data_ptr(), do.data_ptr(), di.data_ptr(),
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         _ptr(dab), B * H, H, Lq, Lk, _build.stream_ptr(q))
    _build.LAUNCHES["flash_bwd"] += 1
    _build.check(code, "flash_bwd")
    return dq, dk, dv, dab


class FlashAttention(torch.autograd.Function):
    """The library's custom VJP as an autograd op: forward saves (q, k, v,
    key_pad, ab, o, l, m); backward runs ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, key_pad, ab):
        with torch.autocast(q.device.type, enabled=False):
            o, l, m = flash_fwd(q, k, v, key_pad, ab)
        ctx.save_for_backward(q, k, v, key_pad, ab, o, l, m)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_pad, ab, o, l, m = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dab = flash_bwd(q, k, v, key_pad, ab, o, l, m,
                                        do.to(torch.bfloat16).contiguous())
        return dq, dk, dv, None, (dab if ctx.needs_input_grad[4] else None)


def masked_mha(q, k, v, key_pad_mask=None, ab=None, *, sm_scale: float):
    """softmax(q @ k^T * sm_scale [+ ab] + pad mask) @ v with the public
    contract of ``sceneverse_tpu.ops.pallas.attention.masked_mha``.

    q, k, v (B, H, L, dh); ``key_pad_mask`` (B, Lk) bool, True = pad key;
    ``ab`` (B, H, Lq, Lk) additive bias applied after the scale. q is scaled
    in its own type before the bf16 cast, as the JAX wrapper pre-scales it
    (the kernel runs at scale 1). Returns (B, H, Lq, dh) f32."""
    qb = (q * sm_scale).to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    pad = None if key_pad_mask is None else key_pad_mask.bool().contiguous()
    abf = None if ab is None else ab.float().contiguous()
    return FlashAttention.apply(qb, kb, vb, pad, abf).float()

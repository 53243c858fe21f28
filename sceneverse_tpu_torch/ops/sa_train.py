"""Trainable fused set abstraction: 3 x (1x1 conv -> train-mode BatchNorm ->
ReLU) + max-pool over grouped rows, forward and backward.

Port of ``sceneverse_tpu/ops/pallas/sa_train.py``. BatchNorm rides the
analytic fold (``fold_moments``): the batch
moments of ``x @ W`` follow from the input's mean and Gram, so each layer is
``relu((x @ W) * a + b)`` with (a, b) from the moments of the layer before.
That makes three passes over the grouped rows:

    plain:   moments(x)            -> (a1, b1)
    kernel:  sa_stats(x, L1)       -> moments(h1) -> (a2, b2)
    kernel:  sa_stats(x, L1, L2)   -> moments(h2) -> (a3, b3)
    kernel:  sa_pool(x, L1-L3)     -> pooled, argmax

``mlp_stats`` and ``mlp_pool`` are ``torch.autograd.Function``s whose
backward is a kernel that recomputes the chain (``sa_stats_bwd``,
``sa_pool_bwd``); the moment cotangents (dS, dG) flow back into the rows as
``dh = dS + h (dG + dG^T)``, so the gradients are those of BatchNorm with
batch statistics. Four hand-written CUDA kernels (``csrc/sa_train.cu``)
replace the four Pallas kernels:

``sa_stats``     ``_stats_kernel`` (:103, launched at :321)
``sa_stats_bwd`` ``_stats_bwd_kernel`` (:184, :371)
``sa_pool``      ``_pool_kernel`` (:210, :420): pooled and first argmax
``sa_pool_bwd``  ``_pool_bwd_kernel`` (:232, :466)

Numerics are the TPU kernels', and the plain twins below repeat them: bf16
operands with f32 accumulation for every product, h = relu(u * a + b) in
f32, the next layer and the moments read bf16(h), the pool takes the max of
the f32 (unrounded) h3 and the first slot that attains it.

Design on Hopper. All four kernels are one chain of tiled ``mma.sync``
m16n8k16 products over the rows, one pass per layer: the bf16 activations
(and, backward, the row cotangents: the values the twin rounds to bf16) go
to a workspace the wrapper allocates; each row pass's persistent blocks
keep their column sums in registers across the row tiles they walk, and the
dW pass splits the rows into chunks whose 64 x 64 output tiles stay in
registers until one partial write. They differ in the top pass:
``sa_stats`` keeps the column sums of bf16(h_upto) over the rows < R and
takes the Gram as a dW pass of h_upto with itself; ``sa_pool`` stages the
f32 h3 tile in shared memory and scans each center's ``ns`` rows in slot
order (so ``ns`` divides the 64-row tile, and h3 never reaches device
memory); the backwards route d_pooled to the argmax slot, or form the head
``d = dS + bf16(h) dsym`` beside ``u``. The ReLU, the mask, the routing,
the dS term and the a / b scaling run on the accumulator registers. No
float atomics anywhere: two runs are bit-identical. Each wrapper's launches
run under a ``torch.profiler.record_function`` range named after it, since
all four share the kernels' names. Bound: the bf16 products at 989
TFLOP/s (about 2.5 TFLOP per training step over the three levels) against
the f32 rows read from device memory.

Over a data-parallel world the sums ``(s, g)`` of every layer and the row
count R are summed over the ranks before ``fold`` (SyncBN,
``parallel/mesh.py::global_sums``), as JAX's ``pmean_moments`` psums them
over the mesh's axis (``sa_train.py:517-525``); the kernels are the same.
The grouped rows are taken as ``(R, C)`` row-major, as ``ball_group`` and
``group_points`` produce them: the ``(C, R)`` transpose of the TPU kernels
exists only for Mosaic's lane padding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sceneverse_tpu_torch.ops import _build
from sceneverse_tpu_torch.ops.sa_forward import _bf16
from sceneverse_tpu_torch.parallel import mesh

# rows of the kernels' tiles (``PB_BM``); ``sa_pool`` takes whole centers
# per tile
_TILE = 64
# row-group quantum of the TPU kernels' accumulators (``_ACC_ROWS``): the
# shape gate of the fused route
_ACC_ROWS = 8


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation (exact products of bf16 values)."""
    return _bf16(x) @ _bf16(w)


def _ceil16(n: int) -> int:
    return (n + 15) // 16 * 16


# --------------------------------------------------------------- plain twins
def chain_plain(x, params, upto):
    """[h_1 .. h_upto], each (R, H_j) f32: h = relu(bf16(in) @ bf16(W) * a
    + b), ``in`` the rows for layer 1 and h_{j-1} after (``_chain_fwd``)."""
    hs, h = [], x
    for w, a, b in params[:upto]:
        h = torch.relu(_dot(h, w) * a + b)
        hs.append(h)
    return hs


def mlp_stats_plain(x, params, upto):
    """(sum bf16(h_upto) (H,), bf16(h)^T bf16(h) (H, H)), f32 sums."""
    hb = _bf16(chain_plain(x, params, upto)[-1])
    return hb.sum(0), hb.t() @ hb


def _chain_bwd_plain(x, params, hs, d, nlayers):
    """``_chain_bwd_block``: cotangent d of h_nlayers back to the rows;
    returns (dx, [(dW, da, db)] per layer)."""
    grads = [None] * nlayers
    for j in range(nlayers - 1, -1, -1):
        w, a, b = params[j]
        inp = x if j == 0 else hs[j - 1]
        u = _dot(inp, w)
        dz = torch.where(u * a + b > 0, d, 0.0)
        du = dz * a
        grads[j] = (_bf16(inp).t() @ _bf16(du), (dz * u).sum(0), dz.sum(0))
        d = _bf16(du) @ _bf16(w).t()
    return d, grads


def mlp_stats_bwd_plain(x, params, upto, dS, dG):
    """VJP of ``mlp_stats_plain``: dh = dS + bf16(h) @ bf16(dG + dG^T)."""
    hs = chain_plain(x, params, upto)
    d = dS + _dot(hs[-1], dG + dG.t())
    return _chain_bwd_plain(x, params, hs, d, upto)


def mlp_pool_plain(x, params, ns):
    """Max over each center's ``ns`` consecutive rows of the f32 h3, and
    the first slot that attains it (int32)."""
    h3 = chain_plain(x, params, 3)[-1]
    g = h3.reshape(-1, ns, h3.shape[-1])
    mx = g.amax(1)
    slot = torch.arange(ns, device=x.device)[None, :, None]
    arg = torch.where(g == mx[:, None], slot, ns).amin(1)
    return mx, arg.to(torch.int32)


def mlp_pool_bwd_plain(x, params, ns, dpooled, arg):
    """VJP of ``mlp_pool_plain``: d_pooled goes to the saved argmax slot."""
    hs = chain_plain(x, params, 2)
    H3 = params[2][0].shape[1]
    slot = torch.arange(ns, device=x.device)[None, :, None]
    dh3 = torch.where(slot == arg[:, None, :].long(), dpooled[:, None, :],
                      0.0).reshape(-1, H3)
    return _chain_bwd_plain(x, params, hs, dh3, 3)


# ------------------------------------------------------------ kernel wrappers
def _lib():
    lib = _build.load_library("sa_train")
    if not hasattr(lib, "_bound"):
        P, I = ctypes.c_void_p, ctypes.c_int
        # workspace bytes: (R, C, [upto,] H1-H3, sms)
        for name in ("pool", "pool_bwd", "stats", "stats_bwd"):
            nargs = 7 if name.startswith("stats") else 6
            f = _build.bind(lib, f"sv_sa_{name}_ws", [I] * nargs)
            f.restype = ctypes.c_longlong
            setattr(lib, f"{name}_ws_fn", f)
        # (x, R, C, ns | upto, 9 layer operands, H1-H3, sms, the two
        # outputs, workspace, stream)
        fwd_args = [P, I, I, I] + [P] * 9 + [I] * 4 + [P] * 4
        lib.pool_fn = _build.bind(lib, "sv_sa_pool", fwd_args)
        lib.stats_fn = _build.bind(lib, "sv_sa_stats", fwd_args)
        # (x, R, C, ns | upto, need_dx, 9 layer operands, H1-H3, sms, the
        # top pass's two operands, dx, dw, ds, workspace, stream)
        bwd_args = [P, I, I, I, I] + [P] * 9 + [I] * 4 + [P] * 6 + [P]
        lib.pool_bwd_fn = _build.bind(lib, "sv_sa_pool_bwd", bwd_args)
        lib.stats_bwd_fn = _build.bind(lib, "sv_sa_stats_bwd", bwd_args)
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(name, x, params, nlayers):
    """Kernel operands: bf16 (C_j, H_j) weights (W1 zero-padded to a
    multiple of 16 rows) and f32 scale / shift; raises on what the kernel
    does not take."""
    _build.require_cuda(x, f"{name}.x", (torch.float32,), 2)
    k = x.shape[1]
    ops, hs = [], []
    for j, (w, a, b) in enumerate(params[:nlayers]):
        if not w.is_cuda or w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: W{j + 1} must be a CUDA f32 or bf16 "
                            f"tensor, got {w.dtype} on {w.device}")
        H = w.shape[1]
        if w.dim() != 2 or w.shape[0] != k or H % 16 or H > 1024:
            raise ValueError(f"{name}: W{j + 1} {tuple(w.shape)} must be "
                             f"({k}, H) with H a multiple of 16, <= 1024")
        for t, n in ((a, "a"), (b, "b")):
            _build.require_cuda(t, f"{name}.{n}{j + 1}", (torch.float32,), 1)
            if t.shape[0] != H:
                raise ValueError(f"{name}: {n}{j + 1} must be ({H},)")
        wb = w.to(torch.bfloat16)
        if j == 0:
            wb = torch.cat([wb, wb.new_zeros(_ceil16(k) - k, H)])
        ops += [wb.contiguous(), a.contiguous(), b.contiguous()]
        hs.append(H)
        k = H
    return ops + [None] * (9 - len(ops)), hs + [0] * (3 - len(hs))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(name, fn, *args):
    """One C entry's launches, under a profiler range named after the
    entry, counted once."""
    with torch.profiler.record_function(name):
        code = fn(*args)
    _build.LAUNCHES[name] += 1
    _build.check(code, name)


def _chain_fwd(name, fn, ws_bytes, x, ops, hs, arg, outs):
    """One call of a forward chain (``sv_sa_stats`` with arg = upto,
    ``sv_sa_pool`` with arg = ns) into ``outs``, its two outputs, with a
    workspace of ``ws_bytes``."""
    dev = x.device
    ws = torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
    _call(name, fn, x.data_ptr(), *x.shape, arg, *[_ptr(t) for t in ops],
          *hs, _sm_count(dev.index or 0), *[t.data_ptr() for t in outs],
          ws.data_ptr(), _build.stream_ptr(x))
    return outs


def sa_stats(x, params, upto):
    """(sum bf16(h_upto), Gram of bf16(h_upto)) over all rows."""
    if not x.is_cuda:
        return mlp_stats_plain(x, params, upto)
    if upto not in (1, 2, 3):
        raise ValueError(f"sa_stats: upto={upto}")
    ops, hs = _operands("sa_stats", x, params, upto)
    H = hs[upto - 1]
    lib = _lib()
    ws = lib.stats_ws_fn(*x.shape, upto, *hs, _sm_count(x.device.index or 0))
    outs = (torch.empty(H, device=x.device),
            torch.empty((H, H), device=x.device))
    return _chain_fwd("sa_stats", lib.stats_fn, ws, x, ops, hs, upto, outs)


def _chain_bwd(name, fn, ws_bytes, x, ops, hs, nlayers, arg, top, need_dx):
    """One call of a backward chain of ``nlayers`` layers (``sv_sa_pool_bwd``
    with arg = ns, ``sv_sa_stats_bwd`` with arg = upto; ``top``: the two
    operands of its top pass) with a workspace of ``ws_bytes``. Returns
    (dx or None, [(dW, da, db)] per layer)."""
    dev = x.device
    R, C = x.shape
    ws = torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
    kin = [_ceil16(C)] + hs[:nlayers - 1]
    dw = torch.empty(sum(k * h for k, h in zip(kin, hs[:nlayers])), device=dev)
    ds = torch.empty(2 * sum(hs[:nlayers]), device=dev)
    dx = torch.empty_like(x) if need_dx else None
    _call(name, fn, x.data_ptr(), R, C, arg, int(need_dx),
          *[_ptr(t) for t in ops], *hs, _sm_count(dev.index or 0),
          *[t.data_ptr() for t in top], _ptr(dx), dw.data_ptr(),
          ds.data_ptr(), ws.data_ptr(), _build.stream_ptr(x))
    grads, ow, os_ = [], 0, 0
    for j in range(nlayers):
        k, h = kin[j], hs[j]
        w = dw[ow:ow + k * h].view(k, h)
        grads.append((w[:C] if j == 0 else w, ds[os_:os_ + h],
                      ds[os_ + h:os_ + 2 * h]))
        ow += k * h
        os_ += 2 * h
    return dx, grads


def sa_stats_bwd(x, params, upto, dS, dG, need_dx=True):
    """VJP of ``sa_stats``: (dx or None, [(dW, da, db)] for layers 1..upto)."""
    if not x.is_cuda:
        dx, grads = mlp_stats_bwd_plain(x, params, upto, dS, dG)
        return (dx if need_dx else None), grads
    if upto not in (1, 2, 3):
        raise ValueError(f"sa_stats_bwd: upto={upto}")
    ops, hs = _operands("sa_stats_bwd", x, params, upto)
    H = hs[upto - 1]
    for t, shape, n in ((dS, (H,), "dS"), (dG, (H, H), "dG")):
        _build.require_cuda(t, f"sa_stats_bwd.{n}", (torch.float32,), len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sa_stats_bwd: {n} must be {shape}")
    lib = _lib()
    dsym = (dG + dG.t()).to(torch.bfloat16).contiguous()
    ws = lib.stats_bwd_ws_fn(*x.shape, upto, *hs,
                             _sm_count(x.device.index or 0))
    return _chain_bwd("sa_stats_bwd", lib.stats_bwd_fn, ws, x, ops, hs, upto,
                      upto, (dsym, dS), need_dx)


def _check_ns(name, x, ns):
    if ns < 1 or x.shape[0] % ns:
        raise ValueError(f"{name}: {x.shape[0]} rows are not whole centers "
                         f"of {ns}")
    if ns % 16 or ns > _TILE:
        raise ValueError(f"{name}: ns={ns} must be a multiple of 16, <= "
                         f"{_TILE}")


def sa_pool(x, params, ns):
    """(pooled (R // ns, H3) f32, argmax slot (R // ns, H3) int32)."""
    if not x.is_cuda:
        return mlp_pool_plain(x, params, ns)
    ops, hs = _operands("sa_pool", x, params, 3)
    _check_ns("sa_pool", x, ns)
    if _TILE % ns:
        raise ValueError(f"sa_pool: ns={ns} must divide the kernel's "
                         f"{_TILE}-row tile (16, 32 or 64), so that no "
                         "center spans two tiles")
    n = x.shape[0] // ns
    lib = _lib()
    ws = lib.pool_ws_fn(*x.shape, *hs, _sm_count(x.device.index or 0))
    outs = (torch.empty((n, hs[2]), device=x.device),
            torch.empty((n, hs[2]), device=x.device, dtype=torch.int32))
    return _chain_fwd("sa_pool", lib.pool_fn, ws, x, ops, hs, ns, outs)


def sa_pool_bwd(x, params, ns, dpooled, arg, need_dx=True):
    """VJP of ``sa_pool`` through the saved argmax."""
    if not x.is_cuda:
        dx, grads = mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
        return (dx if need_dx else None), grads
    ops, hs = _operands("sa_pool_bwd", x, params, 3)
    _check_ns("sa_pool_bwd", x, ns)
    shape = (x.shape[0] // ns, hs[2])
    _build.require_cuda(dpooled, "sa_pool_bwd.dpooled", (torch.float32,), 2)
    _build.require_cuda(arg, "sa_pool_bwd.arg", (torch.int32,), 2)
    if tuple(dpooled.shape) != shape or tuple(arg.shape) != shape:
        raise ValueError(f"sa_pool_bwd: dpooled and arg must be {shape}")
    lib = _lib()
    ws = lib.pool_bwd_ws_fn(*x.shape, *hs, _sm_count(x.device.index or 0))
    return _chain_bwd("sa_pool_bwd", lib.pool_bwd_fn, ws, x, ops, hs, 3, ns,
                      (dpooled, arg), need_dx)


# ------------------------------------------------------------- autograd ops
def _flat(params):
    return [t for layer in params for t in layer]


def _unflat(flat):
    return tuple(tuple(flat[i:i + 3]) for i in range(0, len(flat), 3))


def _param_grads(params, grads, nlayers):
    """Gradients in the parameters' types; layers beyond ``nlayers`` get
    zero cotangents (JAX ``sa_train.py:391-395``)."""
    out = []
    for j, (w, a, b) in enumerate(params):
        if j < nlayers:
            dw, da, db = grads[j]
            out += [dw.to(w.dtype), da.to(a.dtype), db.to(b.dtype)]
        else:
            out += [torch.zeros_like(w), torch.zeros_like(a),
                    torch.zeros_like(b)]
    return out


class _MlpStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, upto, *flat):
        with torch.autocast(x.device.type, enabled=False):
            s, g = sa_stats(x, _unflat(flat), upto)
        ctx.save_for_backward(x, *flat)
        ctx.upto = upto
        return s, g

    @staticmethod
    def backward(ctx, dS, dG):
        x, *flat = ctx.saved_tensors
        params, upto = _unflat(flat), ctx.upto
        H = params[upto - 1][0].shape[1]
        dS = x.new_zeros(H) if dS is None else dS.float()
        dG = x.new_zeros((H, H)) if dG is None else dG.float()
        with torch.autocast(x.device.type, enabled=False):
            dx, grads = sa_stats_bwd(x, params, upto, dS.contiguous(),
                                     dG.contiguous(),
                                     need_dx=ctx.needs_input_grad[0])
        return (dx, None, *_param_grads(params, grads, upto))


class _MlpPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ns, *flat):
        with torch.autocast(x.device.type, enabled=False):
            pooled, arg = sa_pool(x, _unflat(flat), ns)
        ctx.save_for_backward(x, arg, *flat)
        ctx.ns = ns
        ctx.mark_non_differentiable(arg)
        return pooled, arg

    @staticmethod
    def backward(ctx, dpooled, _darg):
        x, arg, *flat = ctx.saved_tensors
        params = _unflat(flat)
        if dpooled is None:
            dpooled = x.new_zeros((arg.shape[0], arg.shape[1]))
        with torch.autocast(x.device.type, enabled=False):
            dx, grads = sa_pool_bwd(x, params, ctx.ns,
                                    dpooled.float().contiguous(), arg,
                                    need_dx=ctx.needs_input_grad[0])
        return (dx, None, *_param_grads(params, grads, 3))


def mlp_stats(x, params, upto: int):
    """Sum and Gram of bf16(h_upto) over the rows of x (R, C); params is a
    tuple of (W (C_j, H_j), a (H_j,), b (H_j,))."""
    return _MlpStats.apply(x, upto, *_flat(params))


def mlp_pool(x, params, ns: int):
    """(pooled (R // ns, H3), argmax slot int32) of the 3-layer chain."""
    return _MlpPool.apply(x, ns, *_flat(params))


# ---------------------------------------------------------------- composite
def fold_moments(w: torch.Tensor, mean_in: torch.Tensor,
                 gram_in: torch.Tensor, scale, bias, eps: float):
    """Train-mode BatchNorm of ``x @ w`` from the input moments: w (C, H)
    f32, mean_in (C,), gram_in E[x x^T] (C, C). Returns (a, b, mean_h,
    var_h) with ``BN(x @ w) = (x @ w) * a + b``; gradients flow through all
    four (JAX ``sa_train.py:527-541``, ``pointnet.py:189-208``)."""
    mean_h = mean_in @ w
    var_h = torch.clamp_min(
        torch.einsum("ch,cd,dh->h", w, gram_in, w) - mean_h * mean_h, 0.0)
    a = torch.rsqrt(var_h + eps)
    if scale is not None:
        a = a * scale
    b = -mean_h * a
    if bias is not None:
        b = b + bias
    return a, b, mean_h, var_h


def fused_trainable_sa_fn(x, convs, bns, ns: int):
    """Rows x (R, C) (R = centers * ns, a center's rows consecutive);
    convs (W1, W2, W3), W_j (C_j, H_j); bns[j] = (scale, bias, eps).

    Returns (pooled (R // ns, H3) f32, ((mean_h, var_h) per layer)) for the
    running-statistics updates (JAX ``sa_train.py:505-565``); the moments
    are over the rows of every rank."""
    with torch.autocast(x.device.type, enabled=False):
        R = x.shape[0]
        x32 = x.float()

        def fold(j, s, g):
            scale, bias, eps = bns[j]
            (s, g), n = mesh.global_sums((s, g), R)
            return fold_moments(convs[j].float(), s / n, g / n, scale, bias,
                                eps)

        a1, b1, mh1, vh1 = fold(0, x32.sum(0), x32.t() @ x32)
        p1 = ((convs[0], a1, b1),)
        a2, b2, mh2, vh2 = fold(1, *mlp_stats(x, p1, 1))
        p2 = p1 + ((convs[1], a2, b2),)
        a3, b3, mh3, vh3 = fold(2, *mlp_stats(x, p2, 2))
        pooled, _ = mlp_pool(x, p2 + ((convs[2], a3, b3),), ns)
    return pooled, ((mh1, vh1), (mh2, vh2), (mh3, vh3))


def supported(G: int, m: int, ns: int) -> bool:
    """JAX ``sa_train.supported`` (:568-574) on one device: the centers
    come in whole groups of 8."""
    return (G * m) % _ACC_ROWS == 0

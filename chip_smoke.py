"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (needs one CUDA card)

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch / CUDA / nvcc versions and the card's name and power
     limit (``nvidia-smi``); exits 1 without a CUDA card.
  2. build: compiles every kernel under sceneverse_tpu_torch/csrc with nvcc
     for sm_90a, one nvcc per source, all started together (cached in
     build/kernels/).
  3. kernels: each hand-written kernel against its plain PyTorch twin on the
     card at the GPS pretrain shapes (f32 and bf16 where the path has both),
     with CUDA-event times of kernel, twin and, where one PyTorch call
     computes the same function, that call (``library_ms``: SDPA forward and
     backward for the MHA kernels; timed here, never called by the port),
     and the least time the card could take (``bound_ms``). The four
     ``sa_train`` kernels run at SA1, SA2 and SA3 of the fused slice and
     must give bit-identical outputs twice; so must ``sa_group_mlp_pool``
     (SA1, SA2) and ``sa_dense_pool`` (SA2: equal to the former bit for
     bit), on the path's input, with empty balls and with every point in
     every ball, each row with its in-ball pair share; ``fps`` (SA1, SA2)
     and ``ball_group`` (SA1, exact and fast, with and without empty balls)
     equal to their twins bit for bit and over two runs, each row also with
     the kernel's device time alone (``device_ms``: torch.profiler, without
     the wrapper's host time) and ``fps`` with its instruction floor
     (computed, so only in ``chip_smoke_kernels.json``'s ``per_shape``);
     ``flash_fwd`` / ``flash_bwd`` (L = 50, 300, 130, with and
     without the bias ``ab``; SDPA as their library yardstick; each row
     with its ``device_ms``, both backward launches together; and both at
     L = 300 with whole trailing key tiles of pad and an all-pad row, whose
     skipped tiles must change no bit) and
     ``mha_fwd`` / ``mha_bwd`` (the four GPS attention shapes; their f32
     bound counts the products at the 3xTF32 tensor-core rate).
  4. slices: ``run_torch.main`` on ``synthetic_pretrain`` at full GPS width
     (768-d, 80 objects x 1024 points, 50 + 300 tokens, batch 32): train
     steps, val and test eval, with the frozen PointNet++, unfrozen
     (``model.vision.args.freeze=False``: trainable PointNet++, train-mode
     BatchNorm), unfrozen with ``SCENEVERSE_BN_FOLD=on`` and
     ``SCENEVERSE_SA_TRAIN_FUSED=on`` set for that slice only (every SA
     level through the fused ``sa_train`` kernels), and frozen in the JAX
     package's exact mode (``EXACT_ENV``: no fused MHA, flash attention in
     eval, the batched SA2 stage, the full caption tower: the parity
     recipe of PARITY_KIT.md). Launch counters are reset just before
     each and read just after; every kernel of each path must have
     launched, the fused slice's ``sa_*`` kernels exactly as often per
     train step as three fused levels need, the exact slice's kernels
     exactly as often per forward and per eval batch as its path needs
     (``check_exact_launches``); the unfrozen runs must move every
     PointNet++ weight and BatchNorm statistic.
  5. entry: ``run_torch.main`` with ``mode=test pretrain_ckpt_path=`` the
     exact slice's ``best.pth`` loads every tensor and reproduces that
     slice's test metrics.
  6. prints the kernel table as one JSON line, the card line, and last
     ``{"ok": true, "device": {...}}``.

The device-time breakdown of the same slices is ``profile_torch.py``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

SLICE_ARGS = [
    "--config-path", os.path.join(REPO, "configs", "final"),
    "--config-name", "synthetic_pretrain",
    "data.args.max_obj_len=80", "data.args.num_points=1024",
    "data.args.max_seq_len=50", "data.args.max_scene_cap_len=300",
    "model.lm_max_predictions=16", "model.split_scene_cap_tower=True",
    "dataloader.batchsize=32", "data.synthetic_size=128", "solver.epochs=1",
]

# kernel-vs-plain tolerances, on max|kernel - plain| / max|plain|:
#  f32: both sides do the same f32 arithmetic in another summation order
#  bf16: probabilities / activations round to bf16 (step 2^-8 = 3.9e-3); an
#        element on a rounding boundary may land one step apart
TOL = {"f32": 1e-4, "bf16": 2e-2}
# SA: bf16 weights and activations on both sides (see ops/sa_forward.py)
SA_TOL = 1e-2
# ball_group: both modes gather, round and subtract like the twin: equal
# bit for bit (fast mode rounds the gathered values to bf16 on both sides)
BG_TOL = {"exact": 0.0, "fast": 0.0}
# sa_train kernels vs their twins, on max|kernel - plain| / max|plain|:
#  sums: sums and Gram over up to 2.6 M rows: f32 sums in another order,
#        and an occasional one-step bf16 flip of a single h value
#  grads: dW, da, db. Random cotangents cancel in these sums, so max|plain|
#        is ~sqrt(rows) times one row's term, while a ReLU decision that
#        lands the other way (u summed in another order) moves one row's
#        term whole: at SA2's 40960 pooled centers that is ~5e-3
#  pooled: a flipped bf16 h2 value moves the h3 of its row by one step of
#        a product term
#  rows / rows_max: per-row dx, see check_rows
#  arg_share: argmax entries that may differ from the twin's (near-ties, see
#        check_argmax); measured at most 1.8e-5 (SA3, ns=16) on an H100
SA_TRAIN_TOL = {"sums": 1e-3, "grads": 1e-2, "pooled": 1e-2, "rows": 1e-2,
                "rows_max": 0.25, "arg_share": 5e-5}
# each slice: (overrides, kernels of its path, environment for the slice
# only); the fused slice's sa_* kernels launch this often per train step
# (sa_stats twice per SA level, sa_pool once, each backward as often; eval
# runs BatchNorm on its running statistics, the literal route)
FUSED_ENV = {"SCENEVERSE_BN_FOLD": "on", "SCENEVERSE_SA_TRAIN_FUSED": "on"}
SA_TRAIN_PER_STEP = {"sa_stats": 6, "sa_stats_bwd": 6, "sa_pool": 3,
                     "sa_pool_bwd": 3}
# the JAX package's exact mode for evaluating checkpoints: no fused MHA,
# flash attention where dropout is inactive (eval), the batched SA2 stage,
# and the full caption tower (``SCENEVERSE_CAP_CLS_ONLY=off``, the parity
# recipe of PARITY_KIT.md:19-28). flash_fwd runs once per non-spatial
# attention layer of an eval batch: utterance BERT 4 + caption BERT 4 +
# unified encoder 4; the spatial 'cond' layers take the plain path
EXACT_ENV = {"SCENEVERSE_FUSED_MHA": "off", "SCENEVERSE_FLASH_ATTN": "on",
             "SCENEVERSE_SA2_BATCHED": "on", "SCENEVERSE_CAP_CLS_ONLY": "off"}
FLASH_PER_EVAL_BATCH = 12
PATHS = {
    "frozen": ([], ("fps", "sa_group_mlp_pool", "mha_fwd", "mha_bwd"), {}),
    "unfrozen": (["model.vision.args.freeze=False"],
                 ("fps", "ball_group", "mha_fwd", "mha_bwd"), {}),
    "unfrozen_fused": (["model.vision.args.freeze=False"],
                       ("fps", "ball_group", "mha_fwd", "mha_bwd",
                        *SA_TRAIN_PER_STEP), FUSED_ENV),
    "frozen_exact": ([], ("fps", "sa_group_mlp_pool", "sa_dense_pool",
                          "flash_fwd"), EXACT_ENV),
}
# H100 SXM: HBM bytes/s and peak FLOP/s by operand type (CUDA-core f32,
# dense bf16 tensor cores), from the H100 SXM datasheet; "3xtf32": f32-exact
# products on the tensor cores as three TF32 products at 495 TFLOP/s (the
# f32 rows of the mha kernels, which form them so)
HBM_RATE = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "3xtf32": 495e12 / 3}

SOURCES = {
    "fps": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
            "sceneverse_tpu/ops/pallas/sa_forward.py:229"),
    "ball_group": ("sceneverse_tpu_torch/csrc/sample_group.cu",
                   "sceneverse_tpu/ops/pallas/sample_group.py:39"),
    "sa_group_mlp_pool": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
                          "sceneverse_tpu/ops/pallas/sa_forward.py:353"),
    "mha_fwd": ("sceneverse_tpu_torch/csrc/mha_kernels.cu",
                "sceneverse_tpu/ops/pallas/mha.py:181"),
    "mha_bwd": ("sceneverse_tpu_torch/csrc/mha_kernels.cu",
                "sceneverse_tpu/ops/pallas/mha.py:229"),
    "sa_stats": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                 "sceneverse_tpu/ops/pallas/sa_train.py:103"),
    "sa_stats_bwd": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                     "sceneverse_tpu/ops/pallas/sa_train.py:184"),
    "sa_pool": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                "sceneverse_tpu/ops/pallas/sa_train.py:210"),
    "sa_pool_bwd": ("sceneverse_tpu_torch/csrc/sa_train.cu",
                    "sceneverse_tpu/ops/pallas/sa_train.py:232"),
    "sa_dense_pool": ("sceneverse_tpu_torch/csrc/sa_kernels.cu",
                      "sceneverse_tpu/ops/pallas/sa_forward.py:98"),
    # the library's flash-attention kernels (forward; through its custom
    # VJP the dk/dv and dq backward kernels), called here in the repo
    "flash_fwd": ("sceneverse_tpu_torch/csrc/flash_attn.cu",
                  "sceneverse_tpu/ops/pallas/attention.py:105"),
    "flash_bwd": ("sceneverse_tpu_torch/csrc/flash_attn.cu",
                  "sceneverse_tpu/ops/pallas/attention.py:105"),
}


def log(*a):
    print(*a, flush=True)


def phase_env():
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("[env] torch.cuda.is_available() is False: this smoke test runs "
            "only on a CUDA card")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    from sceneverse_tpu_torch.ops import _build

    nv = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                        text=True).stdout.strip().splitlines()
    log(f"[env] nvcc: {nv[-1] if nv else '?'}")
    log(f"[env] card: {card}  device_count={torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from sceneverse_tpu_torch.ops import _build

    t0 = time.time()
    names = _build.build_all()
    dt = time.time() - t0
    log(f"[build] {names} built for sm_90a in {dt:.1f} s "
        f"({_build.NVCC_FLAGS})")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for n, txt in _build.LAST_BUILD_LOG.items():
            f.write(f"== {n}\n{txt}\n")
    for n, txt in _build.LAST_BUILD_LOG.items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {n}: {line.strip()}")
    return dt


def cuda_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, *kernels, reps=5):
    """Median device duration (torch.profiler) of one call of ``fn``: the
    launches of the kernels whose names hold one of ``kernels``, summed per
    call, over the last ``reps`` of ``reps + 2`` traced calls after a
    warm-up: the kernels alone, without the wrapper's host time that a
    single call's CUDA events include. The tracer has been seen to drop
    launches late in a long process (once 6 of 7 of a window; cause not
    known): a window with fewer than ``reps`` of a kernel is traced again,
    three such windows fail, and each window opens and closes with 50 ms
    of host sleep, in case the drops are launches that the trace's clock
    places outside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps + 2):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        per_kernel = []
        for kernel in kernels:
            traced = sorted((e.time_range.start,
                             e.time_range.elapsed_us() / 1e3)
                            for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and kernel in e.name)
            if len(traced) > reps + 2:
                raise AssertionError(f"device_ms: {len(traced)} launches of "
                                     f"{kernel} traced in {reps + 2} calls")
            per_kernel.append([d for _, d in traced[-reps:]])
        counts = [len(d) for d in per_kernel]
        if min(counts) == reps:
            return statistics.median(sum(call) for call in zip(*per_kernel))
        # a window where the tracer dropped launches measures nothing
        log(f"[device_ms] traced {counts} launches of {kernels} in "
            f"{reps + 2} calls (window {attempt + 1} of 3)")
    raise AssertionError(f"device_ms: fewer than {reps} launches of "
                         f"{kernels} traced in three windows")


def _err(got, want):
    """(max|got - want|, max|want|)."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def bound(nbytes, flops, dtype):
    """(least ms the card could take, which of the two binds): each input
    read once and each output written once at HBM rate, against the
    operations at the peak rate of their type."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = flops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def key_bytes(valid, L, *per_key):
    """Bytes of attention operands indexed (batch, ..., key) -- k, v (B, H,
    L, dh) and ab (B, H, L, L) -- that a key-pad mask leaves needed: each
    batch row's valid keys, and all L of a row with none (its output is the
    mean of v). ``valid`` (B,) counts each row's valid prefix."""
    import torch

    keys = int(torch.where(valid > 0, valid, L).sum())
    return sum(nbytes(t) // (t.shape[0] * L) * keys for t in per_key
               if t is not None)


class Table:
    def __init__(self):
        self.rows = {}

    def add(self, name, shape, dtype, err, scale, ms, plain_ms, tol, bnd,
            library_ms=None, **extra):
        """One timed row; ``extra`` (e.g. an input's in-ball share) is
        logged and kept beside the row, apart from its shape key."""
        rel = err / max(scale, 1e-30)
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        more = "".join(f" {k}={v:.4f}" for k, v in extra.items())
        log(f"[kernel] {name:18s} {shape:34s} {dtype:9s} max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (tol {tol:g}, max|plain| {scale:.3g}) "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}){more}")
        if not (rel <= tol and math.isfinite(rel) and scale > 0):
            raise AssertionError(f"{name} {shape} {dtype}: rel err {rel} > {tol}")
        r = self.rows.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": shape, "dtype": dtype, "max_abs_err": err,
                            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bnd[0], "bound_by": bnd[1],
                            "library_ms": library_ms, **extra})


def ball_counts(xyz, centers, radius):
    """(G, m) in-ball point counts, strict d2 < r^2 as the kernels test."""
    import torch

    from sceneverse_tpu_torch.ops.pointops import _sq3

    d = xyz[:, None, :, :] - centers[:, :, None, :]
    d2 = _sq3(d[..., 0], d[..., 1], d[..., 2])
    return (d2 < torch.tensor(radius * radius, dtype=torch.float32)).sum(-1)


def sa_pairs(xyz, centers, radius, ns):
    """(pairs, points) of the SA function on this input: the (center,
    point) pairs it pools -- each center's first min(ns, N) in-ball points
    (strict d2 < r^2) in index order, point 0 for an empty ball -- and the
    distinct points those pairs use."""
    import torch

    from sceneverse_tpu_torch.ops.pointops import _sq3

    d = xyz[:, None, :, :] - centers[:, :, None, :]
    within = _sq3(d[..., 0], d[..., 1], d[..., 2]) < torch.tensor(
        radius * radius, dtype=torch.float32)
    del d
    take = within & (within.cumsum(-1) <= ns)
    take[..., 0] |= ~within.any(-1)
    return int(take.sum()), int(take.any(1).sum())


def fps_bound(G, N, m):
    # read xyz, write centers + indices; per step and point: 3 sub, 3 mul,
    # 2 add of the distance (the min and the argmax are not counted)
    return bound(G * N * 12 + G * m * 16, 8 * (m - 1) * G * N, "f32")


def fps_instr_floor(G, N, m):
    """ms of the ~10 f32 instructions per point and step that ``fps``
    issues (the 8 of the bound, none an FMA, plus the min and the compare)
    at one instruction per lane and clock: half the f32 peak, which counts
    an FMA as two operations."""
    return 10 * (m - 1) * G * N / (PEAK["f32"] / 2) * 1e3


def phase_sa(table):
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    G = 32 * 80
    levels = [  # (N, C, npoint, nsample, radius, widths)
        (1024, 6, 32, 32, 0.2, [6, 64, 64, 128]),
        (32, 131, 16, 32, 0.4, [131, 128, 128, 256]),
    ]
    pts = torch.rand((G, 1024, 6), generator=g) - 0.5  # unit-cube objects
    pts[:, -64:, :3] = 0.0  # near-origin pad points
    pts = pts.to(dev)
    for li, (N, C, m, ns, r, spec) in enumerate(levels):
        tag = f"SA{li + 1} G={G} N={N} C={C} m={m}"
        xyz = pts[..., :3].contiguous()
        got_xyz, got_idx = sa.fps(xyz, m)
        want_xyz, want_idx = sa.fps_plain(xyz, m)
        mism = int((got_idx != want_idx).sum())
        if mism:
            raise AssertionError(f"fps {tag}: {mism} indices differ")
        if not (torch.equal(got_xyz, want_xyz)
                and torch.equal(sa.fps(xyz, m)[1], got_idx)):
            raise AssertionError(f"fps {tag}: centers differ from the twin "
                                 "or between two runs")
        table.add("fps", tag, "f32", *_err(got_xyz, want_xyz),
                  cuda_ms(lambda: sa.fps(xyz, m)),
                  cuda_ms(lambda: sa.fps_plain(xyz, m)), 0.0,
                  fps_bound(G, N, m),
                  device_ms=device_ms(lambda: sa.fps(xyz, m), "sv_fps_kernel"),
                  instr_floor_ms=fps_instr_floor(G, N, m))
        ws = []
        for cin, h in zip(spec[:-1], spec[1:]):
            ws.append(torch.randn((h, cin), generator=g) / math.sqrt(cin))
            ws.append(torch.stack([torch.rand(h, generator=g) + 0.5,
                                   torch.randn(h, generator=g) * 0.1], 1))
        ops = sa.prepare_weights(*[w.to(dev) for w in ws])
        centers = got_xyz.clone()
        centers[:8] += 5.0  # objects whose balls are all empty
        # (label, centers, radius): the path's input, empty balls, and every
        # point in every ball (the most rows the compaction can leave)
        for label, ctr, rad in (("", got_xyz, r), (" +empty", centers, r),
                                (" +all-in", got_xyz, 16.0)):
            entries = [("sa_group_mlp_pool", sa.sa_group_mlp_pool,
                        sa.sa_group_mlp_pool_plain, {"nsample": ns})]
            if ns >= N:  # SA2: the dense stage of the SA2_BATCHED route
                entries.append(("sa_dense_pool", sa.sa_dense_pool,
                                sa.sa_dense_pool_plain, {}))
            outs = [check_sa_fwd(table, name, tag + label, fn, plain, pts,
                                 ctr, ops, rad, ns, spec, kw)
                    for name, fn, plain, kw in entries]
            if len(outs) == 2 and not torch.equal(*outs):
                raise AssertionError(f"sa_dense_pool {tag}{label}: not the "
                                     "dense branch of sa_group_mlp_pool")
            if not label:
                got = outs[0]
        # next level consumes this level's output, as PointNetPP does
        pts = torch.cat([got_xyz, got], -1).contiguous()


def check_sa_fwd(table, name, tag, fn, plain, pts, ctr, ops, r, ns, spec,
                 kw):
    """One SA entry twice (bit-identical) and against its twin, with its
    input's in-ball pair share. Bound, bf16 operands: layer 1's product
    once per point a pair uses and its centering term once per center,
    layers 2-3 once per pair (``sa_pairs``: in-ball pairs, an empty ball
    once on point 0); each input read once and ``pooled`` written once.
    Returns the output."""
    import torch

    G, N, _ = pts.shape
    m = ctr.shape[1]
    got = fn(pts, ctr, *ops, radius=r, **kw)
    if not torch.equal(got, fn(pts, ctr, *ops, radius=r, **kw)):
        raise AssertionError(f"{name} {tag}: two runs differ")
    want = plain(pts, ctr, *ops, radius=r, **kw)
    pairs, points = sa_pairs(pts[..., :3], ctr, r, ns)
    c, h1, h2, h3 = spec
    flops = 2 * (points * c * h1 + G * m * 3 * h1 + pairs * (h1 * h2 + h2 * h3))
    table.add(name, tag, "f32", *_err(got, want),
              cuda_ms(lambda: fn(pts, ctr, *ops, radius=r, **kw)),
              cuda_ms(lambda: plain(pts, ctr, *ops, radius=r, **kw), reps=3),
              SA_TOL, bound(nbytes(pts, ctr, want, *ops), flops, "bf16"),
              in_ball=pairs / (G * m * min(ns, N)))
    del want
    torch.cuda.empty_cache()
    return got


def phase_flash(table):
    """``flash_fwd`` and ``flash_bwd`` against their twins at the GPS
    lengths (B=32, H=12, dh=64; L 50 utterance, 300 caption, 130 unified)
    with a key-pad mask, with and without the additive bias ``ab``, and a
    random cotangent. Library yardstick: SDPA with the same boolean key
    mask (a float mask, ab with -inf at pads, where ab is given), bf16, its
    backward through autograd; timed only."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import attention as fa

    dev = torch.device("cuda")
    B, H, dh = 32, 12, 64
    g = torch.Generator(device="cpu").manual_seed(4)
    bf = torch.bfloat16
    for L in (50, 300, 130):
        valid = torch.randint(L // 3, L + 1, (B,), generator=g)
        pad = (torch.arange(L)[None] >= valid[:, None]).to(dev)
        q, k, v, do = (torch.randn((B, H, L, dh), generator=g).to(dev, bf)
                       for _ in range(4))
        q = (q.float() * 0.125).to(bf)  # the wrapper's pre-scaled q
        ab_full = torch.randn((B, H, L, L), generator=g).to(dev)
        for ab in (None, ab_full):
            tag = f"L={L}" + (" +ab" if ab is not None else "")
            o, l, m = fa.flash_fwd(q, k, v, pad, ab)
            o2, l2, m2 = fa.flash_fwd(q, k, v, pad, ab)
            if not (torch.equal(o, o2) and torch.equal(l, l2)
                    and torch.equal(m, m2)):
                raise AssertionError(f"flash_fwd {tag}: two runs differ")
            ro, rl, rm = fa.flash_fwd_plain(q, k, v, pad, ab)
            worst = max((_err(o, ro), _err(l, rl), _err(m, rm)),
                        key=lambda e: e[0] / max(e[1], 1e-30))
            heads = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            mask = ~pad[:, None, None, :]
            if ab is not None:
                mask = ab.masked_fill(pad[:, None, None, :], -torch.inf).to(bf)

            def sdpa():
                return F.scaled_dot_product_attention(*heads, attn_mask=mask)

            lib_fwd = cuda_ms(sdpa)
            o_lib = sdpa()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                o_lib, heads, do, retain_graph=True))
            del o_lib, heads
            # the products of the valid keys; k, v and ab of those keys
            work = H * L * dh * int(valid.sum())
            need = nbytes(q, pad) + key_bytes(valid, L, k, v, ab)
            table.add("flash_fwd", tag, "bf16", *worst,
                      cuda_ms(lambda: fa.flash_fwd(q, k, v, pad, ab)),
                      cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, pad, ab)),
                      TOL["bf16"],
                      bound(need + nbytes(o, l, m), 4 * work, "bf16"),
                      lib_fwd, device_ms=device_ms(
                          lambda: fa.flash_fwd(q, k, v, pad, ab),
                          "fa_fwd_kernel"))
            bargs = (q, k, v, pad, ab, ro, rl, rm, do)
            got = fa.flash_bwd(*bargs)
            again = fa.flash_bwd(*bargs)
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if b is not None):
                raise AssertionError(f"flash_bwd {tag}: two runs differ")
            want = fa.flash_bwd_plain(*bargs)
            worst = max((_err(a, b) for a, b in zip(got, want)
                         if b is not None),
                        key=lambda e: e[0] / max(e[1], 1e-30))
            # reads q, o, do, l, m, pad and the valid keys' k, v (+ ab);
            # writes dq, dk, dv (+ d ab); recomputes q.k and do.v and forms
            # dv, dk, dq over the valid keys (di, passed between the two
            # launches, is no input or output of the function)
            table.add("flash_bwd", tag, "bf16", *worst,
                      cuda_ms(lambda: fa.flash_bwd(*bargs)),
                      cuda_ms(lambda: fa.flash_bwd_plain(*bargs)),
                      TOL["bf16"],
                      bound(need + nbytes(ro, do, rl, rm)
                            + nbytes(q, k, v, ab),  # dq, dk, dv, d ab
                            10 * work, "bf16"),
                      lib_bwd, device_ms=device_ms(
                          lambda: fa.flash_bwd(*bargs), "fa_dq_kernel",
                          "fa_dkv_kernel"))
            del o, l, m, o2, l2, m2, ro, rl, rm, got, again, want
        torch.cuda.empty_cache()
    flash_pad_tail(table, g)


def flash_pad_tail(table, g):
    """``flash_fwd`` and ``flash_bwd`` at L=300 with valid lengths of 1-127
    keys, so that the kernels skip whole trailing key tiles of pad (the
    forward and the dq launch stop their walks after the tile holding a
    row's last valid key, the dk/dv launch writes zeros for a block of
    such keys), and one batch row with no valid key (it walks every tile
    and gets the mean of v). The skip is exact: each kernel's outputs equal
    its own outputs on keys cut after that tile, and dk, dv are zero on the
    skipped keys. The bounds count the operations of the valid keys and the
    bytes of q, o, l, m, do, the mask and the k, v the rows need
    (``key_bytes``), and of the outputs."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import attention as fa

    dev = torch.device("cuda")
    B, H, L, dh, bf = 32, 12, 300, 64, torch.bfloat16
    valid = torch.randint(1, 128, (B,), generator=g)
    valid[0] = 0
    pad = (torch.arange(L)[None] >= valid[:, None]).to(dev)
    q, k, v = (torch.randn((B, H, L, dh), generator=g).to(dev, bf)
               for _ in range(3))
    q = (q.float() * 0.125).to(bf)
    o, l, m = fa.flash_fwd(q, k, v, pad)
    again = fa.flash_fwd(q, k, v, pad)
    if not all(torch.equal(a, b) for a, b in zip((o, l, m), again)):
        raise AssertionError("flash_fwd pad tail: two runs differ")
    ro, rl, rm = fa.flash_fwd_plain(q, k, v, pad)
    worst = max((_err(o, ro), _err(l, rl), _err(m, rm)),
                key=lambda e: e[0] / max(e[1], 1e-30))
    mean_v = v[0].float().mean(1, keepdim=True).expand(H, L, dh)
    if (o[0].float() - mean_v).abs().max() > 2.0 ** -7:
        raise AssertionError("flash_fwd pad tail: the all-pad row is not "
                             "the mean of v")
    ends = [-(-int(valid[b]) // fa.BK) * fa.BK for b in range(B)]
    for b in range(1, 4):  # cut after the tile of the last valid key
        end = ends[b]
        cut = fa.flash_fwd(q[b:b + 1], k[b:b + 1, :, :end].contiguous(),
                           v[b:b + 1, :, :end].contiguous(),
                           pad[b:b + 1, :end].contiguous())
        if not all(torch.equal(a[b:b + 1], c) for a, c in zip((o, l, m), cut)):
            raise AssertionError(f"flash_fwd pad tail: row {b} differs from "
                                 "its cut keys")
    mask = ~pad[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    work = H * L * dh * int(valid.sum())
    table.add("flash_fwd", "L=300 pad tail", "bf16", *worst,
              cuda_ms(lambda: fa.flash_fwd(q, k, v, pad)),
              cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, pad)),
              TOL["bf16"],
              bound(nbytes(q, pad, o, l, m) + key_bytes(valid, L, k, v),
                    4 * work, "bf16"), lib,
              device_ms=device_ms(lambda: fa.flash_fwd(q, k, v, pad),
                                  "fa_fwd_kernel"))
    del o, l, m, again
    do = torch.randn((B, H, L, dh), generator=g).to(dev, bf)
    bargs = (q, k, v, pad, None, ro, rl, rm, do)
    got = fa.flash_bwd(*bargs)
    again = fa.flash_bwd(*bargs)
    if not all(torch.equal(a, b) for a, b in zip(got[:3], again[:3])):
        raise AssertionError("flash_bwd pad tail: two runs differ")
    want = fa.flash_bwd_plain(*bargs)
    worst = max((_err(a, b) for a, b in zip(got[:3], want[:3])),
                key=lambda e: e[0] / max(e[1], 1e-30))
    for a, b in zip(got[:3], want[:3]):  # the all-pad row, every tile
        err, scale = _err(a[0], b[0])
        if not err <= TOL["bf16"] * scale:
            raise AssertionError("flash_bwd pad tail: the all-pad row is "
                                 f"{err / scale:.3e} from the twin")
    dq, dk, dv, _ = got
    for b in range(1, B):
        if (dk[b, :, ends[b]:].any() or dv[b, :, ends[b]:].any()):
            raise AssertionError(f"flash_bwd pad tail: row {b} has non-zero "
                                 "dk or dv on its skipped pad keys")
    for b in range(1, 4):
        end, r = ends[b], slice(b, b + 1)
        cut = fa.flash_bwd(q[r], k[r, :, :end].contiguous(),
                           v[r, :, :end].contiguous(),
                           pad[r, :end].contiguous(), None, ro[r], rl[r],
                           rm[r], do[r])
        if not (torch.equal(dq[r], cut[0])
                and torch.equal(dk[r, :, :end], cut[1])
                and torch.equal(dv[r, :, :end], cut[2])):
            raise AssertionError(f"flash_bwd pad tail: row {b} differs from "
                                 "its cut keys")
    heads = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*heads, attn_mask=mask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, heads, do,
                                                  retain_graph=True))
    del o_lib, heads
    table.add("flash_bwd", "L=300 pad tail", "bf16", *worst,
              cuda_ms(lambda: fa.flash_bwd(*bargs)),
              cuda_ms(lambda: fa.flash_bwd_plain(*bargs)),
              TOL["bf16"],
              bound(nbytes(q, pad, ro, rl, rm, do)
                    + key_bytes(valid, L, k, v)
                    + nbytes(q, k, v),  # dq, dk, dv
                    10 * work, "bf16"), lib_bwd,
              device_ms=device_ms(lambda: fa.flash_bwd(*bargs),
                                  "fa_dq_kernel", "fa_dkv_kernel"))
    torch.cuda.empty_cache()


def phase_sample_group(table):
    """``ball_group`` at SA1 of the unfrozen slice, on the slice's kind of
    data (standard-normal points, as the synthetic dataset draws them), with
    all-pad objects and empty balls, in exact and fast mode."""
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa
    from sceneverse_tpu_torch.ops import sample_group as sg

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    G, N, C, m, ns, r = 32 * 80, 1024, 6, 32, 32, 0.2
    pts = torch.randn((G, N, C), generator=g)
    pts[-8:, :, :3] = 0.0  # all-pad objects: FPS repeats index 0
    pts = pts.to(dev)
    xyz = pts[..., :3].contiguous()
    centers, fps_idx = sa.fps(xyz, m)
    if not torch.equal(fps_idx, sa.fps_plain(xyz, m)[1]):
        raise AssertionError("fps indices differ at the ball_group shapes")
    if not bool((fps_idx[-8:] == 0).all()):
        raise AssertionError("fps on an all-pad object must repeat index 0")
    shifted = centers.clone()
    shifted[:8] += 5.0  # objects whose balls are all empty
    tag = f"SA1 G={G} N={N} C={C} m={m} ns={ns}"
    for label, ctr in (("", centers), (" +empty", shifted)):
        cnt = ball_counts(xyz, ctr, r)
        for mode in ("exact", "fast"):
            exact = mode == "exact"
            got, got_idx = sg.ball_group(pts, ctr, ns, r, exact)
            want, want_idx = sg.ball_group_plain(pts, ctr, ns, r, exact)
            mism = int((got_idx != want_idx).sum())
            if mism:
                raise AssertionError(f"ball_group {tag}{label} {mode}: "
                                     f"{mism} indices differ")
            again = sg.ball_group(pts, ctr, ns, r, exact)
            if not (torch.equal(got, want) and torch.equal(got, again[0])
                    and torch.equal(got_idx, again[1])):
                raise AssertionError(f"ball_group {tag}{label} {mode}: not "
                                     "equal to the twin or between two runs")
            # a warp stops at the ns-th hit, else scans all N points
            scanned = torch.where(cnt >= ns, want_idx[..., -1].long() + 1,
                                  torch.full_like(cnt, N)).sum().item()
            bnd = bound(nbytes(pts, ctr, want, want_idx), 8 * scanned, "f32")
            table.add("ball_group", tag + label,
                      "f32" if exact else "f32-fast", *_err(got, want),
                      cuda_ms(lambda: sg.ball_group(pts, ctr, ns, r, exact)),
                      cuda_ms(lambda: sg.ball_group_plain(pts, ctr, ns, r,
                                                          exact), reps=3),
                      BG_TOL[mode], bnd,
                      device_ms=device_ms(
                          lambda: sg.ball_group(pts, ctr, ns, r, exact),
                          "sv_ball_group_kernel"))
        log(f"[kernel] ball_group {tag}{label}: mean in-ball count "
            f"{cnt.float().mean().item():.2f}, empty balls "
            f"{int((cnt == 0).sum())}, full balls {int((cnt >= ns).sum())}")
    del pts, xyz, got, want
    torch.cuda.empty_cache()


def _sa_train_flops(R, dims, upto, kind, need_dx=True):
    """Operations of one call: the chain's products once, plus the Gram
    (stats: symmetric, so its upper triangle, R * H * (H + 1)), the dsym
    product (stats backward, a full product) and the dW and d_prev products
    of each layer (backward). dims = [C, H1, H2, H3]."""
    mm = [2 * R * k * h for k, h in zip(dims[:upto], dims[1:upto + 1])]
    H = dims[upto]
    if kind == "stats":
        return sum(mm) + R * H * (H + 1)
    if kind == "pool":
        return sum(mm)
    extra = 2 * R * H * H if kind == "stats_bwd" else 0
    back = sum(mm) + sum(mm[1:]) + (mm[0] if need_dx else 0)
    return sum(mm) + extra + back


def _tensors(o):
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(o, (tuple, list)):
        return [t for i in o for t in _tensors(i)]
    return [] if o is None else [o]


def _sa_train_check(table, name, tag, got, want, tol, bnd, ms, plain_ms):
    """Largest relative error over the outputs of one call; raises past
    ``tol``."""
    worst = max((_err(g, w) for g, w in zip(got, want)),
                key=lambda e: e[0] / max(e[1], 1e-30))
    table.add(name, tag, "f32", *worst, ms, plain_ms, tol, bnd)


def phase_sa_train(table):
    """The four ``sa_train`` kernels against their plain twins at the three
    SA levels of the fused unfreeze slice: standard-normal grouped rows,
    random weights, BN scales (0.5-1.5) and shifts, random cotangents.
    Each kernel also runs twice and must give bit-identical outputs."""
    import torch

    from sceneverse_tpu_torch.ops import sa_train as st

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    G = 32 * 80
    levels = [  # (label, centers per object, ns, dims, dx needed)
        ("SA1", 32, 32, [6, 64, 64, 128], False),
        ("SA2", 16, 32, [131, 128, 128, 256], True),
        ("SA3", 1, 16, [259, 256, 512, 768], True),
    ]
    for label, m, ns, dims, need_dx in levels:
        R = G * m * ns
        tag = f"{label} R={R} {dims[0]}->{dims[1]},{dims[2]},{dims[3]}"
        x = torch.randn((R, dims[0]), generator=g).to(dev)
        params = tuple(
            ((torch.randn((k, h), generator=g) / math.sqrt(k)).to(dev),
             (torch.rand(h, generator=g) + 0.5).to(dev),
             (torch.randn(h, generator=g) * 0.1).to(dev))
            for k, h in zip(dims[:-1], dims[1:]))
        wbytes = sum(nbytes(w.to(torch.bfloat16), a, b) for w, a, b in params)

        def twice(fn):
            a, b = fn(), fn()
            if not all(torch.equal(p, q) for p, q in zip(_tensors(a),
                                                          _tensors(b))):
                raise AssertionError(f"{fn.__name__} {tag}: two runs differ")
            return a

        for upto in (1, 2):
            H = dims[upto]

            def stats():
                return st.sa_stats(x, params, upto)
            got = twice(stats)
            want = st.mlp_stats_plain(x, params, upto)
            bnd = bound(nbytes(x, *want) + wbytes,
                        _sa_train_flops(R, dims, upto, "stats"), "bf16")
            _sa_train_check(table, "sa_stats", f"{tag} upto={upto}", got,
                            want, SA_TRAIN_TOL["sums"], bnd, cuda_ms(stats),
                            cuda_ms(lambda: st.mlp_stats_plain(x, params,
                                                               upto), 3))
            dS = torch.randn(H, generator=g).to(dev)
            dG = (torch.randn((H, H), generator=g) / H).to(dev)

            def stats_bwd():
                return st.sa_stats_bwd(x, params, upto, dS, dG, need_dx)
            dx, grads = twice(stats_bwd)
            wdx, wgrads = st.mlp_stats_bwd_plain(x, params, upto, dS, dG)
            got = [t for gr in grads for t in gr]
            want = [t for gr in wgrads for t in gr]
            bnd = bound(nbytes(x, dS, dG, *want) + wbytes
                        + (nbytes(x) if need_dx else 0),
                        _sa_train_flops(R, dims, upto, "stats_bwd", need_dx),
                        "bf16")
            _sa_train_check(table, "sa_stats_bwd", f"{tag} upto={upto}",
                            got, want, SA_TRAIN_TOL["grads"], bnd,
                            cuda_ms(stats_bwd),
                            cuda_ms(lambda: st.mlp_stats_bwd_plain(
                                x, params, upto, dS, dG), 3))
            if need_dx:
                check_rows("sa_stats_bwd dx", tag, dx, wdx)
            del got, want, grads, wgrads, dx, wdx

        def pool():
            return st.sa_pool(x, params, ns)
        pooled, arg = twice(pool)
        wpooled, warg = st.mlp_pool_plain(x, params, ns)
        check_argmax(tag, x, params, ns, pooled, arg, wpooled, warg)
        bnd = bound(nbytes(x, wpooled, warg) + wbytes,
                    _sa_train_flops(R, dims, 3, "pool"), "bf16")
        _sa_train_check(table, "sa_pool", tag, [pooled], [wpooled],
                        SA_TRAIN_TOL["pooled"], bnd, cuda_ms(pool),
                        cuda_ms(lambda: st.mlp_pool_plain(x, params, ns), 3))
        dpooled = torch.randn(pooled.shape, generator=g).to(dev)

        def pool_bwd():
            return st.sa_pool_bwd(x, params, ns, dpooled, arg, need_dx)
        dx, grads = twice(pool_bwd)
        wdx, wgrads = st.mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
        got = [t for gr in grads for t in gr]
        want = [t for gr in wgrads for t in gr]
        bnd = bound(nbytes(x, dpooled, arg, *want) + wbytes
                    + (nbytes(x) if need_dx else 0),
                    _sa_train_flops(R, dims, 3, "pool_bwd", need_dx), "bf16")
        _sa_train_check(table, "sa_pool_bwd", tag, got, want,
                        SA_TRAIN_TOL["grads"], bnd, cuda_ms(pool_bwd),
                        cuda_ms(lambda: st.mlp_pool_bwd_plain(
                            x, params, ns, dpooled, arg), 3))
        if need_dx:
            check_rows("sa_pool_bwd dx", tag, dx, wdx)
        del x, got, want, grads, wgrads, dx, wdx, pooled, wpooled
        torch.cuda.empty_cache()


def check_rows(name, tag, got, want):
    """Per-row outputs (dx): a ReLU decision that lands the other way in
    one row (u summed in another order, |z| within an ulp of 0) moves that
    row alone, so all but a 1e-4 share of the elements must be within
    ``rows`` of max|want| and none beyond ``rows_max``."""
    import torch

    scale = want.abs().max().item()
    err = (got - want).abs()
    share = (err > SA_TRAIN_TOL["rows"] * scale).float().mean().item()
    worst = err.max().item() / scale
    log(f"[kernel] {name:18s} {tag}: max_rel_err={worst:.3e}, share beyond "
        f"{SA_TRAIN_TOL['rows']:g}: {share:.2e}")
    if not (share <= 1e-4 and worst <= SA_TRAIN_TOL["rows_max"]
            and torch.isfinite(got).all()):
        raise AssertionError(f"{name} {tag}: {worst} / {share}")


def check_argmax(tag, x, params, ns, pooled, arg, wpooled, warg):
    """The argmax must equal the twin's, except at near-ties: at most an
    ``arg_share`` of the entries may differ, and where one does, the twin's
    h3 at the kernel's slot must lie within ``pooled`` of the center's own
    max|pooled| (over its channels) of the twin's max."""
    import torch

    from sceneverse_tpu_torch.ops import sa_train as st

    diff = arg != warg
    n = int(diff.sum())
    share = n / arg.numel()
    worst = 0.0
    if n:
        h3 = st.chain_plain(x, params, 3)[-1].reshape(*pooled.shape[:1], ns,
                                                      -1)
        at = torch.gather(h3, 1, arg.long()[:, None, :])[:, 0]
        center = wpooled.abs().amax(1, keepdim=True).expand_as(wpooled)
        worst = ((at - wpooled).abs()[diff]
                 / center[diff].clamp_min(1e-30)).max().item()
        del h3, at, center
    log(f"[kernel] sa_pool argmax {tag}: {n} of {arg.numel()} differ "
        f"(share {share:.2e}, tol {SA_TRAIN_TOL['arg_share']:g}), largest "
        f"gap {worst:.3e} of the center's max (tol "
        f"{SA_TRAIN_TOL['pooled']:g})")
    if share > SA_TRAIN_TOL["arg_share"] or worst > SA_TRAIN_TOL["pooled"]:
        raise AssertionError(f"sa_pool {tag}: argmax differs at {n} places "
                             f"(share {share}), gap {worst}")


def phase_mha(table):
    """``mha_fwd`` and ``mha_bwd`` against their twins at the four GPS
    attention shapes (B=32, H=12, dh=64), f32 and bf16, each run twice and
    required bit-identical. Their f32 bound counts the products at the
    3xTF32 rate of the tensor cores (``PEAK["3xtf32"]``), the way the
    kernels form them."""
    import torch
    import torch.nn.functional as F

    from sceneverse_tpu_torch.ops import mha

    dev = torch.device("cuda")
    B, H, dh = 32, 12, 64
    D = H * dh
    fmin = torch.finfo(torch.float32).min
    cases = [  # (label, L, pad kind, gate, dropout)
        ("bert L=50 additive drop0.1", 50, "additive", False, 0.1),
        ("caption L=300 additive drop0.1", 300, "additive", False, 0.1),
        ("spatial-cond L=80 keypad", 80, "keypad", True, 0.0),
        ("unified L=130 keypad drop0.1", 130, "keypad", False, 0.1),
    ]
    g = torch.Generator(device="cpu").manual_seed(1)
    for label, L, padkind, gate, rate in cases:
        valid = torch.randint(L // 3, L + 1, (B,), generator=g)
        padmask = torch.arange(L)[None] >= valid[:, None]
        pad = torch.where(padmask, fmin if padkind == "additive" else mha.NEG,
                          0.0).float().to(dev)
        sw = (torch.randn((B, H, L, 6), generator=g).to(dev) if gate else None)
        locs = (torch.randn((B, L, L, 5), generator=g).to(dev) if gate
                else None)
        base = [torch.randn((B, L, D), generator=g).to(dev) for _ in range(4)]
        scale = 1.0 / math.sqrt(dh)
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, do = (t.to(dtype) for t in base)
            args = (q, k, v, pad, sw, locs, H, scale, rate, 77)
            o, lse = mha.mha_fwd(*args)
            o2, lse2 = mha.mha_fwd(*args)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"mha_fwd {label} {dname}: two runs "
                                     "differ")
            o_ref, lse_ref = mha.mha_fwd_plain(*args)
            lerr, lscale = _err(lse, lse_ref)
            if lerr > TOL["f32"] * lscale:
                raise AssertionError(f"mha_fwd lse {label} {dname}: {lerr}")
            # library yardstick: one SDPA call on the same heads, the same
            # additive bias (pad [+ the precomputed 'cond' gate]) and dropout
            heads = [t.view(B, L, H, dh).transpose(1, 2).detach()
                     .requires_grad_() for t in (q, k, v)]
            bias = (mha._scores(torch.zeros_like(q), k, pad, sw, locs, H,
                                scale)[0] if gate
                    else pad[:, None, None, :]).to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(
                    *heads, attn_mask=bias, dropout_p=rate, scale=scale)

            lib_fwd = cuda_ms(sdpa)
            o_lib = sdpa()
            do_h = do.view(B, L, H, dh).transpose(1, 2)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                o_lib, heads, do_h, retain_graph=True))
            del o_lib
            el = q.element_size()
            qkvo = 4 * B * L * D * el
            gate_b = nbytes(sw, locs)
            work = B * H * L * L * dh
            peak = "3xtf32" if dtype == torch.float32 else dname
            table.add("mha_fwd", label, dname, *_err(o, o_ref),
                      cuda_ms(lambda: mha.mha_fwd(*args)),
                      cuda_ms(lambda: mha.mha_fwd_plain(*args)), TOL[dname],
                      bound(qkvo + nbytes(pad, lse) + gate_b, 4 * work, peak),
                      lib_fwd)
            bargs = (q, k, v, pad, sw, locs, do, o_ref, lse_ref, H, scale,
                     rate, 77)
            got = mha.mha_bwd(*bargs)
            again = mha.mha_bwd(*bargs)
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if b is not None):
                raise AssertionError(f"mha_bwd {label} {dname}: two runs "
                                     "differ")
            want = mha.mha_bwd_plain(*bargs)
            errs = [_err(a, b) for a, b in zip(got, want) if b is not None]
            worst = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
            # reads q, k, v, do, o, lse, pad (+ gate); writes dq, dk, dv
            # (+ dsw); recomputes q.k and do.v and forms dv, dq, dk
            table.add("mha_bwd", label, dname, *worst,
                      cuda_ms(lambda: mha.mha_bwd(*bargs)),
                      cuda_ms(lambda: mha.mha_bwd_plain(*bargs)), TOL[dname],
                      bound(2 * qkvo + nbytes(pad, lse) + gate_b
                            + nbytes(sw), 10 * work, peak), lib_bwd)
            del o, lse, o2, lse2, o_ref, lse_ref, got, again, want, heads, bias
        torch.cuda.empty_cache()


@contextlib.contextmanager
def gates(env):
    """``env`` set in ``os.environ`` for the block alone."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_slice(name, extra, env):
    """Drive one slice through ``run_torch.main`` with ``env`` set for it
    alone; returns its launches and its step time, throughput and peak
    memory."""
    with gates(env):
        return _run_slice(name, extra)


def _run_slice(name, extra):
    import torch

    import run_torch
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    # experiment dirs (config, metrics, best.pth) go under build/, which git
    # ignores, not into the small chiprun_out/
    args = SLICE_ARGS + extra + [
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', name)}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    result = run_torch.main(args)
    launches = dict(_build.LAUNCHES)
    trainer = result["trainer"]
    tag = f"[slice {name}]"
    log(f"{tag} launches on the path: {launches}")
    hist = trainer.history
    for row in hist["train"]:
        log(f"{tag} step {row['step']} loss {row['total_loss']:.5f} "
            f"step_s {row['step_s']:.4f}")
    steady = [r["step_s"] for r in hist["train"][1:]]
    step_s = statistics.mean(steady) if steady else float("nan")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} steps {len(hist['train'])}, steady step {step_s:.4f} s "
        f"(mean after the first), batch 32 -> {32 / step_s:.2f} scenes/s, "
        f"peak memory {peak:.2f} GiB")
    log(f"{tag} val {hist['val']}")
    log(f"{tag} test {hist['test']}")
    losses = [r["total_loss"] for r in hist["train"]]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} slice losses not finite / not 4 steps: "
                             f"{losses}")
    for key in ("val", "test"):
        if not hist[key] or not all(math.isfinite(v) for v in
                                    hist[key][-1].values()):
            raise AssertionError(f"{name} slice: {key} eval missing or not "
                                 "finite")
    for k in PATHS[name][1]:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} never launched on the {name} "
                                 "path")
    if name == "unfrozen_fused":  # every SA level took the fused path
        steps = len(hist["train"])
        for k, n in SA_TRAIN_PER_STEP.items():
            if launches.get(k, 0) != n * steps:
                raise AssertionError(f"{k}: {launches.get(k, 0)} launches, "
                                     f"expected {n} x {steps} train steps")
    info = {}
    if name == "frozen_exact":
        n_eval = sum(len(trainer.data_loaders[s]) for s in ("val", "test"))
        check_exact_launches(tag, launches, len(hist["train"]), n_eval)
        info = {"best_pth": str(trainer.ckpt_path / "best.pth"),
                "test": hist["test"][-1]}
        info.update(time_eval(tag, trainer))
    if name.startswith("unfrozen"):
        # the same seeded build the trainer made, against what it trained
        cfg = trainer.cfg
        built = build_model(cfg, generator=torch.Generator().manual_seed(
            int(cfg.get("rng_seed", 42)))).state_dict()
        trained = trainer.model.state_dict()
        pnet = [k for k in built if k.startswith(
            "point_encoder.point_feature_extractor.")
            and not k.endswith("num_batches_tracked")]
        same = [k for k in pnet
                if torch.equal(built[k], trained[k].detach().cpu())]
        log(f"{tag} PointNet++ tensors changed by training: "
            f"{len(pnet) - len(same)} of {len(pnet)}")
        if same or len(pnet) != 3 * 3 * 5 + 2:
            raise AssertionError(f"PointNet++ tensors unchanged: {same}")
    info.update({"steady_step_s": step_s, "scenes_per_s": 32 / step_s,
                 "peak_mem_gib": peak, "launches": launches})
    del result, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return info


def check_exact_launches(tag, launches, n_train, n_eval):
    """The exact-mode path: no fused MHA at all; SA1 and SA2 through
    ``sa_group_mlp_pool`` and ``sa_dense_pool`` once per forward; flash
    attention FLASH_PER_EVAL_BATCH times per eval batch and never in a
    train step (dropout is active there)."""
    want = {"mha_fwd": 0, "mha_bwd": 0, "flash_bwd": 0,
            "sa_group_mlp_pool": n_train + n_eval,
            "sa_dense_pool": n_train + n_eval,
            "flash_fwd": FLASH_PER_EVAL_BATCH * n_eval}
    got = {k: launches.get(k, 0) for k in want}
    log(f"{tag} exact-mode launches {got} ({n_train} train steps, {n_eval} "
        "eval batches)")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def time_eval(tag, trainer):
    """One more test pass, timed on the host clock around work that ends in
    a synchronise, with its own peak memory. The run has closed its
    metrics log, so this pass logs nothing."""
    import torch

    from sceneverse_tpu_torch.trainer.build import to_device

    trainer.log = lambda *a, **k: None
    loaders = trainer.data_loaders["test"]
    loaders = loaders if isinstance(loaders, list) else [loaders]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.test_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scenes = sum(len(loader.dataset) for loader in loaders)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the forwards alone, on batches made and moved to the card beforehand
    batches = [to_device(b, trainer.device) for ld in loaders for b in ld]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.forward(b)
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    log(f"{tag} test pass {dt:.4f} s for {scenes} scenes -> "
        f"{scenes / dt:.2f} eval scenes/s (forwards alone {fwd:.4f} s -> "
        f"{scenes / fwd:.2f} scenes/s), peak memory {peak:.2f} GiB")
    return {"eval_s": dt, "eval_scenes_per_s": scenes / dt,
            "eval_forward_s": fwd, "eval_forward_scenes_per_s": scenes / fwd,
            "eval_peak_mem_gib": peak}


def phase_entry(exact):
    """``run_torch.main`` with ``mode=test pretrain_ckpt_path=`` the
    frozen_exact slice's ``best.pth``, under the same gates: it loads every
    tensor of the model's state dict and reproduces the slice's test
    metrics (``best_result`` aside: the evaluator's best over a run's
    passes, val included)."""
    with gates(EXACT_ENV):
        return _run_entry(exact)


def _run_entry(exact):
    import torch

    import run_torch
    from sceneverse_tpu_torch.ops import _build

    tag = "[entry mode=test]"
    args = SLICE_ARGS + [
        "mode=test", f"pretrain_ckpt_path={exact['best_pth']}",
        f"base_dir={os.path.join(REPO, 'build', 'smoke_runs', 'exact_test')}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    result = run_torch.main(args)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = result["trainer"]
    n_state = len(trainer.model.state_dict())
    log(f"{tag} loaded {trainer.pretrain_loaded} of {n_state} tensors; "
        f"launches {launches}; peak memory {peak:.2f} GiB")
    if trainer.pretrain_loaded != n_state:
        raise AssertionError(f"{tag}: loaded {trainer.pretrain_loaded} of "
                             f"{n_state} tensors")
    if trainer.history["train"] or list(trainer.data_loaders) != ["test"]:
        raise AssertionError(f"{tag}: trained or built other loaders")
    check_exact_launches(tag, launches, 0, len(trainer.data_loaders["test"]))
    got, want = result["results"], exact["test"]
    keys = sorted(set(want) - {"best_result"})
    if set(got) != set(want):
        raise AssertionError(f"{tag}: metrics {sorted(got)} vs {sorted(want)}")
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              if got[k] != want[k] else 0.0 for k in keys)
    log(f"{tag} test metrics {got}; max relative difference to the slice's "
        f"{rel:.3e}")
    if not rel <= 1e-6:
        raise AssertionError(f"{tag}: test metrics differ by {rel}")
    info = time_eval(tag, trainer)
    info.update({"loaded": trainer.pretrain_loaded, "state_tensors": n_state,
                 "max_rel_diff": rel, "peak_mem_gib": peak,
                 "launches": launches})
    del result, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return info


def main():
    sys.path.insert(0, REPO)
    card = phase_env()
    import torch

    phase_build()
    table = Table()
    phase_sa(table)
    phase_sample_group(table)
    phase_mha(table)
    phase_sa_train(table)
    phase_flash(table)
    slices = {name: phase_slice(name, extra, env)
              for name, (extra, _, env) in PATHS.items()}
    entry = phase_entry(slices["frozen_exact"])
    kernels = []
    for name, (src, rep) in SOURCES.items():
        row = table.rows[name]
        # headline: the heaviest call shape of the main path, f32 where the
        # kernel has an f32 form (no GPS caller passes flash attention a
        # bias, and the SA rows' "+all-in" balls hold every point: neither
        # is a main-path input)
        shapes = [r for r in row["shapes"]
                  if "+ab" not in r["shape"] and "+all-in" not in r["shape"]]
        head = max([r for r in shapes if r["dtype"] == "f32"] or shapes,
                   key=lambda r: r["ms"])
        by_path = {p: s["launches"].get(name, 0) for p, s in slices.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            **({"device_ms": head["device_ms"]} if "device_ms" in head
               else {})})
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "per_shape": table.rows,
                   "slices": slices, "entry": entry, "card": card}, f,
                  indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

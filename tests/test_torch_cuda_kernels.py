"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. CUDA kernels have no CPU or interpret mode, so every test here needs a
CUDA card and skips without one (decided inside the fixture, never at
import). On a GPU machine, without the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances on max|kernel - plain| / max|plain|: f32 1e-4 (same f32
arithmetic, another summation order); bf16 2e-2 (an element on a bf16
rounding boundary may land one step, 2^-8, apart); SA 1e-2 (bf16 weights and
activations on both sides); FPS indices and centers and ball-query
indices exactly equal, and over two runs; ball_group's grouped rows exactly
equal (the same gather, bf16 rounding and f32 subtraction on both sides); mha_fwd / mha_bwd bit-identical over two
runs, f32 (3xTF32 products) within 1e-4 and bf16 within 2e-2; sa_train: the tolerances of chip_smoke.py's
SA_TRAIN_TOL (its comment gives the reasons), argmax equal but at
near-ties, and every kernel bit-identical over two runs; sa_group_mlp_pool,
sa_dense_pool (one kernel; the latter equal to the former's dense branch bit
for bit) and the flash kernels bit-identical over two runs, the SA entries
within the SA 1e-2, flash_fwd / flash_bwd within 2e-2 (bf16 outputs); the exact-mode
model forward on the card within 3e-2 of the same forward on the CPU
(flash and SA outputs rounded to bf16 at the same points, sums in another
order, through 2-layer towers)."""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


SA_LEVELS = {  # N, C, m, nsample, radius, widths
    "SA1": (1024, 6, 32, 32, 0.2, [6, 64, 64, 128]),
    "SA2": (32, 131, 16, 32, 0.4, [131, 128, 128, 256]),
}


def _sa_case(dev, level, G, seed=0):
    """Unit-cube objects with near-origin pad points and random folded
    weights at one SA level's widths: (pts, kernel operands)."""
    from sceneverse_tpu_torch.ops import sa_forward as sa

    N, C, _, _, _, spec = SA_LEVELS[level]
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((G, N, C), generator=g) - 0.5
    pts[:, -5:, :3] = 0.0
    ws = []
    for cin, h in zip(spec[:-1], spec[1:]):
        ws += [torch.randn((h, cin), generator=g) / math.sqrt(cin),
               torch.stack([torch.rand(h, generator=g) + 0.5,
                            torch.randn(h, generator=g) * 0.1], 1)]
    return pts.to(dev), sa.prepare_weights(*[w.to(dev) for w in ws])


def _pair_rows(pts, ctr, r, ns):
    """(G, m) rows the kernel gives each center: its first min(ns, N)
    in-ball points, one for an empty ball."""
    from sceneverse_tpu_torch.ops.pointops import _sq3

    d = pts[:, None, :, :3] - ctr[:, :, None, :]
    d2 = _sq3(d[..., 0], d[..., 1], d[..., 2])
    cnt = (d2 < torch.tensor(r * r, dtype=torch.float32)).sum(-1)
    return cnt.clamp(1, min(ns, pts.shape[1]))


@pytest.mark.parametrize("case", ["plain", "wide", "empty", "all_in", "G1",
                                  "ragged_grid"])
@pytest.mark.parametrize("level", ["SA1", "SA2"])
def test_sa_kernels_match_plain(dev, level, case):
    """``fps`` equal to its twin; both SA entries (one kernel) against
    their twins, bit-identical over two runs, ``sa_dense_pool`` equal to
    ``sa_group_mlp_pool``'s dense branch bit for bit: the path's input
    (SA1 balls hold more points than nsample; 8-row slots of several
    centers), 1.5x its radius (a center's rows span two 64-row tiles), an
    object whose balls are all empty, every point in every ball
    (m * min(ns, N) rows, slots of one center), one object, and a G that is
    no multiple of the persistent grid."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa

    N, C, m, ns, r, spec = SA_LEVELS[level]
    # 531: above the persistent grid (an H100's 132 SMs x 1 or 2 blocks)
    # and a multiple of neither 132 nor 264
    G = {"G1": 1, "ragged_grid": 531}.get(case, 48)
    pts, ops = _sa_case(dev, level, G)
    before = _build.LAUNCHES["fps"]
    ctr, idx = sa.fps(pts[..., :3].contiguous(), m)
    ctr_ref, idx_ref = sa.fps_plain(pts[..., :3].contiguous(), m)
    assert torch.equal(idx, idx_ref) and torch.equal(ctr, ctr_ref)
    assert _build.LAUNCHES["fps"] == before + 1
    if case == "empty":
        ctr[0] += 5.0  # every ball of object 0 empty
        ctr[1, :3] += 5.0
    if case == "all_in":
        r = 16.0
    if case == "wide":
        r = 1.5 * r
    rows = _pair_rows(pts, ctr, r, ns)
    end = rows.cumsum(1)
    if case == "wide":
        assert ((end - rows) // 64 != (end - 1) // 64).any()  # spans tiles
    if case == "plain":
        assert ((end - rows) // 8 != (end - 1) // 8).any()  # mixed slots
        if level == "SA1":
            assert (_pair_rows(pts, ctr, r, N) >= ns).any()  # truncated balls
    if case == "all_in":
        assert (rows == min(ns, N)).all()
    entries = [("sa_group_mlp_pool", sa.sa_group_mlp_pool,
                sa.sa_group_mlp_pool_plain, {"nsample": ns})]
    if ns >= N:
        entries.append(("sa_dense_pool", sa.sa_dense_pool,
                        sa.sa_dense_pool_plain, {}))
    outs = []
    for name, fn, plain, kw in entries:
        before = _build.LAUNCHES[name]
        got = fn(pts, ctr, *ops, radius=r, **kw)
        again = fn(pts, ctr, *ops, radius=r, **kw)
        want = plain(pts, ctr, *ops, radius=r, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 2
        assert torch.equal(got, again)
        assert want.abs().max() > 0 and _rel(got, want) <= 1e-2
        outs.append(got)
    if len(outs) == 2:
        assert torch.equal(*outs)


def _fps_points(kind, G, N, seed=3):
    """G objects of N points, the last all padding when G > 1 (FPS repeats
    index 0); "grid": coordinates on a coarse grid, so that many distances
    tie (the CPU edge cases of tests/test_torch_ops.py)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if kind == "grid":
        x = (rng.randint(-2, 3, size=(G, N, 3)) * 0.5).astype(np.float32)
    else:
        x = rng.randn(G, N, 3).astype(np.float32)
    if G > 1:
        x[-1] = 0.0
    return torch.from_numpy(x)


FPS_CASES = ([(kind, 3, N, m) for kind in ("randn", "grid")
              for N in (17, 1000) for m in (1, N)]
             + [("randn", 1, 1024, 32),     # one object
                ("randn", 531, 1024, 32),   # no multiple of 4 objects a block
                ("randn", 531, 32, 16),     # SA2's N, one point per lane
                ("grid", 4, 2048, 64),      # above the register budget
                ("randn", 4, 2048, 2048)])


@pytest.mark.parametrize("kind,G,N,npoint", FPS_CASES)
def test_fps_matches_plain(dev, kind, G, N, npoint):
    """``fps`` indices and centers equal to its twin's bit for bit, and
    over two runs."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa

    xyz = _fps_points(kind, G, N).to(dev)
    before = _build.LAUNCHES["fps"]
    ctr, idx = sa.fps(xyz, npoint)
    ctr2, idx2 = sa.fps(xyz, npoint)
    ctr_ref, idx_ref = sa.fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fps"] == before + 2
    assert torch.equal(idx, idx_ref) and torch.equal(ctr, ctr_ref)
    assert torch.equal(idx, idx2) and torch.equal(ctr, ctr2)
    if G > 1:
        assert (idx[-1] == 0).all()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G,N,C,m,ns,r", [
    (48, 256, 6, 32, 32, 0.2),      # small
    (2560, 1024, 6, 32, 32, 0.2),   # SA1 of the unfrozen slice
    (1, 1024, 6, 32, 32, 0.2),      # one object
    (531, 1024, 6, 32, 32, 0.2),    # no multiple of the persistent grid
    (48, 2048, 6, 64, 48, 0.2),     # two chunks of centers
    (48, 4096, 6, 64, 48, 0.2),     # one buffer a block
    (3, 81, 3, 5, 17, 0.5),         # nothing 16-byte aligned
    (3, 81, 6, 5, 17, 0.5),         # C = 6, element-wise stores
    (2, 9642, 6, 32, 32, 0.2),      # the direct layout: the largest N at C = 6
    (3, 8000, 7, 5, 17, 0.5),       # the direct layout, nothing aligned
    # the CPU edge cases (tests/test_torch_sample_group.py): every ball
    # full (radius 100) or empty (radius 0), C 3 and 9, nsample 16 and 64
    *[(2, 80, C, 8, ns, r) for C in (3, 9) for ns in (16, 64)
      for r in (100.0, 0.0)],
])
def test_ball_group_matches_plain(dev, G, N, C, m, ns, r, exact):
    """``ball_group`` indices and grouped values equal to its twin's bit
    for bit, and over two runs; with G > 2 the first two objects' balls
    empty."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa
    from sceneverse_tpu_torch.ops import sample_group as sg

    g = torch.Generator().manual_seed(2)
    pts = torch.randn((G, N, C), generator=g)
    if G > 4:
        pts[-2:, :, :3] = 0.0  # all-pad objects
    pts = pts.to(dev)
    ctr, _ = sa.fps(pts[..., :3].contiguous(), m)
    if G > 2:
        ctr[:2] += 5.0  # empty balls
    before = _build.LAUNCHES["ball_group"]
    got, idx = sg.ball_group(pts, ctr, ns, r, exact)
    got2, idx2 = sg.ball_group(pts, ctr, ns, r, exact)
    want, want_idx = sg.ball_group_plain(pts, ctr, ns, r, exact)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ball_group"] == before + 2
    assert torch.equal(idx, want_idx) and torch.equal(got, want)
    assert torch.equal(idx, idx2) and torch.equal(got, got2)
    if r == 0.0:
        assert (idx == 0).all()
    elif r == 100.0:
        assert (idx == torch.arange(ns, device=dev, dtype=idx.dtype)).all()
    elif G > 2:
        assert (idx[:2] == 0).all()
    grouped, new_xyz, fps_idx, bq_idx = sg.fused_sample_and_group(
        pts, m, ns, r, exact)
    ref = sg.sample_and_group_plain(pts, m, ns, r, exact)
    for a, b in zip((grouped, new_xyz, fps_idx, bq_idx), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L,T,gate,rate,padkind", [
    (50, 50, False, 0.1, "keypad"), (80, 80, True, 0.0, "keypad"),
    (130, 130, False, 0.1, "keypad"), (40, 72, False, 0.0, "keypad"),
    # the caption layers: the additive HF row (finfo(f32).min at pads)
    (300, 300, False, 0.1, "additive"),
    # ragged: neither length a multiple of 16 or 64
    (37, 300, True, 0.1, "keypad"),
    # the grounding variants' cross-attention: 80 object queries over 50
    # text keys, 50 over 80
    (80, 50, False, 0.1, "keypad"), (50, 80, False, 0.1, "keypad"),
])
def test_mha_kernels_match_plain(dev, dtype, tol, L, T, gate, rate, padkind):
    from sceneverse_tpu_torch.ops import mha

    g = torch.Generator().manual_seed(1)
    B, H, dh = 3, 12, 64
    q = torch.randn((B, L, H * dh), generator=g).to(dev, dtype)
    k, v = (torch.randn((B, T, H * dh), generator=g).to(dev, dtype)
            for _ in range(2))
    do = torch.randn((B, L, H * dh), generator=g).to(dev, dtype)
    padval = (torch.finfo(torch.float32).min if padkind == "additive"
              else mha.NEG)
    pad = torch.where(torch.rand((B, T), generator=g) > 0.8, padval,
                      0.0).float().to(dev)
    pad[:, 0] = 0.0
    sw = torch.randn((B, H, L, 6), generator=g).to(dev) if gate else None
    locs = torch.randn((B, L, T, 5), generator=g).to(dev) if gate else None
    seed = torch.tensor([5], device=dev)  # read from device memory
    args = (q, k, v, pad, sw, locs, H, 0.125, rate, seed)
    o, lse = mha.mha_fwd(*args)
    o2, lse2 = mha.mha_fwd(*args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = mha.mha_fwd_plain(*args)
    assert _rel(o, o_ref) <= tol and _rel(lse, lse_ref) <= tol
    bargs = (q, k, v, pad, sw, locs, do, o_ref, lse_ref, H, 0.125, rate,
             seed)
    got = mha.mha_bwd(*bargs)
    again = mha.mha_bwd(*bargs)
    want = mha.mha_bwd_plain(*bargs)
    for a, a2, b in zip(got, again, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert torch.equal(a, a2)
            assert _rel(a, b) <= tol


def _sa_train_case(dev, R, dims, seed=3, ns=0, dup=0):
    """Rows, weights, BN scales and shifts; with ``dup``, each center's
    ``ns`` rows are copies of ``dup`` distinct rows in a random order.
    Returns (generator, x, params, the distinct row each slot holds or
    None)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((R, dims[0]), generator=g)
    src = None
    if dup:
        src = torch.randint(0, dup, (R // ns, ns), generator=g)
        base = x[:R // ns * dup].reshape(R // ns, dup, dims[0])
        x = base[torch.arange(R // ns)[:, None], src].reshape(R, dims[0])
    x = x.to(dev)
    params = tuple(
        ((torch.randn((k, h), generator=g) / math.sqrt(k)).to(dev),
         (torch.rand(h, generator=g) + 0.5).to(dev),
         (torch.randn(h, generator=g) * 0.1).to(dev))
        for k, h in zip(dims[:-1], dims[1:]))
    return g, x, params, src


def _same_twice(fn):
    import chip_smoke

    a, b = fn(), fn()
    ta, tb = chip_smoke._tensors(a), chip_smoke._tensors(b)
    assert len(ta) == len(tb) and all(torch.equal(p, q)
                                      for p, q in zip(ta, tb))
    return a


@pytest.mark.parametrize("R,ns,dims,need_dx,dup", [
    (16 * 37, 16, [6, 16, 16, 32], True, 0),            # small, ragged tiles
    (16 * 37, 16, [259, 256, 512, 768], True, 0),       # SA3 widths, ragged
    (2560 * 32 * 32, 32, [6, 64, 64, 128], False, 0),   # SA1
    (2560 * 16 * 32, 32, [131, 128, 128, 256], True, 0),  # SA2
    (2560 * 16, 16, [259, 256, 512, 768], True, 0),     # SA3
    (2560 * 32 * 32, 32, [6, 64, 64, 128], True, 0),    # the other need_dx
    (2560 * 16 * 32, 32, [131, 128, 128, 256], False, 0),
    (2560 * 16, 16, [259, 256, 512, 768], False, 0),
    (64 * 37, 64, [6, 16, 16, 32], True, 0),            # one center per tile
    (16 * 37, 16, [6, 48, 80, 112], True, 0),           # column tails
    (16 * 37, 16, [6, 16, 16, 32], True, 3),            # ties: repeated rows
])
def test_sa_train_kernels_match_plain(dev, R, ns, dims, need_dx, dup):
    """The four ``sa_train`` kernels within ``SA_TRAIN_TOL`` of their twins
    (dx by ``check_rows``, the argmax by ``check_argmax``), each run twice
    and bit-identical, one launch counted per call. With repeated rows in
    each center, equal positive maxima must take the first slot that
    holds them, as the twin and the TPU kernel do."""
    from chip_smoke import SA_TRAIN_TOL as TOL
    from chip_smoke import check_argmax, check_rows
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_train as st

    g, x, params, src = _sa_train_case(dev, R, dims, ns=ns, dup=dup)
    before = dict(_build.LAUNCHES)
    for upto in (1, 2):
        H = dims[upto]
        got = _same_twice(lambda: st.sa_stats(x, params, upto))
        want = st.mlp_stats_plain(x, params, upto)
        for a, b in zip(got, want):
            assert _rel(a, b) <= TOL["sums"]
        dS = torch.randn(H, generator=g).to(dev)
        dG = (torch.randn((H, H), generator=g) / H).to(dev)
        dx, grads = _same_twice(lambda: st.sa_stats_bwd(
            x, params, upto, dS, dG, need_dx))
        wdx, wgrads = st.mlp_stats_bwd_plain(x, params, upto, dS, dG)
        assert (dx is None) != need_dx
        for a, b in zip(grads, wgrads):
            for p, q in zip(a, b):
                assert _rel(p, q) <= TOL["grads"]
        if need_dx:
            check_rows("sa_stats_bwd dx", f"R={R}", dx, wdx)
    pooled, arg = _same_twice(lambda: st.sa_pool(x, params, ns))
    wpooled, warg = st.mlp_pool_plain(x, params, ns)
    assert _rel(pooled, wpooled) <= TOL["pooled"]
    check_argmax(f"R={R}", x, params, ns, pooled, arg, wpooled, warg)
    if dup:
        src = src.to(dev)
        same = src[:, :, None] == src[:, None, :]  # (center, slot, slot)
        first = same.int().argmax(-1)  # the first slot holding that row
        at = arg.long()
        assert torch.equal(first.gather(1, at), at)
        repeated = same.sum(-1).gather(1, at) > 1
        assert (repeated & (pooled > 0)).any()  # positive ties were taken
    dpooled = torch.randn(pooled.shape, generator=g).to(dev)
    dx, grads = _same_twice(lambda: st.sa_pool_bwd(
        x, params, ns, dpooled, arg, need_dx))
    wdx, wgrads = st.mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
    assert (dx is None) != need_dx
    for a, b in zip(grads, wgrads):
        for p, q in zip(a, b):
            assert p.shape == q.shape and _rel(p, q) <= TOL["grads"]
    if need_dx:
        check_rows("sa_pool_bwd dx", f"R={R}", dx, wdx)
    torch.cuda.synchronize()
    for k, n in (("sa_stats", 4), ("sa_stats_bwd", 4), ("sa_pool", 2),
                 ("sa_pool_bwd", 2)):
        assert _build.LAUNCHES[k] == before.get(k, 0) + n


def test_sa_train_autograd_on_the_card_takes_the_kernels(dev):
    """The composite on CUDA tensors launches every kernel, and its
    gradients match the same composite on the CPU (plain twins)."""
    from sceneverse_tpu_torch.modules.layers.pointnet import (
        SharedMLP, fused_trainable_sa)
    from sceneverse_tpu_torch.ops import _build

    torch.manual_seed(0)
    mlp = SharedMLP([6, 16, 16, 32]).train()
    grouped = torch.randn((8, 4, 16, 6))
    outs = {}
    for d in ("cpu", dev):
        m = mlp.to(d)
        m.zero_grad()
        x = grouped.to(d).detach().requires_grad_()
        before = dict(_build.LAUNCHES)
        y = fused_trainable_sa(x, m)
        y.sum().backward()
        # copies: moving the module next moves its .grad in place
        outs[str(d)] = tuple(t.detach().cpu().clone() for t in (
            y, x.grad, m.layer0.conv.weight.grad))
        launched = {k: _build.LAUNCHES[k] - before.get(k, 0)
                    for k in ("sa_stats", "sa_stats_bwd", "sa_pool",
                              "sa_pool_bwd")}
        assert launched == ({k: 0 for k in launched} if d == "cpu" else
                            {"sa_stats": 2, "sa_stats_bwd": 2, "sa_pool": 1,
                             "sa_pool_bwd": 1})
    (y0, dx0, dw0), (y1, dx1, dw1) = outs["cpu"], outs[str(dev)]
    # the same rounding points on both devices, sums in another order
    # (measured 2e-7 / 2e-6 / 3e-6 at this size)
    for a, b in ((y1, y0), (dw1, dw0), (dx1, dx0)):
        assert _rel(a, b) <= 1e-3


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from sceneverse_tpu_torch.ops import mha
    from sceneverse_tpu_torch.ops import sample_group as sg

    pts = torch.randn((2, 64, 6), device=dev)
    ctr = pts[:, :8, :3].contiguous()
    with pytest.raises(TypeError):  # f64 points
        sg.ball_group(pts.double(), ctr, 4, 0.5)
    with pytest.raises(ValueError):  # centers not (G, m, 3)
        sg.ball_group(pts, pts[:, :8, :4].contiguous(), 4, 0.5)
    with pytest.raises(ValueError):  # an object beyond shared memory
        sg.ball_group(torch.zeros((1, 20000, 6), device=dev),
                      ctr[:1], 4, 0.5)
    # 4 (N C + 8 ns) bytes of the 227 KB: at C = 6, m = ns = 32 the largest
    # object takes N = 9642 and N = 9643 is refused
    ctr32 = torch.zeros((1, 32, 3), device=dev)
    grouped, _ = sg.ball_group(torch.zeros((1, 9642, 6), device=dev),
                               ctr32, 32, 0.2)
    assert grouped.shape == (1, 32, 32, 6)
    with pytest.raises(ValueError):
        sg.ball_group(torch.zeros((1, 9643, 6), device=dev), ctr32, 32, 0.2)

    q = torch.randn((2, 8, 64), device=dev, dtype=torch.float16)
    pad = torch.zeros((2, 8), device=dev)
    with pytest.raises(TypeError):
        mha.mha_fwd(q, q, q, pad, None, None, 4, 0.25)
    q = torch.randn((2, 8, 48 * 2), device=dev)
    with pytest.raises(ValueError):  # head width 48 not instantiated
        mha.mha_fwd(q, q, q, pad, None, None, 2, 0.25)

    from sceneverse_tpu_torch.ops import sa_train as st

    _, x, params, _ = _sa_train_case(dev, 64, [6, 16, 16, 32])
    with pytest.raises(TypeError):  # bf16 rows
        st.sa_stats(x.to(torch.bfloat16), params, 1)
    with pytest.raises(ValueError):  # width 24, not a multiple of 16
        _, x2, p2, _ = _sa_train_case(dev, 64, [6, 24, 16, 32])
        st.sa_stats(x2, p2, 1)
    with pytest.raises(ValueError):  # W1 that does not take 6 channels
        st.sa_pool(x[:, :5].contiguous(), params, 16)
    with pytest.raises(ValueError):  # ns not a multiple of 16
        st.sa_pool(x, params, 8)
    with pytest.raises(ValueError):  # rows not whole centers
        st.sa_pool(x[:40].contiguous(), params, 16)
    x48 = torch.cat([x, x[:32]])  # 96 rows: two centers of 48
    with pytest.raises(ValueError, match="divide"):  # 48 does not divide 64
        st.sa_pool(x48, params, 48)
    # the backward routes centers that straddle its tiles: it takes ns = 48
    z = torch.zeros((2, 32), device=dev)
    dx48, _ = st.sa_pool_bwd(x48, params, 48, z, z.int())
    assert dx48.shape == x48.shape and torch.isfinite(dx48).all()
    pooled, arg = st.sa_pool(x, params, 16)
    with pytest.raises(ValueError):  # argmax of another shape
        st.sa_pool_bwd(x, params, 16, pooled, arg[:2].contiguous())
    with pytest.raises(TypeError):  # argmax not int32
        st.sa_pool_bwd(x, params, 16, pooled, arg.long())
    with pytest.raises(ValueError):  # dG not (H, H)
        st.sa_stats_bwd(x, params, 1, torch.zeros(16, device=dev),
                        torch.zeros((16, 8), device=dev))
    with pytest.raises(ValueError):  # dS not (H,)
        st.sa_stats_bwd(x, params, 1, torch.zeros(8, device=dev),
                        torch.zeros((16, 16), device=dev))

    from sceneverse_tpu_torch.ops import sa_forward as sa

    pts, ops = _sa_case(dev, "SA1", 2)
    ctr = pts[:, :32, :3].contiguous()
    w2, w3 = ops[3], ops[6]
    narrow = list(ops)
    narrow[6], narrow[7], narrow[8] = (w3[:, :64].contiguous(),
                                       ops[7][:64].contiguous(),
                                       ops[8][:64].contiguous())
    with pytest.raises(ValueError, match="not instantiated"):  # (64, 64, 64)
        sa.sa_group_mlp_pool(pts, ctr, *narrow, radius=0.2, nsample=32)
    with pytest.raises(ValueError, match="not instantiated"):
        sa.sa_dense_pool(pts[:, :32].contiguous(), ctr, *narrow, radius=0.2)
    with pytest.raises(ValueError, match="shared memory"):  # 1024-point lists
        sa.sa_dense_pool(pts, ctr, *ops, radius=0.2)
    with pytest.raises(TypeError):  # f32 weights
        sa.sa_group_mlp_pool(pts, ctr, ops[0], *ops[1:3], w2.float(),
                             *ops[4:], radius=0.2, nsample=32)


@pytest.mark.parametrize("G", [48, 2560])  # small; SA2 of the GPS slice
def test_sa_dense_pool_matches_plain(dev, G):
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa

    N, _, m, _, r, _ = SA_LEVELS["SA2"]
    pts, ops = _sa_case(dev, "SA2", G, seed=5)
    ctr, _ = sa.fps(pts[..., :3].contiguous(), m)
    ctr[:3] += 5.0  # empty balls: pair (c, 0)
    before = _build.LAUNCHES["sa_dense_pool"]
    got = sa.sa_dense_pool(pts, ctr, *ops, radius=r)
    again = sa.sa_dense_pool(pts, ctr, *ops, radius=r)
    want = sa.sa_dense_pool_plain(pts, ctr, *ops, radius=r)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sa_dense_pool"] == before + 2
    assert torch.equal(got, again)
    assert want.abs().max() > 0 and _rel(got, want) <= 1e-2
    # the dense branch of sa_group_mlp_pool: the same kernel, the same bits
    other = sa.sa_group_mlp_pool(pts, ctr, *ops, radius=r, nsample=N)
    assert torch.equal(got, other)


@pytest.mark.parametrize("use_ab", [False, True])
@pytest.mark.parametrize("Lq,Lk,valid", [
    (50, 50, None), (130, 130, None), (300, 300, None), (40, 72, None),
    (1, 9, None),
    # B*H = 36 over 5 key tiles and 1 query tile, and the converse
    (40, 300, None), (300, 40, None),
    (300, 300, (0, 1, 64, 65)),  # whole trailing key tiles of pad
])
def test_flash_kernels_match_plain(dev, Lq, Lk, valid, use_ab):
    """bf16 outputs within 2e-2 of max|plain| (an element on a bf16
    rounding boundary may land one step apart); two runs bit-identical.
    With ``valid`` (each batch row's count of leading valid keys) the
    forward and the backward equal, bit for bit, their own outputs on keys
    cut after the tile of a row's last valid key; dk, dv and d ab are zero
    on the whole pad tiles the kernels skip; the row with no valid key gets
    the mean of v and its gradients match the twin's within 2e-2."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import attention as fa

    g = torch.Generator().manual_seed(6)
    B, H, dh, bf = 3 if valid is None else len(valid), 12, 64, torch.bfloat16
    q = (torch.randn((B, H, Lq, dh), generator=g) * 0.125).to(dev, bf)
    k, v = (torch.randn((B, H, Lk, dh), generator=g).to(dev, bf)
            for _ in range(2))
    do = torch.randn((B, H, Lq, dh), generator=g).to(dev, bf)
    if valid is None:
        pad = torch.rand((B, Lk), generator=g) > 0.7
        pad[:, 0] = False
    else:
        pad = torch.arange(Lk)[None] >= torch.tensor(valid)[:, None]
    pad = pad.to(dev)
    ab = (torch.randn((B, H, Lq, Lk), generator=g).to(dev) if use_ab
          else None)
    before = dict(_build.LAUNCHES)
    got = fa.flash_fwd(q, k, v, pad, ab)
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                  fa.flash_fwd(q, k, v, pad,
                                                               ab)))
    assert _build.LAUNCHES["flash_fwd"] == before.get("flash_fwd", 0) + 2
    want = fa.flash_fwd_plain(q, k, v, pad, ab)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2
    if valid is not None:
        mean_v = v[0].float().mean(1, keepdim=True)
        assert (got[0][0].float() - mean_v).abs().max() <= 2.0 ** -7
        for b in range(1, B):
            end = -(-valid[b] // fa.BK) * fa.BK
            cut = fa.flash_fwd(
                q[b:b + 1], k[b:b + 1, :, :end].contiguous(),
                v[b:b + 1, :, :end].contiguous(),
                pad[b:b + 1, :end].contiguous(),
                None if ab is None else ab[b:b + 1, ..., :end].contiguous())
            assert all(torch.equal(a[b:b + 1], c) for a, c in zip(got, cut))
    bargs = (q, k, v, pad, ab, *want, do)
    got = fa.flash_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(got, fa.flash_bwd(*bargs))
               if a is not None)
    want = fa.flash_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert b.abs().max() > 0 and _rel(a, b) <= 2e-2
    assert _build.LAUNCHES["flash_bwd"] == before.get("flash_bwd", 0) + 2
    if valid is None:
        return
    dq, dk, dv, dab = got
    for a, b in zip(got, want):  # the all-pad row walks every tile
        if b is not None:
            assert _rel(a[0], b[0]) <= 2e-2
    o, l, m = bargs[5:8]
    for b in range(1, B):
        end = -(-valid[b] // fa.BK) * fa.BK
        assert (dk[b, :, end:] == 0).all() and (dv[b, :, end:] == 0).all()
        if ab is not None:
            assert (dab[b, ..., end:] == 0).all()
        r = slice(b, b + 1)
        cut = fa.flash_bwd(
            q[r], k[r, :, :end].contiguous(), v[r, :, :end].contiguous(),
            pad[r, :end].contiguous(),
            None if ab is None else ab[r, ..., :end].contiguous(),
            o[r], l[r], m[r], do[r])
        assert torch.equal(dq[r], cut[0])
        assert torch.equal(dk[r, :, :end], cut[1])
        assert torch.equal(dv[r, :, :end], cut[2])
        if ab is not None:
            assert torch.equal(dab[r, ..., :end], cut[3])


@pytest.mark.parametrize("use_ab", [False, True])
def test_masked_mha_autograd_on_the_card(dev, use_ab):
    """``masked_mha`` at L=130 through ``FlashAttention``: on the card one
    ``flash_fwd`` and one ``flash_bwd``, and the gradients of q, k, v (and
    ab, which requires one) within 2e-2 of the same autograd graph on the
    CPU, where the wrappers run their plain twins (bf16 rounding points
    shared, sums in another order)."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import attention as fa

    g = torch.Generator().manual_seed(7)
    B, H, L, dh = 2, 12, 130, 64
    q, k, v, do = (torch.randn((B, H, L, dh), generator=g) for _ in range(4))
    ab = torch.randn((B, H, L, L), generator=g)
    pad = torch.arange(L)[None] >= torch.tensor([[101], [37]])
    outs = {}
    for d in ("cpu", dev):
        leaves = [t.to(d).detach().requires_grad_()
                  for t in ((q, k, v, ab) if use_ab else (q, k, v))]
        before = dict(_build.LAUNCHES)
        o = fa.masked_mha(*leaves[:3], pad.to(d),
                          leaves[3] if use_ab else None, sm_scale=0.125)
        grads = torch.autograd.grad(o, leaves, do.to(d))
        launched = {n: _build.LAUNCHES[n] - before.get(n, 0)
                    for n in ("flash_fwd", "flash_bwd")}
        assert launched == ({"flash_fwd": 0, "flash_bwd": 0} if d == "cpu"
                            else {"flash_fwd": 1, "flash_bwd": 1})
        outs[str(d)] = [t.detach().cpu() for t in (o, *grads)]
    for a, b in zip(outs[str(dev)], outs["cpu"]):
        assert b.abs().max() > 0 and _rel(a, b) <= 2e-2


def test_exact_mode_forward_on_the_card_takes_the_new_kernels(dev,
                                                              monkeypatch):
    """The OpenVocab model (head width 64, GPS SA widths) with the exact-mode
    gates: an eval forward on the card launches sa_dense_pool once and
    flash_fwd once per non-spatial attention layer, never mha_fwd, and
    agrees with the same forward on the CPU (plain twins); a train step
    launches no flash kernel."""
    import os

    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.data.build import get_dataset, numpy_collate
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    for k, v in {"SCENEVERSE_FUSED_MHA": "off", "SCENEVERSE_FLASH_ATTN": "on",
                 "SCENEVERSE_SA2_BATCHED": "on"}.items():
        monkeypatch.setenv(k, v)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    w = ["hidden_size=128", "num_attention_heads=2"]
    cfg = load_config(
        os.path.join(repo, "configs", "final", "synthetic_pretrain.yaml"),
        [f"model.{t}.args.{a}" for t in ("language", "vision", "grounding")
         for a in w]
        + ["model.language.args.num_hidden_layers=2",
           "model.vision.args.num_layers=2",
           "model.grounding.args.num_layers=2",
           "model.vision.args.dim_feedforward=256",
           "model.grounding.args.dim_feedforward=256",
           "model.heads.pretrain_head.args.hidden_size=128",
           "data.synthetic_size=4", "data.args.num_points=64",
           "data.args.max_obj_len=4", "model.split_scene_cap_tower=True"])
    ds = get_dataset(cfg, "train")
    batch = {k: torch.from_numpy(v) for k, v in
             numpy_collate([ds[0], ds[1]]).items() if hasattr(v, "dtype")
             and v.dtype != object}
    model = build_model(cfg).eval()
    with torch.no_grad():
        ref = model(batch)
    model = model.to(dev)
    on_dev = {k: v.to(dev) for k, v in batch.items()}
    _build.reset_launches()
    with torch.no_grad():
        out = model(on_dev)
    torch.cuda.synchronize()
    seen = {k: _build.LAUNCHES[k] for k in ("sa_dense_pool", "flash_fwd",
                                             "mha_fwd", "sa_group_mlp_pool")}
    # utterance 2 + caption 1 ([CLS]-only layer plain) + unified 2
    assert seen == {"sa_dense_pool": 1, "flash_fwd": 5, "mha_fwd": 0,
                    "sa_group_mlp_pool": 1}
    for k in ("og3d_logits", "scene_text_embed", "txt_lm_cls_logits"):
        scale = max(1.0, ref[k].abs().max().item())
        assert (out[k].cpu() - ref[k]).abs().max().item() <= 3e-2 * scale, k
    model.train()
    _build.reset_launches()
    total, _ = Loss(cfg).to(dev)(model(on_dev))
    total.backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == 0 and _build.LAUNCHES["mha_bwd"] == 0
    assert _build.LAUNCHES["sa_dense_pool"] == 1

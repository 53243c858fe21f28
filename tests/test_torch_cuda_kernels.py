"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. CUDA kernels have no CPU or interpret mode, so every test here needs a
CUDA card and skips without one (decided inside the fixture, never at
import). On a GPU machine, without the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances on max|kernel - plain| / max|plain|: f32 1e-4 (same f32
arithmetic, another summation order); bf16 2e-2 (an element on a bf16
rounding boundary may land one step, 2^-8, apart); SA 1e-2 (bf16 weights and
activations on both sides); FPS and ball-query indices exactly equal;
ball_group's grouped rows exactly equal (the same gather, bf16 rounding and
f32 subtraction on both sides); sa_train: the tolerances of chip_smoke.py's
SA_TRAIN_TOL (its comment gives the reasons), argmax equal but at
near-ties, and every kernel bit-identical over two runs; sa_dense_pool and
the flash kernels bit-identical over two runs, sa_dense_pool within the SA
1e-2, flash_fwd / flash_bwd within 2e-2 (bf16 outputs); the exact-mode
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


@pytest.mark.parametrize("N,C,m,ns,r,spec", [
    (256, 6, 32, 32, 0.2, [6, 64, 64, 128]),
    (32, 131, 16, 32, 0.4, [131, 128, 128, 256]),
])
def test_sa_kernels_match_plain(dev, N, C, m, ns, r, spec):
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa

    g = torch.Generator().manual_seed(0)
    pts = torch.rand((48, N, C), generator=g) - 0.5
    pts[:, -5:, :3] = 0.0
    pts = pts.to(dev)
    ws = []
    for cin, h in zip(spec[:-1], spec[1:]):
        ws += [torch.randn((h, cin), generator=g) / math.sqrt(cin),
               torch.stack([torch.rand(h, generator=g) + 0.5,
                            torch.randn(h, generator=g) * 0.1], 1)]
    ops = sa.prepare_weights(*[w.to(dev) for w in ws])
    before = dict(_build.LAUNCHES)
    xyz, idx = sa.fps(pts[..., :3].contiguous(), m)
    xyz_ref, idx_ref = sa.fps_plain(pts[..., :3].contiguous(), m)
    assert torch.equal(idx, idx_ref) and torch.equal(xyz, xyz_ref)
    ctr = xyz.clone()
    ctr[:4] += 5.0  # empty balls
    got = sa.sa_group_mlp_pool(pts, ctr, *ops, radius=r, nsample=ns)
    want = sa.sa_group_mlp_pool_plain(pts, ctr, *ops, radius=r, nsample=ns)
    torch.cuda.synchronize()
    assert want.abs().max() > 0
    assert _rel(got, want) <= 1e-2
    assert _build.LAUNCHES["fps"] == before.get("fps", 0) + 1
    assert (_build.LAUNCHES["sa_group_mlp_pool"]
            == before.get("sa_group_mlp_pool", 0) + 1)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G,N,C,m,ns,r", [
    (48, 256, 6, 32, 32, 0.2),      # small
    (2560, 1024, 6, 32, 32, 0.2),   # SA1 of the unfrozen slice
])
def test_ball_group_matches_plain(dev, G, N, C, m, ns, r, exact):
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa
    from sceneverse_tpu_torch.ops import sample_group as sg

    g = torch.Generator().manual_seed(2)
    pts = torch.randn((G, N, C), generator=g)
    pts[-2:, :, :3] = 0.0  # all-pad objects
    pts = pts.to(dev)
    ctr, _ = sa.fps(pts[..., :3].contiguous(), m)
    ctr[:2] += 5.0  # empty balls
    before = _build.LAUNCHES["ball_group"]
    got, idx = sg.ball_group(pts, ctr, ns, r, exact)
    want, want_idx = sg.ball_group_plain(pts, ctr, ns, r, exact)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ball_group"] == before + 1
    assert torch.equal(idx, want_idx) and torch.equal(got, want)
    assert (idx[:2] == 0).all()
    grouped, new_xyz, fps_idx, bq_idx = sg.fused_sample_and_group(
        pts, m, ns, r, exact)
    ref = sg.sample_and_group_plain(pts, m, ns, r, exact)
    for a, b in zip((grouped, new_xyz, fps_idx, bq_idx), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L,T,gate,rate", [
    (50, 50, False, 0.1), (80, 80, True, 0.0), (130, 130, False, 0.1),
    (40, 72, False, 0.0),
])
def test_mha_kernels_match_plain(dev, dtype, tol, L, T, gate, rate):
    from sceneverse_tpu_torch.ops import mha

    g = torch.Generator().manual_seed(1)
    B, H, dh = 3, 12, 64
    q = torch.randn((B, L, H * dh), generator=g).to(dev, dtype)
    k, v = (torch.randn((B, T, H * dh), generator=g).to(dev, dtype)
            for _ in range(2))
    do = torch.randn((B, L, H * dh), generator=g).to(dev, dtype)
    pad = torch.where(torch.rand((B, T), generator=g) > 0.8, mha.NEG,
                      0.0).float().to(dev)
    pad[:, 0] = 0.0
    sw = torch.randn((B, H, L, 6), generator=g).to(dev) if gate else None
    locs = torch.randn((B, L, T, 5), generator=g).to(dev) if gate else None
    args = (q, k, v, pad, sw, locs, H, 0.125, rate, 5)
    o, lse = mha.mha_fwd(*args)
    o_ref, lse_ref = mha.mha_fwd_plain(*args)
    assert _rel(o, o_ref) <= tol and _rel(lse, lse_ref) <= tol
    got = mha.mha_bwd(q, k, v, pad, sw, locs, do, o_ref, lse_ref, H, 0.125,
                      rate, 5)
    want = mha.mha_bwd_plain(q, k, v, pad, sw, locs, do, o_ref, lse_ref, H,
                             0.125, rate, 5)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert _rel(a, b) <= tol


def _sa_train_case(dev, R, dims, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((R, dims[0]), generator=g).to(dev)
    params = tuple(
        ((torch.randn((k, h), generator=g) / math.sqrt(k)).to(dev),
         (torch.rand(h, generator=g) + 0.5).to(dev),
         (torch.randn(h, generator=g) * 0.1).to(dev))
        for k, h in zip(dims[:-1], dims[1:]))
    return g, x, params


def _same_twice(fn):
    import chip_smoke

    a, b = fn(), fn()
    ta, tb = chip_smoke._tensors(a), chip_smoke._tensors(b)
    assert len(ta) == len(tb) and all(torch.equal(p, q)
                                      for p, q in zip(ta, tb))
    return a


@pytest.mark.parametrize("R,ns,dims,need_dx", [
    (16 * 37, 16, [6, 16, 16, 32], True),            # small, ragged tiles
    (2560 * 32 * 32, 32, [6, 64, 64, 128], False),   # SA1
    (2560 * 16 * 32, 32, [131, 128, 128, 256], True),  # SA2
    (2560 * 16, 16, [259, 256, 512, 768], True),     # SA3
])
def test_sa_train_kernels_match_plain(dev, R, ns, dims, need_dx):
    from chip_smoke import SA_TRAIN_TOL as TOL
    from chip_smoke import check_argmax, check_rows
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_train as st

    g, x, params = _sa_train_case(dev, R, dims)
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
    dpooled = torch.randn(pooled.shape, generator=g).to(dev)
    dx, grads = _same_twice(lambda: st.sa_pool_bwd(
        x, params, ns, dpooled, arg, need_dx))
    wdx, wgrads = st.mlp_pool_bwd_plain(x, params, ns, dpooled, arg)
    for a, b in zip(grads, wgrads):
        for p, q in zip(a, b):
            assert _rel(p, q) <= TOL["grads"]
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

    q = torch.randn((2, 8, 64), device=dev, dtype=torch.float16)
    pad = torch.zeros((2, 8), device=dev)
    with pytest.raises(TypeError):
        mha.mha_fwd(q, q, q, pad, None, None, 4, 0.25)
    q = torch.randn((2, 8, 48 * 2), device=dev)
    with pytest.raises(ValueError):  # head width 48 not instantiated
        mha.mha_fwd(q, q, q, pad, None, None, 2, 0.25)

    from sceneverse_tpu_torch.ops import sa_train as st

    _, x, params = _sa_train_case(dev, 64, [6, 16, 16, 32])
    with pytest.raises(TypeError):  # bf16 rows
        st.sa_stats(x.to(torch.bfloat16), params, 1)
    with pytest.raises(ValueError):  # width 24, not a multiple of 16
        _, x2, p2 = _sa_train_case(dev, 64, [6, 24, 16, 32])
        st.sa_stats(x2, p2, 1)
    with pytest.raises(ValueError):  # W1 that does not take 6 channels
        st.sa_pool(x[:, :5].contiguous(), params, 16)
    with pytest.raises(ValueError):  # ns not a multiple of 16
        st.sa_pool(x, params, 8)
    with pytest.raises(ValueError):  # rows not whole centers
        st.sa_pool(x[:40].contiguous(), params, 16)
    pooled, arg = st.sa_pool(x, params, 16)
    with pytest.raises(ValueError):  # argmax of another shape
        st.sa_pool_bwd(x, params, 16, pooled, arg[:2].contiguous())
    with pytest.raises(TypeError):  # argmax not int32
        st.sa_pool_bwd(x, params, 16, pooled, arg.long())
    with pytest.raises(ValueError):  # dG not (H, H)
        st.sa_stats_bwd(x, params, 1, torch.zeros(16, device=dev),
                        torch.zeros((16, 8), device=dev))


@pytest.mark.parametrize("G", [48, 2560])  # small; SA2 of the GPS slice
def test_sa_dense_pool_matches_plain(dev, G):
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import sa_forward as sa

    g = torch.Generator().manual_seed(5)
    N, C, m, r, spec = 32, 131, 16, 0.4, [131, 128, 128, 256]
    pts = (torch.rand((G, N, C), generator=g) - 0.5).to(dev)
    ws = []
    for cin, h in zip(spec[:-1], spec[1:]):
        ws += [torch.randn((h, cin), generator=g) / math.sqrt(cin),
               torch.stack([torch.rand(h, generator=g) + 0.5,
                            torch.randn(h, generator=g) * 0.1], 1)]
    ops = sa.prepare_weights(*[w.to(dev) for w in ws])
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
    # the same function as the dense branch of sa_group_mlp_pool
    other = sa.sa_group_mlp_pool(pts, ctr, *ops, radius=r, nsample=32)
    assert _rel(got, other) <= 1e-2


@pytest.mark.parametrize("use_ab", [False, True])
@pytest.mark.parametrize("Lq,Lk", [(50, 50), (130, 130), (300, 300),
                                   (40, 72), (1, 9)])
def test_flash_kernels_match_plain(dev, Lq, Lk, use_ab):
    """bf16 outputs within 2e-2 of max|plain| (an element on a bf16
    rounding boundary may land one step apart); two runs bit-identical."""
    from sceneverse_tpu_torch.ops import _build
    from sceneverse_tpu_torch.ops import attention as fa

    g = torch.Generator().manual_seed(6)
    B, H, dh, bf = 3, 12, 64, torch.bfloat16
    q = (torch.randn((B, H, Lq, dh), generator=g) * 0.125).to(dev, bf)
    k, v = (torch.randn((B, H, Lk, dh), generator=g).to(dev, bf)
            for _ in range(2))
    do = torch.randn((B, H, Lq, dh), generator=g).to(dev, bf)
    pad = torch.rand((B, Lk), generator=g) > 0.7
    pad[:, 0] = False
    pad = pad.to(dev)
    ab = (torch.randn((B, H, Lq, Lk), generator=g).to(dev) if use_ab
          else None)
    before = dict(_build.LAUNCHES)
    got = fa.flash_fwd(q, k, v, pad, ab)
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                  fa.flash_fwd(q, k, v, pad,
                                                               ab)))
    want = fa.flash_fwd_plain(q, k, v, pad, ab)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2
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
    assert _build.LAUNCHES["flash_fwd"] == before.get("flash_fwd", 0) + 2
    assert _build.LAUNCHES["flash_bwd"] == before.get("flash_bwd", 0) + 2


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

"""Port parity: sceneverse_tpu_torch fused attention (plain twin on CPU and
its autograd) against the JAX Pallas kernel in interpret mode with its
custom VJP. Same numpy inputs, f32.

Tolerances: forward 1e-5 and grads 1e-4 (absolute, on O(1) values). Both
sides compute the same f32 formulas; only the summation order of the dot
products and the exp/log implementations differ. The dropout mask is drawn
from the same counter hash on both sides, so dropout-on cases compare
exactly the same kept set. The GPS-length cases (L = T = 300 with the
additive row and dropout, L = T = 80 with the gate) run at B = 1, H = 2,
dh = 64, the head width of the CUDA kernels.

The 3xTF32 test emulates on the CPU the split the f32 CUDA kernels form on
the tensor cores, and holds it to the f32 tolerance the card's tests use
(1e-4 of max|f32 twin|)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sceneverse_tpu.ops.pallas.mha import fused_mha as jax_fused_mha
from sceneverse_tpu_torch.ops import mha as tmha

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _case(mode, seed=0):
    rng = np.random.RandomState(seed)
    B, H, dh = 2, 4, 16
    L = T = 12
    if mode.startswith("gps"):  # caption (L300) and spatial (L80) layers
        B, H, dh = 1, 2, 64
        L = T = 300 if mode == "gps_caption" else 80
    D = H * dh
    d = {
        "q": rng.randn(B, L, D).astype(np.float32),
        "k": rng.randn(B, T, D).astype(np.float32),
        "v": rng.randn(B, T, D).astype(np.float32),
        "w": rng.randn(B, L, D).astype(np.float32),
    }
    pad = rng.rand(B, T) > 0.7
    pad[:, 0] = False
    kw = {}
    if mode == "keypad":
        kw["key_padding_mask"] = pad
    elif mode in ("additive", "dropout", "gps_caption"):
        # HF extended mask row, finfo(f32).min at pads
        kw["pad_additive"] = np.where(pad, np.finfo(np.float32).min,
                                      0.0).astype(np.float32)
    elif mode in ("gate", "gps_spatial"):
        kw["key_padding_mask"] = pad
        kw["gate_sw"] = rng.randn(B, H, L, 6).astype(np.float32)
        kw["locs"] = rng.randn(B, L, T, 5).astype(np.float32)
    rate = 0.1 if mode in ("dropout", "gps_caption") else 0.0
    return d, kw, H, rate, 1.0 / math.sqrt(dh)


def _jax_run(d, kw, H, rate, scale, seed):
    names = ["q", "k", "v"] + (["gate_sw"] if "gate_sw" in kw else [])
    fixed = {k: jnp.asarray(v) for k, v in kw.items() if k != "gate_sw"}

    def loss(*args):
        extra = dict(fixed)
        if len(args) == 4:
            extra["gate_sw"] = args[3]
        o = jax_fused_mha(args[0], args[1], args[2], H, dropout_rate=rate,
                          seed=jnp.asarray([seed], jnp.int32), scale=scale,
                          interpret=True, **extra)
        return jnp.sum(o * jnp.asarray(d["w"])), o

    args = [jnp.asarray(d[n]) if n != "gate_sw" else jnp.asarray(kw[n])
            for n in names]
    (_, o), grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                       has_aux=True)(*args)
    return np.asarray(o), [np.asarray(g) for g in grads]


def _torch_run(d, kw, H, rate, scale, seed):
    leaves = {n: torch.tensor(d[n], requires_grad=True) for n in ("q", "k", "v")}
    extra = {}
    for k, v in kw.items():
        t = torch.tensor(v)
        if k == "gate_sw":
            t.requires_grad_(True)
            leaves["gate_sw"] = t
        extra[k] = t
    o = tmha.fused_mha(leaves["q"], leaves["k"], leaves["v"], H,
                       dropout_rate=rate, seed=torch.tensor([seed]),
                       scale=scale, **extra)
    (o * torch.tensor(d["w"])).sum().backward()
    names = ["q", "k", "v"] + (["gate_sw"] if "gate_sw" in leaves else [])
    return o.detach().numpy(), [leaves[n].grad.numpy() for n in names]


@pytest.mark.parametrize("mode", ["keypad", "additive", "gate", "dropout",
                                  "gps_caption", "gps_spatial"])
def test_fused_mha_matches_jax_interpret(mode):
    d, kw, H, rate, scale = _case(mode)
    seed = 1234
    jo, jg = _jax_run(d, kw, H, rate, scale, seed)
    to, tg = _torch_run(d, kw, H, rate, scale, seed)
    np.testing.assert_allclose(to, jo, atol=FWD_TOL, rtol=0)
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, atol=GRAD_TOL, rtol=0)


def test_dropout_mask_matches_jax_hash():
    """The plain twin's counter hash draws the TPU interpret stream bit for
    bit (per (b, h) seed, element index r*T + c)."""
    from sceneverse_tpu.ops.pallas.mha import _uniform01_hash

    B, H, L, T, seed, keep = 2, 3, 5, 7, -17, 0.9
    got = tmha.dropout_keep_mask(B, H, L, T, torch.tensor([seed]), keep,
                                 "cpu").numpy()
    for b in range(B):
        for h in range(H):
            u = _uniform01_hash((L, T), jnp.int32(seed + b * H + h))
            np.testing.assert_array_equal(got[b, h], np.asarray(u) < keep)
    frac = tmha.dropout_keep_mask(4, 4, 64, 64, torch.tensor([3]), keep,
                                  "cpu").float().mean()
    assert abs(float(frac) - keep) < 0.01


def test_mha_bf16_plain_runs_and_keeps_dtype():
    d, kw, H, rate, scale = _case("gate")
    q, k, v = (torch.tensor(d[n]).bfloat16().requires_grad_(True)
               for n in ("q", "k", "v"))
    o = tmha.fused_mha(q, k, v, H, key_padding_mask=torch.tensor(
        kw["key_padding_mask"]), gate_sw=torch.tensor(kw["gate_sw"]),
        locs=torch.tensor(kw["locs"]), scale=scale)
    assert o.dtype == torch.bfloat16
    o.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()


def _tf32_rna(x):
    """f32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits, mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # 0xFFFFE000


def _mm_3xtf32(a, b):
    """a @ b with each operand split into big + small TF32 parts and the
    product formed as small.big + big.small + big.big (f32 sums)."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_3xtf32_split_keeps_f32_accuracy_at_l300():
    rng = np.random.RandomState(3)
    L = T = 300
    q, k, v = (torch.tensor(rng.randn(n, 64).astype(np.float32))
               for n in (L, T, T))
    x = torch.tensor(rng.randn(1000).astype(np.float32) * 1e3)
    assert torch.equal(_tf32_rna(_tf32_rna(x)), _tf32_rna(x))
    assert ((_tf32_rna(x) - x).abs() <= x.abs() * 2.0 ** -11).all()
    s = q @ k.T * 0.125
    p = torch.softmax(s, -1)
    ref = {"q.k^T": (q.double() @ k.double().T, q @ k.T),
           "p.v": (p.double() @ v.double(), p @ v)}
    got = {"q.k^T": (_mm_3xtf32(q, k.T), _tf32_rna(q) @ _tf32_rna(k.T)),
           "p.v": (_mm_3xtf32(p, v), _tf32_rna(p) @ _tf32_rna(v))}
    for name, (exact, f32) in ref.items():
        three, single = got[name]
        scale = f32.abs().max().item()
        e3 = (three.double() - exact).abs().max().item() / scale
        e1 = (single.double() - exact).abs().max().item() / scale
        e32 = (f32.double() - exact).abs().max().item() / scale
        print(f"{name}: 3xTF32 {e3:.2e}, single-pass TF32 {e1:.2e}, "
              f"f32 {e32:.2e} (of max|f32|)")
        assert (three - f32).abs().max().item() <= 1e-4 * scale
        assert e3 <= 4 * max(e32, 1e-7)
        assert e1 > 1e-4  # one TF32 pass would fail the f32 tolerance

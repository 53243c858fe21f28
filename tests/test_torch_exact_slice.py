"""Port parity for the checkpoint-evaluation slice in the JAX package's
exact mode: ``SCENEVERSE_FUSED_MHA=off``, ``SCENEVERSE_FLASH_ATTN=on``,
``SCENEVERSE_SA2_BATCHED=on`` on both sides.

  * the SA2 dense stage: the port's ``sa_dense_pool`` twin against the JAX
    ``_kernel_dense_batched`` (interpret mode) at the GPS SA2 widths;
  * the tiny synthetic slice (``test_torch_slice.py``'s widths, 2 scenes x
    4 objects x 64 points, so that SA2 has G = 8 objects: JAX takes
    ``_kernel_dense_batched`` only when (block * N) % 128 == 0 or the block
    holds every object, and at G = 8 its block of 64 shrinks to G) with the
    JAX weights carried over: the train-mode forward, losses and gradients
    through the plain attention path and ``softmax_lowp`` (probability
    dropout 0.1 keeps flash off in training; both sides' dropout masks are
    made the identity, since their random streams differ by design), then
    the eval forward through flash attention (JAX's ``flash_enabled``
    answers False off a TPU, so it is patched for that call and the library
    kernels run in interpret mode);
  * ``mode=test pretrain_ckpt_path=`` on the CPU reproduces a run's test
    metrics from its ``best.pth``;
  * the port's state dict, saved as ``pytorch_model.bin``, loads through the
    JAX package's own converter into the JAX model, every tensor matched,
    and the two eval forwards agree.

Tolerances (max abs error per tensor):
  * SA2 dense pooled: 1e-2 * max|pooled|, the reason in
    ``test_torch_sa_forward.py``.
  * train-mode outputs and losses 1e-4 * max(1, max|jax|), gradients
    1e-3 * max|jax grad| + 1e-6 * the largest gradient: the reasons of
    ``test_torch_slice.py`` (bf16 SA on both sides summed in another order,
    f32 towers).
  * eval outputs through flash attention: one bf16 step of the output
    scale, 2^-8 * max(1, max|jax|). Every non-spatial attention output is
    rounded to bf16 on both sides, where an element on a rounding boundary
    can land one step (2^-8 relative) apart; downstream layers dilute it
    (measured 7.3e-5).
  * checkpoint round trip through the JAX loader: the eval forwards in f32
    (flash off), 1e-4 * max(1, max|jax|) as above.
  * mode=test: the test metrics equal (relative 1e-6; not ``best_result``,
    the evaluator's best over every pass of a run, val included), the
    loaded weights equal the trained ones.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from sceneverse_tpu.config import load_config
from sceneverse_tpu.data.build import get_dataset, numpy_collate
from test_torch_slice import CFG, OUT_KEYS, REPO, TINY, _flat

GATES = {"SCENEVERSE_FUSED_MHA": "off", "SCENEVERSE_FLASH_ATTN": "on",
         "SCENEVERSE_SA2_BATCHED": "on"}
EXACT = TINY + ["data.synthetic_size=16", "data.args.max_obj_len=4",
                "data.args.max_seq_len=16", "data.args.max_scene_cap_len=16",
                "model.lm_max_predictions=4",
                "model.split_scene_cap_tower=True"]


def test_sa_dense_pool_plain_matches_jax_dense_batched(monkeypatch):
    from sceneverse_tpu.ops.pallas import sa_forward as jsa
    from sceneverse_tpu_torch.ops import sa_forward as tsa
    from test_torch_sa_forward import _points, _weights

    ran = []
    kern = jsa._kernel_dense_batched
    monkeypatch.setattr(jsa, "_kernel_dense_batched",
                        lambda *a, **k: ran.append(1) or kern(*a, **k))
    G, N, C, m, ns, r = 8, 32, 131, 16, 32, 0.4
    rng = np.random.RandomState(5)
    pts = _points(rng, G, N, C, 0.3)
    ws = _weights(rng, [131, 128, 128, 256])
    jp, jx = jsa.fused_sa_forward(jnp.asarray(pts), m, ns, r,
                                  *map(jnp.asarray, ws), interpret=True,
                                  block_objects=64, split_fps=True,
                                  dense_batched=True)
    assert ran  # JAX took the batched dense kernel, not its fallback
    tp, tx = tsa.fused_sa_forward(torch.tensor(pts), m, ns, r,
                                  *map(torch.tensor, ws), dense_batched=True)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jp = np.asarray(jp)
    assert np.abs(tp.numpy() - jp).max() <= 1e-2 * np.abs(jp).max()
    ops = tsa.prepare_weights(*map(torch.tensor, ws))
    empty = tx.clone()
    empty[:2] += 5.0  # balls with no point: pair (c, 0)
    want = tsa.sa_group_mlp_pool_plain(torch.tensor(pts), empty, *ops,
                                       radius=r, nsample=ns)
    assert torch.equal(tsa.sa_dense_pool(torch.tensor(pts), empty, *ops,
                                         radius=r), want)


def _spy(mp, module, name, sink):
    """Count calls of ``module.name`` into the dict ``sink[0]``."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        sink[0][name] = sink[0].get(name, 0) + 1
        return fn(*a, **k)

    mp.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def exact():
    """Both sides' train-mode outputs, losses and step-1 grads, and eval
    outputs through flash attention, with the kernels each side reached."""
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.ops.pallas import attention as jatt
    from sceneverse_tpu.ops.pallas import sa_forward as jsa
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.modules import utils as tutils
    from sceneverse_tpu_torch.ops import attention as tatt
    from sceneverse_tpu_torch.ops import sa_forward as tsa
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        for k, v in GATES.items():
            mp.setenv(k, v)
        cfg = load_config(CFG, EXACT)
        ds = get_dataset(cfg, "train")
        items = [ds[i] for i in range(len(ds))
                 if (ds[i]["masked_lm_labels"] != -1).any()][:2]
        batch = {k: v for k, v in numpy_collate(items).items()
                 if isinstance(v, np.ndarray)}
        jm = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))()
        tm = tbuild(cfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        counts = {"jax": {}, "train": {}, "eval": {}}
        # the spies count traces: drop traces cached by earlier tests
        jax.clear_caches()
        jsink, tsink = [counts["jax"]], [counts["train"]]
        _spy(mp, jsa, "_kernel_dense_batched", jsink)
        _spy(mp, jatt, "masked_mha", jsink)
        for name in ("sa_dense_pool", "sa_group_mlp_pool"):
            _spy(mp, tsa, name, tsink)
        _spy(mp, tatt, "flash_fwd", tsink)

        # train mode: dropout rates stay 0.1 (so every layer routes as in
        # training) but both sides' masks are the identity
        mp.setattr(nnx.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(tutils.Dropout, "forward", lambda self, x: x)
        jm.train()
        tm.train()
        loss_mod, _, _, _ = build_optim(cfg, jm, total_steps=10)
        tloss = Loss(cfg)

        def loss_fn(m):
            out = m(jb)
            total, losses = loss_mod(out)
            return total, (out, losses)

        (_, (jout, jlosses)), grads = nnx.jit(
            nnx.value_and_grad(loss_fn, has_aux=True))(jm)
        counts["jax_train"] = dict(counts["jax"])
        tout = tm(tb)
        ttotal, tlosses = tloss(tout)
        ttotal.backward()
        jg = from_jax_params(_flat(nnx.state(grads, nnx.Param)))
        res = {"missing": missing, "unexpected": unexpected, "counts": counts,
               "out": {k: (np.asarray(jout[k]), tout[k].detach().numpy())
                       for k in OUT_KEYS},
               "loss": {k: (float(jlosses[k]), float(tlosses[k].detach()))
                        for k in jlosses},
               "grad": {n: (jg[n].numpy(), p.grad.numpy().copy())
                        for n, p in tm.named_parameters()
                        if p.requires_grad and p.grad is not None}}

        # eval: flash attention on both sides
        mp.setattr(jatt, "flash_enabled", lambda: True)
        jm.eval()
        tm.eval()
        with pltpu.force_tpu_interpret_mode():
            jev = nnx.jit(lambda m: m(jb))(jm)
        tsink[0] = counts["eval"]
        with torch.no_grad():
            tev = tm(tb)
        res["eval"] = {k: (np.asarray(jev[k]), tev[k].numpy())
                       for k in OUT_KEYS}
    return res


def test_weights_carry_over_completely(exact):
    assert exact["missing"] == [] and exact["unexpected"] == []


def test_both_sides_take_the_exact_mode_kernels(exact):
    """JAX traced its batched SA2 kernel in training and flash attention
    only in eval; the port ran SA1 through sa_group_mlp_pool and SA2
    through sa_dense_pool in both, and flash attention in eval only, once
    per non-spatial attention layer: utterance 2, caption 1 (its
    [CLS]-only layer is plain), unified 2."""
    c = exact["counts"]
    assert c["jax_train"].get("_kernel_dense_batched", 0) >= 1
    assert c["jax_train"].get("masked_mha", 0) == 0
    assert c["jax"].get("masked_mha", 0) >= 1
    assert c["train"] == {"sa_group_mlp_pool": 1, "sa_dense_pool": 1}
    assert c["eval"] == {"sa_group_mlp_pool": 1, "sa_dense_pool": 1,
                         "flash_fwd": 5}


def test_train_mode_outputs_and_losses_match_jax(exact):
    for k, (j, t) in exact["out"].items():
        assert t.shape == j.shape, k
        err = np.abs(t.astype(np.float64) - j).max()
        assert err <= 1e-4 * max(1.0, np.abs(j).max()), (k, err)
    for k, (j, t) in exact["loss"].items():
        assert np.isfinite(t) and j > 0, k
        assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t)


def test_train_mode_grads_match_jax(exact):
    gmax = max(np.abs(j).max() for j, _ in exact["grad"].values())
    assert gmax > 0 and len(exact["grad"]) > 50
    for n, (j, t) in exact["grad"].items():
        err = np.abs(t - j).max()
        assert err <= 1e-3 * np.abs(j).max() + 1e-6 * gmax, (n, err)


def test_eval_forward_through_flash_matches_jax(exact):
    for k, (j, t) in exact["eval"].items():
        assert t.shape == j.shape, k
        if k == "masked_lm_labels":
            assert np.array_equal(t, j)
            continue
        err = np.abs(t.astype(np.float64) - j).max()
        assert err <= 2.0 ** -8 * max(1.0, np.abs(j).max()), (k, err)


def _run(args):
    import run_torch

    return run_torch.main(["--config-path", os.path.join(REPO, "configs",
                                                         "final"),
                           "--config-name", "synthetic_pretrain", *EXACT,
                           "device=cpu", *args])


def test_mode_test_reproduces_the_runs_test_metrics(tmp_path, monkeypatch):
    for k, v in GATES.items():
        monkeypatch.setenv(k, v)
    first = _run(["solver.epochs=1", f"base_dir={tmp_path / 'train'}"])
    (best,) = glob.glob(str(tmp_path / "train" / "*" / "ckpt" / "best.pth"))
    again = _run(["mode=test", f"pretrain_ckpt_path={best}",
                  f"base_dir={tmp_path / 'test'}"])
    trainer = again["trainer"]
    assert trainer.data_loaders.keys() == {"test"}
    assert trainer.total_steps == 1 and trainer.history["train"] == []
    want = first["trainer"].model.state_dict()
    got = trainer.model.state_dict()
    assert trainer.pretrain_loaded == len(got) == len(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = first["results"], again["results"]
    assert a.keys() == b.keys()
    for k in a.keys() - {"best_result"}:  # the best over the run's passes
        assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(a[k])), k


def test_port_checkpoint_loads_into_the_jax_model(tmp_path, monkeypatch):
    from sceneverse_tpu.ckpt.convert import (apply_to_model,
                                             convert_torch_state_dict,
                                             load_torch_pretrain)
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain as tload
    from sceneverse_tpu_torch.model import build_model as tbuild

    monkeypatch.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")
    monkeypatch.setenv("SCENEVERSE_SA2_BATCHED", "on")
    cfg = load_config(CFG, EXACT)
    tm = tbuild(cfg, generator=torch.Generator().manual_seed(7)).eval()
    torch.save(tm.state_dict(), tmp_path / "pytorch_model.bin")
    weights = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    jm = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(1)))()
    n, missing, unexpected = apply_to_model(
        jm, convert_torch_state_dict(weights))
    assert missing == [] and unexpected == []
    # every tensor but BatchNorm's step counters, which JAX does not keep
    counters = [k for k in weights if k.endswith("num_batches_tracked")]
    assert n == len(weights) - len(counters) > 100
    jm2 = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(2)))()
    assert load_torch_pretrain(jm2, tmp_path) == n
    # and the port's own loader reads the shard directory back whole
    back = tbuild(cfg, generator=torch.Generator().manual_seed(8))
    assert tload(back, tmp_path) == len(weights)
    assert all(torch.equal(back.state_dict()[k], v)
               for k, v in weights.items())
    ds = get_dataset(cfg, "test")[0]
    items = [ds[i] for i in range(2)]
    batch = {k: v for k, v in numpy_collate(items).items()
             if isinstance(v, np.ndarray)}
    jm.eval()
    jout = nnx.jit(lambda m: m({k: jnp.asarray(v)
                                for k, v in batch.items()}))(jm)
    with torch.no_grad():
        tout = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in OUT_KEYS:
        j, t = np.asarray(jout[k]), tout[k].numpy()
        err = np.abs(t.astype(np.float64) - j).max()
        assert err <= 1e-4 * max(1.0, np.abs(j).max()), (k, err)

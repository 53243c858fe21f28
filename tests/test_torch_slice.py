"""Port parity for the whole slice: the sceneverse_tpu_torch OpenVocab model,
its losses and its AdamW step against the JAX model and optax, with the JAX
weights carried over; plus a CPU run of run_torch.py that must never import
JAX or the JAX package.

Setup: synthetic_pretrain at hidden 64, 2 layers per tower, 5 objects x 64
points, 16 text tokens, batch 2, dropout off (eval mode on both sides). The
JAX side runs under SCENEVERSE_PALLAS_INTERPRET=1 so its SA and attention go
through the Pallas kernels in interpret mode (the numerics the port follows).
Warmup is 0, so both steps have a non-zero LR; Adam eps is 1e-6 on both
sides (a config knob both honour), so gradients that are zero in exact
arithmetic (key-projection biases: softmax ignores them) stay damped instead
of being normalised from float noise into full +-lr steps.

Tolerances (max abs error per tensor):
  * forward outputs and losses: 1e-4 * max(1, max|jax|). The frozen
    PointNet++ rounds to bf16 on both sides at the same points but sums in
    another order (1e-5 relative at its outputs); the f32 towers add ~1e-6.
  * gradients at step 1: 1e-3 * max|jax grad of that tensor| + 1e-6 * the
    largest gradient: the backward amplifies the forward's 1e-5 differences;
    the absolute floor covers tensors whose exact gradient is zero.
  * parameters after 2 AdamW steps, per tensor: at least 99.9% of the
    elements within 1e-4 * max|p| + 1e-2 * (2 * lr of the tensor's group),
    and none off by more than 1e-4 * max|p| + 0.25 * (2 * lr). Adam moves
    each element by about lr a step whatever the gradient's scale, so
    gradient differences show up as a fraction of lr; an element whose
    gradient sits near eps is normalised from a noisy value and can take a
    visibly different fraction of its step (measured: at most 0.07% of a
    tensor's elements, at most 0.085 of the 2-step span).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from sceneverse_tpu.config import load_config
from sceneverse_tpu.data.build import get_dataset, numpy_collate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "final", "synthetic_pretrain.yaml")
TINY = [
    "model.language.args.hidden_size=64",
    "model.language.args.num_hidden_layers=2",
    "model.language.args.num_attention_heads=4",
    "model.vision.args.hidden_size=64", "model.vision.args.num_layers=2",
    "model.vision.args.num_attention_heads=4",
    "model.vision.args.dim_feedforward=128",
    "model.grounding.args.hidden_size=64", "model.grounding.args.num_layers=2",
    "model.grounding.args.num_attention_heads=4",
    "model.grounding.args.dim_feedforward=128",
    "model.heads.pretrain_head.args.hidden_size=64",
    "data.synthetic_size=4", "dataloader.batchsize=2",
    "data.args.num_points=64",
]
PARITY = TINY + [
    "data.synthetic_size=16", "data.args.max_obj_len=5",
    "data.args.max_seq_len=16", "data.args.max_scene_cap_len=16",
    "model.lm_max_predictions=4", "model.split_scene_cap_tower=True",
    "solver.sched.args.warmup_steps=0", "solver.optim.args.eps=1e-6",
]
OUT_KEYS = ["og3d_logits", "txt_lm_cls_logits", "obj_cls_post_logits",
            "obj_cls_raw_logits", "scene_text_embed", "scene_embed",
            "inter_text_embed", "intra_obj_embeds", "masked_lm_labels"]


def _flat(state) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                 for p in path]
        if names[-1] == "value":
            names.pop()
        out[".".join(names)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def parity():
    """Both sides' outputs, losses, step-1 grads and params after 2 steps."""
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params, load_jax_params
    from sceneverse_tpu_torch.model import build_model as tbuild
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
        cfg = load_config(CFG, PARITY)
        ds = get_dataset(cfg, "train")
        items = [ds[i] for i in range(len(ds))
                 if (ds[i]["masked_lm_labels"] != -1).any()][:2]
        batch = {k: v for k, v in numpy_collate(items).items()
                 if isinstance(v, np.ndarray)}
        jm = nnx.jit(lambda: jbuild(cfg, rngs=nnx.Rngs(0)))()
        jm.eval()
        tm = tbuild(cfg)
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        loss_mod, tx, _, _ = build_optim(cfg, jm, total_steps=10)
        tloss = Loss(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}

        def loss_fn(m):
            out = m(jb)
            total, losses = loss_mod(out)
            return total, (out, losses)

        step = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))

        @jax.jit  # one program: eager optax compiles one per leaf shape
        def adamw(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        params = nnx.state(jm, nnx.Param)
        opt_state = jax.jit(tx.init)(params)
        topt = GPSOptimizer(cfg, tm, total_steps=10)
        lrs = {id(p): g["base_lr"] for g in topt.opt.param_groups
               for p in g["params"]}
        lr_of = {n: lrs.get(id(p)) for n, p in tm.named_parameters()}
        res = {"missing": missing, "unexpected": unexpected, "lr": lr_of}
        for i in range(2):
            (_, (jout, jlosses)), grads = step(jm)
            g = nnx.state(grads, nnx.Param)
            params, opt_state = adamw(g, opt_state, params)
            nnx.update(jm, params)
            topt.zero_grad()
            tout = tm(tb)
            ttotal, tlosses = tloss(tout)
            ttotal.backward()
            if i == 0:
                res["out"] = {k: (np.asarray(jout[k]),
                                  tout[k].detach().numpy()) for k in OUT_KEYS}
                res["loss"] = {k: (float(jlosses[k]), float(tlosses[k].detach()))
                               for k in jlosses}
                jg = from_jax_params(_flat(g))
                res["grad"] = {n: (jg[n].numpy(), p.grad.numpy().copy())
                               for n, p in tm.named_parameters()
                               if p.requires_grad and p.grad is not None}
            topt.step()
        jp = from_jax_params(_flat(nnx.state(jm, nnx.Param)))
        tp = dict(tm.named_parameters())
        res["param"] = {n: (jp[n].numpy(), tp[n].detach().numpy().copy())
                        for n in jp}
        res["n_masked"] = int((batch["masked_lm_labels"] != -1).sum())
    return res


def test_weights_carry_over_completely(parity):
    assert parity["missing"] == [] and parity["unexpected"] == []


def test_forward_outputs_match_jax(parity):
    for k, (j, t) in parity["out"].items():
        assert t.shape == j.shape, k
        err = np.abs(t.astype(np.float64) - j).max()
        assert err <= 1e-4 * max(1.0, np.abs(j).max()), (k, err)


def test_losses_match_jax(parity):
    assert parity["n_masked"] > 0  # the masked-LM loss is live
    for k, (j, t) in parity["loss"].items():
        assert np.isfinite(t) and j > 0, k
        assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (k, j, t)


def test_grads_and_params_after_two_adamw_steps(parity):
    gmax = max(np.abs(j).max() for j, _ in parity["grad"].values())
    assert gmax > 0
    for n, (j, t) in parity["grad"].items():
        err = np.abs(t - j).max()
        assert err <= 1e-3 * np.abs(j).max() + 1e-6 * gmax, (n, err)
    moved = 0
    for n, (j, t) in parity["param"].items():
        lr = parity["lr"].get(n)
        if lr is None:  # frozen backbone: untouched on both sides
            continue
        err = np.abs(t - j)
        floor = 1e-4 * np.abs(j).max()
        assert (err > floor + 1e-2 * 2 * lr).sum() <= max(1, 1e-3 * err.size), n
        assert err.max() <= floor + 0.25 * 2 * lr, (n, err.max())
        moved += 1
    assert moved > 50


_RUN = r"""
import json, math, pkgutil, sys, importlib
sys.path.insert(0, {repo!r})
import run_torch
import sceneverse_tpu_torch
for m in pkgutil.walk_packages(sceneverse_tpu_torch.__path__, "sceneverse_tpu_torch."):
    importlib.import_module(m.name)
out = run_torch.main({args!r})
hist = out["trainer"].history
print(json.dumps({{
    "losses": [r["total_loss"] for r in hist["train"]],
    "test": out["results"],
    "device": str(out["trainer"].device),
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax")),
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "sceneverse_tpu"),
}}))
"""


def test_run_torch_cpu_two_steps_without_jax(tmp_path):
    args = ["--config-path", os.path.join(REPO, "configs", "final"),
            "--config-name", "synthetic_pretrain", *TINY, "solver.epochs=1",
            "device=cpu", f"base_dir={tmp_path}"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(repo=REPO, args=args)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    assert res["jax_package"] == []
    assert res["device"] == "cpu"
    assert len(res["losses"]) == 2
    assert all(np.isfinite(x) for x in res["losses"])
    assert all(np.isfinite(v) for v in res["test"].values())
    assert list(tmp_path.glob("*/ckpt/best.pth"))


def test_init_comes_from_the_explicit_generator():
    """Two builds with the same rng_seed are identical whatever the global
    torch RNG holds: every parameter is drawn from the model's generator."""
    from sceneverse_tpu_torch.model import build_model

    cfg = load_config(CFG, TINY)
    torch.manual_seed(1)
    a = build_model(cfg).state_dict()
    torch.manual_seed(2)
    b = build_model(cfg).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = build_model(cfg, generator=torch.Generator().manual_seed(7))
    assert not torch.equal(
        a["lang_encoder.model.embeddings.word_embeddings.weight"],
        c.state_dict()["lang_encoder.model.embeddings.word_embeddings.weight"])

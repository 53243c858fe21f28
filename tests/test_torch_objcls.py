"""Port parity for the object-encoder pretraining path: the
sceneverse_tpu_torch ``ObjCls`` model, ``obj_cls_loss``, the AdamW / Adam /
SGD steps under ``warmup_cosine`` / ``warmup_exp``, ``PretrainObjEval``,
``SyntheticObjDataset`` and ``ObjPretrainTrainer`` through
``run_torch.main`` against the JAX package.

Model setup: B = 2 scenes x O = 4 objects x P = 64 points (the plain
sampling route on both sides: SA1 takes the ``sample_and_group`` kernel
only at P >= 256), ``num_classes`` 32, ``cls_hidden`` 64; clip (SA3 to 512)
and bert (768) widths, closed and open vocabulary; the JAX weights carried
by ``from_jax_params``; dropout off (eval mode) and every BatchNorm in
train mode on both sides. The comparison runs in float64 on both sides (the
JAX step under ``jax.enable_x64`` and ``nnx.jit``): in f32 the two
frameworks' train-mode BatchNorm moments are summed in another order,
which flips ReLU and max-pool decisions and moves PointNet++ gradients far
past 1e-4 (``tests/test_torch_unfreeze_slice.py`` describes the same
chaos). In float64 the two sides make the same decisions, so what is
compared is the port's arithmetic. Tolerances, per tensor, on max|port -
jax| / max|jax|: logits and loss 1e-5, gradients and BatchNorm running
statistics 1e-4 (the loss runs its cross-entropy in f32). The f32 forward
is also held, at the 1e-4 of ``test_torch_slice.py``.

Optimizers: the tiny model's parameters and the same random gradients (a
global norm above ``grad_norm`` in some steps, so the clip acts) through
JAX's ``build_optim`` and the port's ``GPSOptimizer``; parameters after 1
and 3 steps within 1e-6 * max(1, max|p|) (f32 in another order; AdamW's
decay at lr 1e-3 x wd 0.05 moves a unit BatchNorm scale by 5e-5 a step, so
a missing decay shows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from torch import nn

from sceneverse_tpu.config import Config as JConfig
from sceneverse_tpu_torch.config import Config as TConfig
from test_torch_slice import _flat

B, O, P = 2, 4, 64
CASES = [("clip", False), ("bert", False), ("clip", True), ("bert", True)]
IDS = [f"{lang}-{'open' if ov else 'closed'}" for lang, ov in CASES]


def _cfg(lang="clip", open_vocab=False, optim="AdamW", sched="warmup_cosine"):
    args = {"AdamW": {"betas": [0.9, 0.98]}, "Adam": {"betas": [0.9, 0.98]},
            "SGD": {"momentum": 0.9}}[optim]
    return {
        "rng_seed": 42, "num_gpu": 1,
        "solver": {"lr": 1e-3, "grad_norm": 5.0, "weight_decay": 0.05,
                   "optim": {"name": optim, "args": args},
                   "sched": {"name": sched, "args": {"warmup_steps": 1}}},
        "data": {"args": {"max_obj_len": O, "num_points": P}},
        "model": {"name": "ObjCls", "language_type": lang,
                  "open_vocab": open_vocab,
                  "num_classes": 607 if open_vocab else 32, "cls_hidden": 64,
                  "loss_list": ["obj_cls_loss"],
                  "vis_loss_list": ["obj_cls_loss"]},
    }


def _batch():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 32, (B, O))
    masks = np.ones((B, O), bool)
    masks[1, 2:] = False  # pad objects: label -100, in BatchNorm's rows
    labels[~masks] = -100
    return {"obj_fts": rng.randn(B, O, P, 6).astype(np.float32),
            "obj_labels": labels, "obj_masks": masks}


def _jax_model(cfg):
    from sceneverse_tpu.model import build_model

    jm = build_model(JConfig(cfg), rngs=nnx.Rngs(0))
    jm.eval()  # dropout off
    for _, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.BatchNorm):
            m.use_running_average = False
    return jm


def _port_model(cfg, jm):
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.model import build_model

    tm = build_model(TConfig(cfg))
    missing, unexpected = load_jax_params(
        tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
    tm.eval()
    for m in tm.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.train()
    return tm, missing, unexpected


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def parity(request):
    """JAX's and the port's logits, loss, gradients and BatchNorm
    statistics after one train-mode forward, in float64."""
    from sceneverse_tpu.optim.loss.loss import Loss as JLoss
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params
    from sceneverse_tpu_torch.optim.loss.loss import Loss as TLoss

    cfg = _cfg(*request.param)
    batch = _batch()
    jm = _jax_model(cfg)
    tm, missing, unexpected = _port_model(cfg, jm)
    res = {"missing": missing, "unexpected": unexpected,
           "keys": set(tm.state_dict())}
    if request.param == CASES[0]:  # the f32 forward, once
        with torch.no_grad():
            res["f32"] = (np.asarray(nnx.jit(lambda m, b: m(b))(jm, {
                k: jnp.asarray(v) for k, v in batch.items()})["obj_logits"]),
                tm({k: torch.from_numpy(v) for k, v in batch.items()}
                   )["obj_logits"].numpy())
        tm, _, _ = _port_model(cfg, jm)  # statistics as loaded
    jloss = JLoss(JConfig(cfg))
    with jax.enable_x64(True):
        f64 = lambda a: (a.astype(jnp.float64)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a)
        nnx.update(jm, jax.tree.map(f64, nnx.state(jm)))
        jb = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                             else None) for k, v in batch.items()}

        def loss_fn(m):
            out = m(jb)
            return jloss(out)[0], out["obj_logits"]

        (jtotal, jlogits), grads = nnx.jit(
            nnx.value_and_grad(loss_fn, has_aux=True))(jm)
        res["jax"] = {
            "logits": np.asarray(jlogits), "loss": float(jtotal),
            "grad": {k: v.numpy() for k, v in from_jax_params(
                _flat(nnx.state(grads, nnx.Param))).items()},
            "stats": {k: v.numpy() for k, v in from_jax_params(
                _flat(nnx.state(jm, nnx.BatchStat))).items()}}
    tm.double()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["obj_fts"] = tb["obj_fts"].double()
    out = tm(tb)
    total, _ = TLoss(TConfig(cfg))(out)
    total.backward()
    res["port"] = {
        "logits": out["obj_logits"].detach().numpy(),
        "loss": float(total.detach()),
        "grad": {n: p.grad.numpy() for n, p in tm.named_parameters()},
        "stats": {n: b.numpy() for n, b in tm.named_buffers()
                  if "running" in n},
        "dtype": out["obj_logits"].dtype}
    return res


def test_objcls_weights_carry_with_no_missing_or_unexpected_key(parity):
    assert parity["unexpected"] == []
    assert parity["missing"] == []
    keys = parity["keys"]
    assert any(k.startswith("point_feature_extractor.encoder.2.") for k in keys)
    assert ("text_embeds" in keys) != any(k.startswith("cls_head.4.")
                                          for k in keys)


def test_objcls_forward_and_loss_match_jax(parity):
    j, t = parity["jax"], parity["port"]
    assert t["dtype"] == torch.float64 and j["logits"].dtype == np.float64
    assert t["logits"].shape == j["logits"].shape
    assert t["logits"].shape[-1] in (32, 607)
    assert _rel(t["logits"], j["logits"]) <= 1e-5
    assert abs(t["loss"] - j["loss"]) <= 1e-5 * max(1.0, abs(j["loss"]))
    if "f32" in parity:
        jl, tl = parity["f32"]
        assert np.abs(tl - jl).max() <= 1e-4 * max(1.0, np.abs(jl).max())


def test_objcls_gradients_match_jax(parity):
    j, t = parity["jax"], parity["port"]
    assert set(t["grad"]) == set(j["grad"]) and len(j["grad"]) >= 29
    for n, want in j["grad"].items():
        assert _rel(t["grad"][n], want) <= 1e-4, n
    assert all(np.abs(g).max() > 0 for n, g in j["grad"].items()
               if n.endswith("conv.weight"))


def test_objcls_batchnorm_statistics_match_jax(parity):
    j, t = parity["jax"], parity["port"]
    assert set(t["stats"]) == set(j["stats"]) and len(j["stats"]) == 18
    for n, want in j["stats"].items():
        assert _rel(t["stats"][n], want) <= 1e-4, n
    assert all(np.abs(v).max() > 0 for n, v in t["stats"].items()
               if n.endswith("running_mean"))


def test_obj_cls_encoder_matches_jax():
    """``ObjClsEncoder``: the MLP head (hidden // 2, dropout 0.3) over
    object features, in eval mode, with JAX's weights carried over."""
    from sceneverse_tpu.modules.vision.obj_cls_encoder import \
        ObjClsEncoder as JEnc
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.modules.build import VISION_REGISTRY

    je = JEnc(input_feat_size=24, hidden_size=32, tgt_cls_num=11,
              rngs=nnx.Rngs(5))
    je.eval()
    te = VISION_REGISTRY.get("ObjClsEncoder")(input_feat_size=24,
                                              hidden_size=32, tgt_cls_num=11)
    assert load_jax_params(te, _flat(nnx.state(je, nnx.Param))) == ([], [])
    te.eval()
    assert te.vis_cls_head[3].p == 0.3 and te.vis_cls_head[0].out_features == 16
    x = np.random.RandomState(6).randn(3, 7, 24).astype(np.float32)
    with torch.no_grad():
        got = te(torch.from_numpy(x)).numpy()
    want = np.asarray(je(jnp.asarray(x)))
    assert got.shape == (3, 7, 11)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- optimizer
OPT_CASES = [(o, s) for o in ("AdamW", "Adam", "SGD")
             for s in ("warmup_cosine", "warmup_exp")]
N_STEPS = 3


def _grads(names_shapes, step):
    rng = np.random.RandomState(100 + step)
    scale = 0.5 if step == 1 else 0.05  # global norm above 5.0 at step 1
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in names_shapes}


@pytest.fixture(scope="module")
def opt_model():
    """One JAX build serves every optimizer case."""
    return _jax_model(_cfg())


@pytest.fixture(scope="module", params=OPT_CASES,
                ids=[f"{o}-{s}" for o, s in OPT_CASES])
def optim_run(request, opt_model):
    """Parameters of both sides after each of N_STEPS steps."""
    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params
    from sceneverse_tpu_torch.optim.build import GPSOptimizer

    cfg = _cfg(optim=request.param[0], sched=request.param[1])
    jm = opt_model
    tm, _, _ = _port_model(cfg, jm)
    _, tx, _, _ = build_optim(JConfig(cfg), jm, total_steps=N_STEPS + 1)
    params = nnx.state(jm, nnx.Param)
    opt_state = tx.init(params)
    jnames = list(_flat(params))
    topt = GPSOptimizer(TConfig(cfg), tm, total_steps=N_STEPS + 1)
    tparams = dict(tm.named_parameters())
    shapes = [(n, tuple(a.shape)) for n, a in _flat(params).items()]

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    leaves, treedef = jax.tree_util.tree_flatten(params)
    steps = []
    for step in range(1, N_STEPS + 1):
        g = _grads(shapes, step)
        jg = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g[n]) for n in jnames])
        params, opt_state = update(jg, opt_state, params)
        topt.zero_grad()
        for n, t in from_jax_params(g).items():
            tparams[n].grad = t.clone()
        topt.step()
        steps.append((
            {k: v.numpy() for k, v in from_jax_params(_flat(params)).items()},
            {n: p.detach().numpy().copy() for n, p in tparams.items()}))
    return {"steps": steps, "groups": topt.opt.param_groups,
            "name": request.param[0]}


@pytest.mark.parametrize("step", [1, N_STEPS])
def test_optimizer_steps_match_jax_build_optim(optim_run, step):
    want, got = optim_run["steps"][step - 1]
    assert set(got) == set(want)
    for n, w in want.items():
        err = np.abs(got[n] - w).max()
        assert err <= 1e-6 * max(1.0, np.abs(w).max()), (n, err)


def test_optimizer_groups_follow_objcls_spec(optim_run):
    """One group at solver.lr, kept whole (``no_decay_split: False``); its
    decay is solver.weight_decay under AdamW and 0 under Adam and SGD."""
    groups = optim_run["groups"]
    assert len(groups) == 1 and groups[0]["base_lr"] == 1e-3
    assert groups[0]["weight_decay"] == (
        0.05 if optim_run["name"] == "AdamW" else 0.0)
    if optim_run["name"] == "SGD":
        assert groups[0]["momentum"] == 0.9 and groups[0]["dampening"] == 0


def test_warmup_exp_ratios_match_jax_over_the_schedule():
    from sceneverse_tpu.optim.scheduler import get_schedule_fn as jsched
    from sceneverse_tpu_torch.optim.scheduler import get_schedule_fn as tsched

    for warmup, gamma in ((0, 0.1), (3, 0.1), (5, 0.5)):
        cfg = {"num_gpu": 2, "solver": {"sched": {"name": "warmup_exp", "args": {
            "warmup_steps": warmup, "gamma": gamma}}}}
        total = 40
        j, t = jsched(JConfig(cfg), total), tsched(TConfig(cfg), total)
        for s in range(total + 1):
            want = float(j(jnp.int32(s)))
            assert t(s) == pytest.approx(want, rel=1e-6, abs=1e-7), (s, warmup)
        # the exponent counts from step 0: past the warmup, not 1 at its end
        if warmup:
            end = 2 * warmup
            assert t(end + 1) == pytest.approx(
                gamma ** ((end + 1) / (total - end)))


class _JTiny(nnx.Module):
    """A Linear and a LayerNorm under one optimizer group."""

    def __init__(self, split, *, rngs):
        self.lin = nnx.Linear(4, 6, rngs=rngs)
        self.norm = nnx.LayerNorm(6, rngs=rngs)
        self.split = split

    def get_opt_params(self):
        return [{"prefix": (), "lr": 1e-2, "weight_decay": 0.05,
                 "no_decay_split": self.split}]

    def frozen_prefixes(self):
        return []


class _TTiny(nn.Module):
    def __init__(self, split):
        super().__init__()
        self.lin = nn.Linear(4, 6)
        self.norm = nn.LayerNorm(6)
        self.split = split

    def get_opt_params(self):
        return [{"prefix": (), "lr": 1e-2, "weight_decay": 0.05,
                 "no_decay_split": self.split}]

    def frozen_prefixes(self):
        return []


@pytest.mark.parametrize("split", [False, True])
def test_no_decay_split_flag_decays_biases_and_norm_scales_as_jax(split):
    """``no_decay_split: False`` keeps a group whole: biases and norm
    scales decay at the group's rate under AdamW, as in JAX
    (``optim/build.py:82`` there); with the split they do not."""
    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params
    from sceneverse_tpu_torch.optim.build import GPSOptimizer

    cfg = {"num_gpu": 1, "solver": {
        "optim": {"name": "AdamW", "args": {}},
        "sched": {"name": "warmup_cosine", "args": {"warmup_steps": 0}}},
        "model": {"loss_list": []}}
    jm = _JTiny(split, rngs=nnx.Rngs(0))
    nnx.update(jm, jax.tree.map(lambda a: a + 0.5, nnx.state(jm, nnx.Param)))
    tm = _TTiny(split)
    params = nnx.state(jm, nnx.Param)
    tm.load_state_dict(from_jax_params(_flat(params)))
    _, tx, _, _ = build_optim(JConfig(cfg), jm, total_steps=10)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = tx.update(zeros, tx.init(params), params)
    want = from_jax_params(_flat(optax.apply_updates(params, updates)))
    opt = GPSOptimizer(TConfig(cfg), tm, total_steps=10)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt.step()  # zero gradients: only the decay moves a parameter
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    moved = {n for n, p in tm.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    decayed = {"lin.weight", "lin.bias", "norm.weight", "norm.bias"} \
        if not split else {"lin.weight"}
    assert moved == decayed


# ---------------------------------------------------------------- evaluator
def test_pretrain_obj_eval_matches_jax_including_an_all_masked_batch():
    from sceneverse_tpu.evaluator.objcls_eval import PretrainObjEval as JEval
    from sceneverse_tpu_torch.evaluator.objcls_eval import \
        PretrainObjEval as TEval

    rng = np.random.RandomState(4)
    cfg = {"eval": {"save": False}}
    jev, tev = JEval(JConfig(cfg)), TEval(TConfig(cfg))
    batches = []
    for valid in (0.7, 0.0, 1.0):
        logits = rng.randn(3, 5, 7).astype(np.float32)
        labels = rng.randint(0, 7, (3, 5))
        labels[0, 0] = logits[0, 0].argmax()  # one sure hit
        masks = rng.rand(3, 5) < valid
        batches.append({"obj_logits": logits, "obj_labels": labels,
                        "obj_masks": masks})
    for b in batches:
        jev.update({k: jnp.asarray(v) for k, v in b.items()})
        tev.update({k: torch.from_numpy(v) for k, v in b.items()})
        # per batch, the ratio with the count floored at 1
        want = {k: float(v) for k, v in jev.batch_metrics(
            {k: jnp.asarray(v) for k, v in b.items()}).items()}
        got = {k: float(v) for k, v in tev.batch_metrics(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()}
        assert got == pytest.approx(want, abs=1e-7)
    (jbest, jres), (tbest, tres) = jev.record(), tev.record()
    assert tbest == jbest and set(tres) == set(jres)
    for k in jres:
        assert tres[k] == pytest.approx(float(jres[k]), rel=1e-12), k
    valid = sum(int(b["obj_masks"].sum()) for b in batches)
    hits = sum(int(((b["obj_logits"].argmax(-1) == b["obj_labels"])
                    & b["obj_masks"]).sum()) for b in batches)
    assert tres["accuracy"] == pytest.approx(hits / valid)
    empty = TEval(TConfig(cfg))
    empty.update({k: torch.from_numpy(v) for k, v in batches[1].items()})
    assert empty.record()[1]["accuracy"] == 0.0


# ------------------------------------------------------------------ dataset
@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_obj_dataset_items_are_identical(split):
    from sceneverse_tpu.data.datasets.synthetic import \
        SyntheticObjDataset as JDs
    from sceneverse_tpu_torch.data.datasets.synthetic import \
        SyntheticObjDataset as TDs

    cfg = {"data": {"synthetic_size": 6, "args": {"max_obj_len": 5,
                                                  "num_points": 16}},
           "model": {"num_classes": 40}}
    jds, tds = JDs(JConfig(cfg), split), TDs(TConfig(cfg), split)
    assert len(jds) == len(tds) == 6
    for i in range(6):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                    b[k].tobytes(), k
            else:
                assert a[k] == b[k], k
        assert (b["obj_labels"][~b["obj_masks"]] == -100).all()


# -------------------------------------------------------------- entry point
@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """``run_torch.main`` on ``tests/test_trainer_e2e.py``'s config (2
    epochs of 2 steps, val and test), then again with ``resume=True``."""
    import run_torch
    from sceneverse_tpu_torch.config import save_config
    from sceneverse_tpu_torch.trainer.objpretrain_trainer import \
        ObjPretrainTrainer
    from test_trainer_e2e import objcls_cfg

    base = tmp_path_factory.mktemp("objcls")
    cfg = TConfig(objcls_cfg(base).to_dict())
    cfg.device = "cpu"
    save_config(cfg, str(base / "objcls.yaml"))
    seen = []
    real = ObjPretrainTrainer.train_forward_backward

    def spy(self, batch, *metrics_fn):
        seen.append(sorted(batch))
        return real(self, batch, *metrics_fn)

    argv = ["--config-path", str(base), "--config-name", "objcls"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ObjPretrainTrainer, "train_forward_backward", spy)
        first = run_torch.main(argv)
        second = run_torch.main(argv + ["resume=True"])
    return first, second, seen


def test_run_torch_objcls_on_the_cpu(entry):
    first, _, seen = entry
    t = first["trainer"]
    assert type(t).__name__ == "ObjPretrainTrainer"
    assert type(t.model).__name__ == "ObjCls" and t.device.type == "cpu"
    assert t.global_step == 4
    assert 0.0 <= first["results"]["accuracy"] <= 1.0
    assert len(seen) == 4
    assert all("cur_step" not in k and "total_steps" not in k for k in seen)
    assert seen[0] == ["data_idx", "obj_fts", "obj_labels", "obj_masks"]
    losses = [r["total_loss"] for r in t.history["train"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(t.history["val"]) == 2


def test_run_torch_objcls_resume_restores_parameters_bit_for_bit(entry):
    first, second, _ = entry
    a, b = first["trainer"], second["trainer"]
    assert b.resumed_from is not None and b.exp_tracker.epoch == 2
    assert b.history["train"] == []  # nothing left to train
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert b.optimizer.step_count == a.optimizer.step_count == 4
    assert second["results"]["accuracy"] == first["results"]["accuracy"]

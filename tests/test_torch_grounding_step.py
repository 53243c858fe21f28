"""Port parity of one ``OpenVocab`` train step (forward, the pretrain
losses, backward) with ``model.grounding`` set to each grounding variant,
``EntitySpatialCrossEncoder`` and ``UnifiedSpatialCrossEncoderV1``,
against the JAX package's step.

Setup: ``tests/test_model_optim.py``'s tiny GPS model and batch (hidden
32, 4 heads, a trainable PointNet++, ``OVPretrainHead`` over 100 words,
``lm_cls_loss`` + ``TextObjWithinBatch``; B = 2 scenes x 5 objects x 64
points, 7 tokens, one padded object and one padded sentence tail) with one
layer a tower and 2 grounding layers; eval mode (no dropout, BatchNorm on
its running statistics), the plain attention path on both sides
(``SCENEVERSE_FUSED_MHA=off``: the fused attention at these lengths is held
by ``tests/test_torch_grounding_variants.py``). The JAX model is built
once, with seeded random values (``random_build``), and each variant's
JAX grounding module is set into it; every JAX parameter is carried by
``from_jax_params`` and none is left over.

Tolerances: the loss 1e-5 * max(1, |jax|); every gradient tensor of the
port 1e-4 * max|its jax gradient| + 1e-6 * the largest gradient (f32
gradients in another summation order, through a PointNet++ whose eval
BatchNorm makes no batch-order decision)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sceneverse_tpu_torch.config import Config as TConfig
from test_model_optim import gps_batch, tiny_gps_cfg
from test_torch_slice import _flat

# each variant: the attention layers with a packed in-projection a layer
VARIANTS = {"EntitySpatialCrossEncoder": 1, "UnifiedSpatialCrossEncoderV1": 3}
GROUNDING_ARGS = {"hidden_size": 32, "num_attention_heads": 4,
                  "spatial_dim": 5, "num_layers": 2, "dim_loc": 6,
                  "pairwise_rel_type": "center"}


def random_build(factory, seed=0):
    """A JAX module with seeded random values: its structure from
    ``nnx.eval_shape`` (no XLA compile of the initialiser, which costs
    seconds for a whole model), every parameter normal(0, 0.05) (LayerNorm
    and BatchNorm scales 1 + normal(0, 0.1)), BatchNorm statistics 0 / 1,
    PRNG keys from 0. The port is held to whatever values it carries."""
    import jax

    graphdef, state = nnx.split(nnx.eval_shape(factory))
    rng = np.random.RandomState(seed)

    def fill(path, x):
        names = [str(getattr(p, "key", getattr(p, "name", p)))
                 for p in path]
        name = names[-2] if names[-1] == "value" else names[-1]
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            return jax.random.key(0)
        if np.issubdtype(x.dtype, np.integer) or name == "mean":
            return jnp.zeros(x.shape, x.dtype)
        if name == "var":
            return jnp.ones(x.shape, x.dtype)
        v = rng.randn(*x.shape) * (0.1 if name == "scale" else 0.05)
        return jnp.asarray((v + (name == "scale")).astype(x.dtype))

    return nnx.merge(graphdef,
                     jax.tree_util.tree_map_with_path(fill, state))


def _cfg(name):
    cfg = tiny_gps_cfg()
    cfg.model.language.args.num_hidden_layers = 1
    cfg.model.vision.args.num_layers = 1
    cfg.model.grounding = {"name": name, "lr": 1e-4,
                           "args": dict(GROUNDING_ARGS)}
    return cfg


@pytest.fixture(scope="module")
def jax_model():
    """The JAX tiny model, built once, and the batch."""
    from sceneverse_tpu.model import build_model

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        cfg = _cfg("EntitySpatialCrossEncoder")
        jm = random_build(lambda: build_model(cfg, rngs=nnx.Rngs(0)))
    batch = {k: np.array(v) for k, v in gps_batch().items()}
    batch["txt_masks"][1, 5:] = 0
    batch["obj_masks"][0, 4] = False
    return jm, batch


@pytest.fixture(scope="module", params=list(VARIANTS))
def step(request, jax_model):
    import sceneverse_tpu.modules  # noqa: F401  (registries)
    from sceneverse_tpu.modules.build import GROUNDING_REGISTRY
    from sceneverse_tpu.optim import build_optim
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    jm, batch = jax_model
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        cfg = _cfg(name)
        jm.unified_encoder = random_build(
            lambda: GROUNDING_REGISTRY.get(name)(rngs=nnx.Rngs(1),
                                                 **GROUNDING_ARGS), 1)
        jm.eval()
        tm = build_model(TConfig(cfg.to_dict()))
        missing, unexpected = load_jax_params(
            tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
        tm.eval()
        loss_mod = build_optim(cfg, jm, total_steps=10)[0]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jtotal, jlosses), grads = nnx.jit(nnx.value_and_grad(
            lambda m: loss_mod(m(jb)), has_aux=True))(jm)
        ttotal, tlosses = Loss(TConfig(cfg.to_dict()))(
            tm({k: torch.from_numpy(v) for k, v in batch.items()}))
        ttotal.backward()
        jg = from_jax_params(_flat(nnx.state(grads, nnx.Param)))
    return {"name": name, "missing": missing, "unexpected": unexpected,
            "model": tm, "loss": (float(jtotal), float(ttotal.detach())),
            "losses": {k: (float(jlosses[k]), float(tlosses[k].detach()))
                       for k in jlosses},
            "grad": {n: (jg[n].numpy(), p.grad.numpy())
                     for n, p in tm.named_parameters()
                     if p.grad is not None}}


def test_step_weights_carry(step):
    assert step["unexpected"] == []
    assert all(k.endswith("num_batches_tracked") for k in step["missing"])
    assert type(step["model"].unified_encoder).__name__ == step["name"]


def test_step_loss_matches_jax(step):
    j, t = step["loss"]
    assert np.isfinite(t) and abs(t - j) <= 1e-5 * max(1.0, abs(j)), (j, t)
    for k, (j, t) in step["losses"].items():
        assert abs(t - j) <= 1e-5 * max(1.0, abs(j)), (k, j, t)


def test_step_grads_match_jax(step):
    grads = step["grad"]
    gmax = max(np.abs(j).max() for j, _ in grads.values())
    assert gmax > 0
    # every cross-attention layer of the variant took gradients
    attn = [n for n in grads if n.startswith("unified_encoder.")
            and n.endswith("in_proj_weight")]
    assert len(attn) == VARIANTS[step["name"]] * GROUNDING_ARGS["num_layers"]
    assert all(np.abs(grads[n][1]).max() > 0 for n in attn)
    for n, (j, t) in grads.items():
        err = np.abs(t - j).max()
        assert err <= 1e-4 * np.abs(j).max() + 1e-6 * gmax, (n, err)

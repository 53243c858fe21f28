"""Tower rematerialisation of the port (``model.remat`` /
``model.remat_policy``, ``modules/utils.py::remat``), the port's version of
``tests/test_model_optim.py::test_remat_towers_exact_equivalence`` with
dropout ON: the recompute must draw the same dropout masks and attention
kernel seeds as the forward from the port's own generators and leave both
streams where the forward left them.

Setup: ``synthetic_pretrain`` at the sizes of ``test_torch_slice.py``
(hidden 64, 2 layers per tower, 5 x 64 points, batch 2), train mode, one
forward + loss + backward from the same weights and the same generator
states. Tolerances: losses equal; every gradient within 1e-6 of the
no-remat run relative to that tensor's max (the recompute runs the same
CPU ops on the same inputs, so 0 is expected); generator states equal.
"""

import numpy as np
import pytest
import torch

from sceneverse_tpu_torch.config import load_config as tload
from test_torch_slice import CFG, PARITY

MODES = {
    "full": ["model.remat=true"],
    "dots": ["model.remat=true", "model.remat_policy=dots"],
    "vision_unfrozen": ["model.remat=[vision]",
                        "model.vision.args.freeze=False"],
}


def _step(over):
    """One train step's loss, gradients, generator states after the step,
    BatchNorm running statistics and number of random draws (dropout
    masks and attention-kernel seeds)."""
    from sceneverse_tpu_torch.data.build import get_dataset, numpy_collate
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.modules.utils import (AttentionSeed, Dropout,
                                                    _streams, set_generators)
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    cfg = tload(CFG, PARITY + over)
    ds = get_dataset(cfg, "train")
    batch = {k: torch.from_numpy(v) for k, v in
             numpy_collate([ds[i] for i in range(2)]).items()
             if isinstance(v, np.ndarray)}
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    set_generators(model, 11, "cpu")
    model.train()
    draws = []
    counted = lambda f: lambda *a: draws.append(1) or f(*a)
    for m in model.modules():
        if isinstance(m, AttentionSeed):
            m.draw = counted(m.draw)
        elif isinstance(m, Dropout):
            m.forward = counted(m.forward)
    total, _ = Loss(cfg)(model(batch))
    total.backward()
    return {
        "loss": total.item(),
        "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                  if p.grad is not None},
        "gens": [g.get_state() for g in _streams(model)],
        "stats": {n: b.clone() for n, b in model.named_buffers()
                  if "running" in n},
        "draws": len(draws),
        "remat": model.remat,
    }


@pytest.fixture(scope="module")
def runs():
    out = {}
    for unfrozen in (False, True):
        base = ["model.vision.args.freeze=False"] if unfrozen else []
        out["none_unfrozen" if unfrozen else "none"] = _step(base)
    for name, over in MODES.items():
        out[name] = _step(over)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_matches_no_remat_with_dropout_on(runs, mode):
    ref = runs["none_unfrozen" if mode == "vision_unfrozen" else "none"]
    got = runs[mode]
    assert got["remat"] == ({"vision"} if mode == "vision_unfrozen"
                            else {"language", "grounding"})
    # the recompute ran the towers again and drew their randomness again
    assert got["draws"] > ref["draws"] > 0, (got["draws"], ref["draws"])
    assert got["loss"] == ref["loss"]
    assert set(got["grads"]) == set(ref["grads"])
    for n, g0 in ref["grads"].items():
        err = (got["grads"][n] - g0).abs().max().item()
        assert err <= 1e-6 * g0.abs().max().item(), (n, err)
    assert len(got["gens"]) == len(ref["gens"]) == 2
    for a, b in zip(got["gens"], ref["gens"]):
        assert torch.equal(a, b)
    # the recompute moves no BatchNorm statistic a second time
    assert set(got["stats"]) == set(ref["stats"])
    for n, s in ref["stats"].items():
        assert torch.equal(got["stats"][n], s), n


def test_dropout_is_live(runs):
    """Dropout on: a second forward from other generator states gives
    another loss, so equal losses above are not dropout-free."""
    from sceneverse_tpu_torch.data.build import get_dataset, numpy_collate
    from sceneverse_tpu_torch.model import build_model
    from sceneverse_tpu_torch.modules.utils import set_generators
    from sceneverse_tpu_torch.optim.loss.loss import Loss

    cfg = tload(CFG, PARITY)
    ds = get_dataset(cfg, "train")
    batch = {k: torch.from_numpy(v) for k, v in
             numpy_collate([ds[i] for i in range(2)]).items()
             if isinstance(v, np.ndarray)}
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    set_generators(model, 12, "cpu")
    model.train()
    with torch.no_grad():
        total, _ = Loss(cfg)(model(batch))
    assert total.item() != runs["none"]["loss"]


@pytest.mark.parametrize("key,value", [
    ("model.remat", "[text]"), ("model.remat", "points"),
    ("model.remat_policy", "everything")])
def test_unknown_tower_or_policy_raises_as_jax(key, value):
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.model import build_model
    from flax import nnx

    over = PARITY + ["model.remat=true", f"{key}={value}"]
    with pytest.raises(ValueError) as jerr:
        jbuild(jload(CFG, over), rngs=nnx.Rngs(0))
    with pytest.raises(ValueError) as terr:
        build_model(tload(CFG, over))
    assert str(terr.value) == str(jerr.value)

"""Every experiment YAML under ``configs/final`` wires up in the port (its
copy of ``tests/test_configs_all.py``): each registry name resolves in the
port's registries (trainer, model, datasets, wrappers, losses, evaluators,
the modules of the model tree), the model builds on the ``meta`` device (the
whole tree, no weight allocated) and ``GPSOptimizer`` takes non-empty
parameter groups with positive learning rates. Data loading needs dataset
trees: ``tests/test_torch_data_pipeline.py`` and the fixture runs cover it.
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs" / "final"
ALL_YAMLS = sorted(
    p for p in CONFIG_ROOT.rglob("*.yaml") if not p.name.startswith("_"))


def test_the_sweep_sees_every_config():
    assert len(ALL_YAMLS) == 38, [p.stem for p in ALL_YAMLS]


@pytest.mark.parametrize("path", ALL_YAMLS, ids=lambda p: p.stem)
def test_config_wires_up_in_the_port(path):
    import sceneverse_tpu_torch.data  # noqa: F401 (registries)
    from sceneverse_tpu_torch.config import load_config
    from sceneverse_tpu_torch.data.build import DATASET_REGISTRY
    from sceneverse_tpu_torch.data.datasets.dataset_wrapper import \
        DATASETWRAPPER_REGISTRY
    from sceneverse_tpu_torch.evaluator.build import EVALUATOR_REGISTRY
    from sceneverse_tpu_torch.model import MODEL_REGISTRY, build_model
    from sceneverse_tpu_torch.optim.build import GPSOptimizer
    from sceneverse_tpu_torch.optim.loss import contra_loss  # noqa: F401
    from sceneverse_tpu_torch.optim.loss.loss import _FUNCTIONAL, LOSS_REGISTRY
    from sceneverse_tpu_torch.trainer import (  # noqa: F401 (registries)
        debug_trainer, default_trainer, openvocab_trainer)
    from sceneverse_tpu_torch.trainer.build import TRAINER_REGISTRY

    cfg = load_config(str(path), [])
    assert cfg.trainer in TRAINER_REGISTRY, cfg.trainer
    assert cfg.model.name in MODEL_REGISTRY, cfg.model.name
    for split in ("train", "val", "test"):
        for ds in cfg.data.get(split) or []:
            assert ds in DATASET_REGISTRY, f"{split}: {ds}"
        wrapper = cfg.data_wrapper.get(split)
        if wrapper:
            assert wrapper in DATASETWRAPPER_REGISTRY, f"{split}: {wrapper}"
    for key in ("loss_list", "vis_loss_list"):
        for loss in cfg.model.get(key) or []:
            assert loss in _FUNCTIONAL or loss in LOSS_REGISTRY, f"{key}: {loss}"
    for split, spec in (cfg.get("eval") or {}).items():
        if isinstance(spec, dict) and "name" in spec:
            assert spec["name"] in EVALUATOR_REGISTRY, f"{split}: {spec['name']}"
    for dataset in cfg.data.get("val") or []:
        name = cfg.data.get(dataset, {}).get("evaluator")
        if name:
            assert name in EVALUATOR_REGISTRY, f"{dataset}: {name}"

    with torch.device("meta"):
        model = build_model(cfg)
    assert all(p.is_meta for p in model.parameters())
    opt = GPSOptimizer(cfg, model, total_steps=10)
    assert opt.params and opt.opt.param_groups
    groups = model.get_opt_params()
    assert groups and all(float(g["lr"]) > 0 for g in groups)

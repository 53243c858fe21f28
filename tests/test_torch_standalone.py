"""The port stands alone: no file of it imports JAX, flax or the JAX
package, its own copies of the config loader and the synthetic dataset give
what the JAX package's give, and its trainer never falls back to the CPU.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from sceneverse_tpu.config import load_config as jax_load_config
from sceneverse_tpu.data.build import numpy_collate as jax_collate
from sceneverse_tpu.data.datasets.synthetic import (
    SyntheticReferDataset as JaxSyntheticRefer,
)
from sceneverse_tpu_torch.config import load_config, save_config
from sceneverse_tpu_torch.data.build import get_dataset, numpy_collate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "sceneverse_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, f) for f in
       ("run_torch.py", "chip_smoke.py", "profile_torch.py",
        "sa_train_spread.py")])
CONFIGS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "configs", "final", "**", "*.yaml"),
              recursive=True))
FORBIDDEN = ("sceneverse_tpu", "jax", "jaxlib", "flax")
SYNTH = os.path.join(REPO, "configs", "final", "synthetic_pretrain.yaml")


def _imported(path: str) -> list:
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_and_no_jax_package(path):
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert bad == [], bad


def test_the_import_check_sees_every_port_file():
    assert len(PORT_FILES) > 40
    assert "sceneverse_tpu/config.py" not in PORT_FILES
    data = [f"sceneverse_tpu_torch/data/{m}.py" for m in (
        "build", "data_utils", "fixture", "materialized", "native",
        "tokenizer", "datasets/base", "datasets/constant",
        "datasets/data_augmentor", "datasets/dataset_wrapper",
        "datasets/families", "datasets/scannet_qa")]
    finetune = [f"sceneverse_tpu_torch/{m}.py" for m in (
        "common/__init__", "common/box_utils", "modules/heads/grounding_head",
        "modules/heads/qa_head", "evaluator/common",
        "evaluator/referit3d_eval", "evaluator/scanqa_eval",
        "evaluator/sqa3d_eval")]
    objcls = [f"sceneverse_tpu_torch/{m}.py" for m in (
        "model/build", "model/objcls", "modules/vision/obj_cls_encoder",
        "evaluator/objcls_eval", "trainer/objpretrain_trainer")]
    assert set(data) <= set(PORT_FILES)
    assert set(finetune) <= set(PORT_FILES)
    assert set(objcls) <= set(PORT_FILES)


@pytest.mark.parametrize("path", CONFIGS)
def test_port_config_loader_resolves_like_the_jax_package(path):
    overrides = ["dataloader.batchsize=3", "model.vision.args.freeze=False",
                 "solver.optim.args.betas=[0.9,0.95]", "note=null"]
    want = jax_load_config(os.path.join(REPO, path), overrides).to_dict()
    got = load_config(os.path.join(REPO, path), overrides)
    assert got.to_dict() == want
    assert got.model.vision.args.freeze is False


def test_config_round_trips_through_yaml(tmp_path):
    cfg = load_config(SYNTH, ["data.args.num_points=128"])
    save_config(cfg, str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.yaml")).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_dataset_items_are_identical(split):
    cfg = load_config(SYNTH, ["data.synthetic_size=6"])
    ds = get_dataset(cfg, split)
    ds = ds if split == "train" else ds[0]
    ref = JaxSyntheticRefer(jax_load_config(SYNTH, ["data.synthetic_size=6"]),
                            split)
    assert len(ds) == len(ref) == 6
    items, ref_items = [ds[i] for i in range(6)], [ref[i] for i in range(6)]
    for a, b in zip(items, ref_items):
        assert a.keys() == b.keys()
        for k in a:
            assert type(a[k]) is type(b[k]), k
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            else:
                assert a[k] == b[k], k
    got, want = numpy_collate(items), jax_collate(ref_items)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k


def test_base_trainer_without_device_and_without_cuda_raises(monkeypatch,
                                                             tmp_path):
    from sceneverse_tpu_torch.trainer.build import build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(SYNTH, [f"exp_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(cfg)
    cfg = load_config(SYNTH, [f"exp_dir={tmp_path}", "device=cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(cfg)

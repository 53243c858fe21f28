"""The port stands alone: no file of it imports JAX, flax or the JAX
package, its own copies of the config loader and the synthetic dataset give
what the JAX package's give, and its trainer never falls back to the CPU.
"""

import ast
import glob
import os
import re

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
# the port's counterparts of the JAX package's bench_*.py tools
TOOLS = ("bench_latency_torch.py", "bench_towers_torch.py",
         "bench_pipeline_torch.py", "bench_scale_torch.py",
         "bench_caplen_torch.py")
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "sceneverse_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, f) for f in
       ("run_torch.py", "launch_torch.py", "chip_smoke.py",
        "profile_torch.py", "sa_train_spread.py",
        "visualize_data_torch.py") + TOOLS])
CONFIGS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "configs", "final", "**", "*.yaml"),
              recursive=True))
FORBIDDEN = ("sceneverse_tpu", "jax", "jaxlib", "flax", "networkx")
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


# top-level entries of the repository the port must not read from
JAX_SIDE = ("native", "sceneverse_tpu")


def _path_parts(node) -> list | None:
    """The operands of a path expression (``a / "b" / "c"``,
    ``os.path.join(a, "b")``, ``Path(a, "b")``), else None."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        left = _path_parts(node.left)
        return (left if left is not None else [node.left]) + [node.right]
    if isinstance(node, ast.Call):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name in ("join", "Path", "PurePath") and node.args:
            return list(node.args)
    return None


def _jax_side_paths(path: str, root: str = REPO) -> list:
    """String constants of a port file that name a path under ``native/``
    or ``sceneverse_tpu/``: a literal ``native/...`` (a ``file:line``
    citation of a JAX source is not a path), or a path expression whose
    first constant segment after its root is one of them. Docstrings are
    prose and not looked at."""
    tree = ast.parse(open(os.path.join(root, path)).read(), path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr)}
    inner = {id(n.left) for n in ast.walk(tree)  # a chain's own links
             if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div)}
    bad = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and "/" in node.value
                and node.value.split("/")[0] in JAX_SIDE
                and not re.search(r":\d+(-\d+)?$", node.value)):
            bad.append(node.value)
        parts = None if id(node) in inner else _path_parts(node)
        if parts and not isinstance(parts[0], ast.Constant):
            consts = [p.value for p in parts[1:]
                      if isinstance(p, ast.Constant)
                      and isinstance(p.value, str)]
            if consts and consts[0].split("/")[0] in JAX_SIDE:
                bad.append("/".join(consts))
    return bad


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_names_no_path_of_the_jax_side(path):
    """The port reads nothing under ``native/`` or ``sceneverse_tpu/``: the
    native loader builds the port's own ``csrc/batchops.cpp``."""
    assert _jax_side_paths(path) == []


def test_the_path_check_sees_a_path_into_native(tmp_path):
    from sceneverse_tpu_torch.data import native

    (tmp_path / "probe.py").write_text(
        'SOURCE = REPO / "native" / "batchops.cpp"\n'
        'A = os.path.join(REPO, "sceneverse_tpu", "x.py")\n'
        'B = "sceneverse_tpu/ops/pallas/mha.py:365"\n'
        'C = REPO / "build" / "native"\n'
        'D = "native/libbatchops.so"\n')
    assert _jax_side_paths("probe.py", str(tmp_path)) == [
        "native/batchops.cpp", "sceneverse_tpu/x.py",
        "native/libbatchops.so"]
    port = os.path.join(REPO, "sceneverse_tpu_torch")
    assert str(native.SOURCE).startswith(port + os.sep)
    # the copy's code is the JAX side's, byte for byte, below its header
    body = lambda b: b[b.index(b"#include"):]
    with open(os.path.join(REPO, "native", "batchops.cpp"), "rb") as f:
        assert body(native.SOURCE.read_bytes()) == body(f.read())


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
    tools = [f"sceneverse_tpu_torch/{m}.py" for m in (
        "common/io_utils", "preprocess/__init__", "preprocess/align_utils",
        "preprocess/build", "preprocess/fixture", "preprocess/hm_semantic",
        "preprocess/label_convert", "preprocess/mesh_io",
        "preprocess/processors", "preprocess/ssg/__init__",
        "preprocess/ssg/dictionary", "preprocess/ssg/objnode",
        "preprocess/ssg/relationships", "preprocess/ssg/ssg_main",
        "preprocess/ssg/visualize")] + ["visualize_data_torch.py"]
    assert set(data) <= set(PORT_FILES)
    assert set(finetune) <= set(PORT_FILES)
    assert set(objcls) <= set(PORT_FILES)
    assert set(tools) <= set(PORT_FILES)
    assert set(TOOLS) <= set(PORT_FILES)


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


OFFLINE_TOOLS_WITHOUT_OPTIONAL_PACKAGES = """
import sys
for name in ("networkx", "joblib", "matplotlib", "jax"):
    sys.modules[name] = None  # an import of any of them raises
import json, pathlib
import numpy as np
from sceneverse_tpu_torch.config import Config
from sceneverse_tpu_torch.data.fixture import write_synthetic_tree
from sceneverse_tpu_torch.preprocess import fixture
from sceneverse_tpu_torch.preprocess.processors import Structured3DProcessor
from sceneverse_tpu_torch.preprocess.ssg.ssg_main import generate_ssg

root = pathlib.Path(sys.argv[1])
fixture.write_s3d_scan(root / "raw", "train", "scene_00000",
                       np.random.RandomState(0), 200, 4)
Structured3DProcessor(Config({
    "data_root": str(root / "raw"), "save_root": str(root / "out"),
    "output": {"pcd": True}, "device": "cpu", "seed": 0})).process_scans()
tree = write_synthetic_tree(root / "tree", n_scans=1)
rels, objs = generate_ssg(tree / "scan_data", root / "ssg", device="cpu",
                          seed=0)
assert rels and objs
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] == "sceneverse_tpu")))
"""


def test_offline_tools_run_without_networkx_joblib_matplotlib(tmp_path):
    """The card's machine has none of networkx, joblib and matplotlib: a
    processor and the scene-graph generator run with all three (and JAX)
    unimportable, and load nothing of the JAX package."""
    import json
    import subprocess
    import sys

    run = subprocess.run(
        [sys.executable, "-c", OFFLINE_TOOLS_WITHOUT_OPTIONAL_PACKAGES,
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "ssg/relationships.json").exists()
    assert (tmp_path / "out/scan_data/pcd_with_global_alignment/"
            "scene_00000.pth").exists()

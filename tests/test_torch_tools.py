"""The port's measuring tools (``bench_*_torch.py`` at the repository root)
against the JAX package's ``bench_*.py``, on the CPU at small sizes.

  1. ``sceneverse_tpu_torch/utils/gps_inputs.py`` gives the arrays of
     ``__graft_entry__._gps_batch`` exactly (seed 3, B = 2, 8 objects x 64
     points; the JAX helper's ints are int32 without 64-bit JAX, the port's
     int64, values equal) and the configuration of ``_gps_cfg``.
  2. ``bench_caplen_torch.measure`` equals ``bench_caplen.measure`` on one
     fixture tree, but for ``source``.
  3. The latency tool's grounding function at 2 layers, hidden 64 (4 heads:
     the JAX helper's 12 do not divide 64, so both configurations take 4),
     f32, against the JAX tool's ``ground`` (the eval forward to the og3d
     logits' argmax and max) on the same weights through the port's
     converter: argmax equal, max within 1e-5 relative. Both sides take the
     unfused attention, and JAX's frozen PointNet++ takes the port's
     features on the same points (as ``tests/test_torch_ddp.py`` does).
  4. The towers tool's result keys are ``bench_towers.py``'s.
  5. Each tool, run with ``--device cpu`` at a tiny setting, prints lines
     that parse, carry the device record and use the JAX tool's metric
     names.
  6. With no card and no ``--device cpu``, every tool raises.
"""

import ast
import importlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TOOLS = ["bench_latency_torch", "bench_towers_torch", "bench_pipeline_torch",
         "bench_scale_torch", "bench_caplen_torch"]
# the model and batch flags of the latency and towers tools at tiny sizes
TINY_MODEL = ["--hidden", "64", "--layers", "1", "--heads", "4", "--vocab",
              "1000", "--num-obj", "8", "--num-points", "64", "--seq-len",
              "16"]
# bench_pipeline_torch.bench_cfg at tiny widths
TINY_PIPELINE = [
    "model.language.args.hidden_size=64",
    "model.language.args.num_hidden_layers=1",
    "model.language.args.num_attention_heads=4",
    "model.vision.args.hidden_size=64", "model.vision.args.num_layers=1",
    "model.vision.args.num_attention_heads=4",
    "model.vision.args.dim_feedforward=128",
    "model.grounding.args.hidden_size=64",
    "model.grounding.args.num_layers=1",
    "model.grounding.args.num_attention_heads=4",
    "model.grounding.args.dim_feedforward=128",
    "model.heads.pretrain_head.args.hidden_size=64",
    "model.heads.pretrain_head.args.vocab_size=1000",
    "data.args.max_obj_len=8", "data.args.num_points=64",
    "dataloader.batchsize=4",
]
TINY_FIXTURE = ["--fixture-scans", "1", "--fixture-objects", "6",
                "--fixture-points", "100"]


def _lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _jax_metrics(path: str) -> set:
    """The metric names a JAX tool prints."""
    src = open(os.path.join(REPO, path)).read()
    return set(re.findall(r'(?:emit\(|"metric": )"(\w+)"', src))


def test_gps_inputs_equal_the_jax_helpers():
    import __graft_entry__ as g
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg

    for kw in ({}, {"hidden": 64, "layers": 2, "vocab": 1000,
                    "use_scene_cap": False}):
        assert gps_cfg(**kw).to_dict() == g._gps_cfg(**kw).to_dict()
    args = (2, 8, 64, 16)
    for kw in ({"seed": 3}, {"seed": 3, "vocab": 1000, "cap_len": 24},
               {"use_scene_cap": False}):
        want, got = g._gps_batch(*args, **kw), gps_batch(*args, **kw)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].shape == v.shape and got[k].dtype.kind == \
                v.dtype.kind, k
            assert np.array_equal(got[k], v), k


def test_caplen_measure_equals_the_jax_tool(tmp_path):
    import bench_caplen
    import bench_caplen_torch
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    root = str(write_synthetic_tree(tmp_path / "tree", n_scans=3,
                                    annos_per_obj=2))
    for max_len in (300, 12):
        want = bench_caplen.measure(root, max_len)
        got = bench_caplen_torch.measure(root, max_len)
        assert got == want
    assert want["truncated_pct"] > 0  # max_len 12 truncates


def test_latency_grounding_matches_the_jax_tool_at_f32(monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import __graft_entry__ as g
    import bench_latency_torch as L
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg
    from test_torch_ddp import _Features
    from test_torch_grounding_step import random_build
    from test_torch_slice import _flat

    # the unfused attention on both sides (the interpret-mode MHA kernel's
    # trace costs seconds; the plain and fused routes are held equal by
    # tests/test_torch_mha.py)
    monkeypatch.setenv("SCENEVERSE_FUSED_MHA", "off")
    kw = {"hidden": 64, "layers": 2, "vocab": 1000}
    jcfg = g._gps_cfg(**kw)
    for tower in ("language", "vision", "grounding"):
        jcfg.model[tower].args["num_attention_heads"] = 4
    jm = random_build(lambda: jbuild(jcfg, rngs=nnx.Rngs(0)), seed=2)
    jm.eval()
    tm = L.build(gps_cfg(heads=4, **kw), "cpu", seed=1)
    missing, unexpected = load_jax_params(
        tm, _flat(nnx.state(jm, nnx.Not(nnx.RngState))))
    assert missing == [] and unexpected == []
    batch = g._gps_batch(4, 8, 64, 16, vocab=1000, seed=5)
    tbatch = to_device(gps_batch(4, 8, 64, 16, vocab=1000, seed=5), "cpu")
    # JAX's frozen PointNet++ (a Pallas kernel, in interpret mode here
    # 15 s of trace) stands in as the port's features on the same points,
    # as in tests/test_torch_ddp.py; tests/test_torch_sa_forward.py holds
    # the two SA paths equal
    with torch.no_grad():
        fts = tbatch["obj_fts"]
        feats = tm.point_encoder.point_feature_extractor(
            fts.reshape(-1, *fts.shape[2:])).numpy()
    jm.point_encoder.point_feature_extractor = _Features(feats)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def ground(state, batch):  # bench_latency.py's, without the bf16 policy
        m = nnx.merge(graphdef, state)
        out = m(batch)
        return (jnp.argmax(out["og3d_logits"], axis=-1),
                jnp.max(out["og3d_logits"], axis=-1))

    jidx, jmax = (np.asarray(x) for x in ground(state, batch))
    tidx, tmax = L.ground(tm, tbatch, amp=False)
    assert np.array_equal(tidx.numpy(), jidx)
    np.testing.assert_allclose(tmax.numpy(), jmax, rtol=1e-5, atol=0)


def test_towers_result_keys_are_the_jax_tools():
    import bench_towers_torch as T
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.gps_inputs import gps_batch, gps_cfg

    tree = ast.parse(open(os.path.join(REPO, "bench_towers.py")).read())
    want = {n.slice.value for n in ast.walk(tree)
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
            and getattr(n.value, "id", None) == "results"}
    assert len(want) == 7
    from bench_latency_torch import build

    model = build(gps_cfg(hidden=64, layers=1, heads=4, vocab=1000), "cpu")
    batch = to_device(gps_batch(2, 8, 64, 16, vocab=1000, cap_len=24),
                      "cpu")
    with torch.no_grad():
        got = T.measure(model, batch, torch.device("cpu"), reps=1)
    assert list(got) == [k for k in got if k in want] and set(got) == want
    assert all(len(v) == 1 and v[0] > 0 for v in got.values())


def _run_main(name, argv, capsys):
    mod = importlib.import_module(name)
    mod.main(argv)
    return _lines(capsys.readouterr().out)


def _check_lines(lines, names):
    assert lines and {r["metric"] for r in lines} == names
    for r in lines:
        assert r["device"]["platform"] == "cpu"
        assert r["device"]["torch"] == torch.__version__


def test_latency_tool_prints_the_jax_metric(capsys):
    lines = _run_main("bench_latency_torch", [
        "--device", "cpu", "--batches", "1,2", "--warmup", "1", "--iters",
        "2", *TINY_MODEL], capsys)
    _check_lines(lines, _jax_metrics("bench_latency.py"))
    assert [r["batch"] for r in lines] == [1, 2]
    for r in lines:
        assert {"p50_ms", "p90_ms", "device_ms_est", "unit"} <= set(r)
        assert len(r["argmax"]) == len(r["max"]) == r["batch"]
        assert 0 <= min(r["argmax"]) and max(r["argmax"]) < 8


def test_towers_tool_prints_the_jax_keys(capsys):
    lines = _run_main("bench_towers_torch", [
        "--device", "cpu", "--batch", "2", "--reps", "1",
        *TINY_MODEL], capsys)
    assert len(lines) == 1
    r = lines[0]
    for k in ("lang_fused_2B", "lang_txt_only", "lang_cap_only",
              "vision_tower", "pointnet_backbone", "unified_encoder",
              "pretrain_head"):
        assert r[k] > 0 and r["min_ms"][k] <= r[k] <= r["max_ms"][k], k
    assert r["pallas_fast"] == "1" and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("mode", ["default", "feed_sweep"])
def test_pipeline_tool_prints_the_jax_metrics(mode, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setenv("SCENEVERSE_BENCH_FIXTURE", str(tmp_path / "fix"))
    extra = ["--feed-sweep"] if mode == "feed_sweep" else []
    lines = _run_main("bench_pipeline_torch", [
        "--device", "cpu", "--steps", "2", "--reps", "1", *TINY_FIXTURE,
        *extra, *TINY_PIPELINE], capsys)
    names = _jax_metrics("bench_pipeline.py")
    want = ({"materialized_feed_scenes_per_sec",
             "trainer_feed_scenes_per_sec"} if extra
            else names - {"trainer_feed_scenes_per_sec"})
    _check_lines(lines, want)
    assert want <= names
    for r in lines:
        assert np.isfinite(r["value"]) and r["value"] > 0, r
    if not extra:  # on the CPU there is no pinned copy to time
        h2d = [r for r in lines
               if r["metric"] == "h2d_batch_transfer_mb_per_sec"]
        assert [r["memory"] for r in h2d] == ["pageable"]


def test_scale_tool_prints_the_jax_metrics(tmp_path, capsys):
    """Each phase in this process (a user's run starts one subprocess a
    phase; the card's smoke runs it so)."""
    import bench_scale_torch as S

    base = ["--device", "cpu", "--scans", "12", "--batch", "8", "--steps",
            "2", "--root", str(tmp_path / "scale")]
    lines = []
    for phase in S.PHASES:
        lines += _run_main("bench_scale_torch", base + ["--phase", phase],
                           capsys)
    _check_lines(lines, _jax_metrics("bench_scale.py"))
    mesh = next(r for r in lines
                if r["metric"] == "scale_feed_dp8_scenes_per_sec")
    assert (mesh["dp"], mesh["rank"], mesh["rows_per_rank"]) == (8, 0, 1)
    items = {r["metric"]: r.get("items") for r in lines}
    assert items["scale_scanbase_full_load"] == items["scale_store_open"] > 0


def test_caplen_tool_prints_the_jax_metric(tmp_path, capsys):
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree

    root = str(write_synthetic_tree(tmp_path / "tree"))
    lines = _run_main("bench_caplen_torch", ["--device", "cpu", "--root",
                                             root], capsys)
    _check_lines(lines, _jax_metrics("bench_caplen.py"))
    assert lines[0]["source"] == root and lines[0]["n"] > 0


@pytest.mark.parametrize("name", TOOLS)
def test_a_tool_without_a_card_and_without_cpu_raises(name, monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SCENEVERSE_BENCH_FIXTURE", str(tmp_path / "fix"))
    mod = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["--root", str(tmp_path)] if name in (
            "bench_scale_torch", "bench_caplen_torch") else [])

"""The port's scene-graph generation and visualizers against the JAX
package on the CPU.

The JAX package draws relation phrases from the global ``random`` module
and keeps the graph in a networkx ``DiGraph``; the port draws from an
explicit ``random.Random`` and keeps a ``SceneGraph``. Seeding
``random.seed(s)`` on one side and ``random.Random(s)`` on the other must
give equal relations, equal nodes and edges in networkx's order, and
byte-identical JSON files."""

import filecmp
import random
import sys

import numpy as np
import pytest
import torch

import sceneverse_tpu.preprocess.ssg.ssg_main as jax_ssg
from sceneverse_tpu.data.fixture import write_synthetic_tree
from sceneverse_tpu.preprocess.mesh_io import load_ply as jax_load_ply
from sceneverse_tpu.preprocess.ssg.visualize import vis_dataset as jax_vis
from sceneverse_tpu_torch.preprocess.ssg import ssg_main
from sceneverse_tpu_torch.preprocess.ssg.objnode import ObjNode
from sceneverse_tpu_torch.preprocess.ssg.visualize import vis_dataset

SEED = 11


def rich_scene(seed, with_floor):
    """Object boxes (id, label, position, size) of one room that give every
    kind of relation: a floor (or none, so the graph adds its own), tables
    with things on them, chairs, a cabinet with a box inside, a curtain and
    its rod, a tv and a mirror on the walls, a lamp above a table, walls."""
    rng = np.random.RandomState(seed)
    objs = []

    def add(label, center, size):
        objs.append((label, np.asarray(center, float), np.asarray(size, float)))

    if with_floor:
        add("floor", [0, 0, 0.05], [6, 6, 0.1])
    add("wall", [0, 3, 1.5], [6, 0.1, 3])
    for t in range(2):
        x, y = rng.uniform(-2, 2, 2)
        add("table", [x, y, 0.4], [1.2, 0.8, 0.8])
        for thing in ("cup", "book"):
            dx, dy = rng.uniform(-0.4, 0.4), rng.uniform(-0.25, 0.25)
            h = rng.uniform(0.1, 0.3)
            add(thing, [x + dx, y + dy, 0.8 + h / 2], [0.2, 0.2, h])
        if t == 0:
            add("lamp", [x, y, 2.2], [0.3, 0.3, 0.2])
    for _ in range(3):
        x, y = rng.uniform(-2.5, 2.5, 2)
        add("chair", [x, y, 0.45], [0.5, 0.5, 0.9])
    add("cabinet", [2.5, -2.5, 0.5], [1.0, 0.6, 1.0])
    add("box", [2.5, -2.5, 0.5], [0.3, 0.3, 0.3])
    add("curtain", [-1, 2.9, 1.2], [1.5, 0.1, 2.0])
    add("curtain rod", [-1, 2.9, 2.25], [1.6, 0.05, 0.05])
    add("tv", [1, 2.9, 1.5], [1.0, 0.05, 0.6])
    add("mirror", [-2.9, 0, 1.5], [0.05, 0.8, 1.0])
    return objs


def write_rich_tree(root, n_scans=2, pts_per_obj=40):
    """A processed tree whose scans hold ``rich_scene``'s objects as points
    drawn inside their boxes (float64, like the processors' output)."""
    pcd_dir = root / "scan_data/pcd_with_global_alignment"
    label_dir = root / "scan_data/instance_id_to_label"
    pcd_dir.mkdir(parents=True)
    label_dir.mkdir(parents=True)
    for s in range(n_scans):
        rng = np.random.RandomState(100 + s)
        pts, inst, labels = [], [], {}
        for i, (label, c, size) in enumerate(rich_scene(s, s % 2 == 0)):
            pts.append(c + rng.uniform(-0.5, 0.5, (pts_per_obj, 3)) * size)
            inst.append(np.full(pts_per_obj, i + 1))
            labels[i + 1] = label
        pts.append(rng.uniform(-3, 3, (30, 3)))
        inst.append(np.full(30, -1))
        pts = np.concatenate(pts)
        torch.save((pts, rng.uniform(0, 255, pts.shape), np.concatenate(inst)),
                   pcd_dir / f"rich{s:02d}.pth")
        torch.save(labels, label_dir / f"rich{s:02d}.pth")
    return root


def _scene_dict(objs):
    pts = np.concatenate([[c - s / 2, c + s / 2] for _, c, s in objs])
    return {
        "scan": "rich", "point_max": pts.max(0).tolist(),
        "point_min": pts.min(0).tolist(),
        "objects": [{"id": i + 1, "label": label, "position": c.tolist(),
                     "size": s.tolist()} for i, (label, c, s) in enumerate(objs)],
        "inst_to_label": {i + 1: label for i, (label, _, _) in enumerate(objs)},
    }


@pytest.mark.parametrize("tree", ["synthetic", "rich"])
def test_load_scene_objects_matches_jax(tree, tmp_path):
    root = (write_synthetic_tree(tmp_path, n_scans=2) if tree == "synthetic"
            else write_rich_tree(tmp_path))
    scans = sorted((root / "scan_data/pcd_with_global_alignment").glob("*.pth"))
    assert len(scans) == 2
    for path in scans:
        got = ssg_main.load_scene_objects(root / "scan_data", path.stem, "cpu")
        want = jax_ssg.load_scene_objects(root / "scan_data", path.stem)
        assert got == want
        assert len(got["objects"]) >= 6


@pytest.mark.parametrize("with_floor", [True, False])
def test_build_scene_graph_matches_networkx(with_floor):
    scene = _scene_dict(rich_scene(3, with_floor))
    random.seed(SEED)
    G, rels, multi, nodes = jax_ssg.build_scene_graph(scene)
    g, got_rels, got_multi, got_nodes = ssg_main.build_scene_graph(
        scene, rng=random.Random(SEED))
    assert got_rels == rels
    assert got_multi == multi
    assert g.nodes() == list(G.nodes(data="label"))
    assert g.edges() == list(G.edges(data="label"))
    assert list(got_nodes) == list(nodes)
    for k, node in nodes.items():
        mine = got_nodes[k]
        assert (mine.id, mine.label, mine.room_id) == (node.id, node.label,
                                                       node.room_id)
        np.testing.assert_array_equal(mine.position, node.position)
        np.testing.assert_array_equal(mine.size, node.size)
    phrases = {r[2] for r in rels}
    # the scene reaches every relation family and several random draws
    assert any("o'clock" in p for p in phrases)
    assert phrases & {"hanging on", "hung on", "mounted on", "affixed to"}
    assert phrases & {"resting on", "placed on", "on", "supported by",
                      "on the top of"}
    assert "support" in phrases
    assert multi["aligned"] or multi["middle"]


def test_scene_graph_keeps_digraph_order():
    """Re-added nodes and edges keep their places; an edge adds its missing
    ends unlabelled; successors in first-insertion order."""
    import networkx as nx

    ops = [("n", 3, "a"), ("n", 1, "b"), ("e", 3, 1, "s"), ("e", 3, 7, "t"),
           ("n", 3, "c"), ("e", 1, 3, "u"), ("e", 3, 1, "v"), ("e", 9, 9, "w")]
    G, g = nx.DiGraph(), ssg_main.SceneGraph()
    for op in ops:
        if op[0] == "n":
            G.add_node(op[1], label=op[2])
            g.add_node(op[1], label=op[2])
        else:
            G.add_edge(op[1], op[2], label=op[3])
            g.add_edge(op[1], op[2], label=op[3])
    assert g.nodes() == list(G.nodes(data="label"))
    assert g.edges() == list(G.edges(data="label"))
    assert list(g) == list(G)
    for n in G:
        assert g.successors(n) == list(G.successors(n))


@pytest.mark.parametrize("tree", ["synthetic", "rich"])
def test_generate_ssg_writes_jax_bytes(tree, tmp_path):
    root = (write_synthetic_tree(tmp_path / "t", n_scans=2)
            if tree == "synthetic" else write_rich_tree(tmp_path / "t"))
    random.seed(SEED)
    want = jax_ssg.generate_ssg(root / "scan_data", tmp_path / "jax")
    got = ssg_main.generate_ssg(root / "scan_data", tmp_path / "port",
                                device="cpu", seed=SEED)
    assert got == want and len(got[0]) == 2
    for name in ("relationships.json", "objects.json"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name


def test_generate_ssg_without_device_and_without_cuda_raises(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = write_synthetic_tree(tmp_path, n_scans=1)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            ssg_main.generate_ssg(root / "scan_data", tmp_path / "o", **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            ssg_main.load_scene_objects(root / "scan_data", "scene0000_00", **kw)


def test_ssg_visualize_renders_like_jax(tmp_path):
    root = write_synthetic_tree(tmp_path, n_scans=1)
    scan = next((root / "scan_data/pcd_with_global_alignment").glob("*.pth")).stem
    rels = [["1", "2", "close to"], ["1", -2, "in the center"], ["bad"],
            ["1", "9", "far"]]
    written = []
    for side, node_cls, vis in (("port", ObjNode, vis_dataset),
                                ("jax", None, jax_vis)):
        if node_cls is None:
            from sceneverse_tpu.preprocess.ssg.objnode import ObjNode as node_cls
        nodes = {"1": node_cls("1", "chair", [0, 0, 0.5], [1, 1, 1]),
                 "2": node_cls("2", "table", [1.5, 0, 0.5], [1, 1, 1])}
        out = vis(nodes, rels, root / "scan_data", scan, tmp_path / side, limit=8)
        written.append(sorted(p.name for p in out))
        assert all(p.exists() and p.stat().st_size > 0 for p in out)
    assert written[0] == written[1] and len(written[0]) == 2


def test_visualize_data_torch_exports_like_jax(tmp_path, monkeypatch):
    import visualize_data
    import visualize_data_torch

    root = write_synthetic_tree(tmp_path / "tree", n_scans=1)
    outs = {}
    for side, mod in (("port", visualize_data_torch), ("jax", visualize_data)):
        out = tmp_path / side
        monkeypatch.setattr(sys, "argv", [
            "visualize_data.py", "--root", str(root), "--dataset", "scannet",
            "--vis_refer", "--out", str(out)])
        random.seed(SEED)
        mod.main()
        outs[side] = out
    names = {s: sorted(p.name for p in o.iterdir()) for s, o in outs.items()}
    assert names["port"] == names["jax"]
    plys = [n for n in names["port"] if n.endswith(".ply")]
    assert len(plys) == 3 and len(names["port"]) == 6
    for name in plys:
        assert ((outs["port"] / name).read_bytes()
                == (outs["jax"] / name).read_bytes()), name
    ref = jax_load_ply(outs["port"] / plys[-1])
    assert ref["vertices"].shape[0] > 0

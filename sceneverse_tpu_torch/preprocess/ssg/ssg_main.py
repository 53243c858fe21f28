"""Scene-graph generation entry point (reference preprocess/ssg/ssg_main.py:132-343),
the port's own copy of ``sceneverse_tpu/preprocess/ssg/ssg_main.py``:
processed scans -> per-scene graph with support / embedded / hanging /
proximity / aligned / middle relations -> relationships.json +
objects.json.

The per-object boxes are a segment reduction over the scan's points on a
device (``device``, default ``cuda``); the graph is O(objects^2) Python over
the objects and stays on the host, in ``SceneGraph`` (the JAX package uses a
networkx ``DiGraph``, which the port does not depend on).
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import torch

from sceneverse_tpu_torch.preprocess.build import resolve_device
from sceneverse_tpu_torch.preprocess.ssg import dictionary as D
from sceneverse_tpu_torch.preprocess.ssg.objnode import ObjNode
from sceneverse_tpu_torch.preprocess.ssg.relationships import (
    cal_hanging_relations,
    cal_proximity_relations,
    cal_support_relations,
    find_aligned_furniture,
    find_middle_furniture,
    generate_relation,
    get_theta,
)

BAD_LABELS = ("ceiling", "wall", "door", "doorframe", "object")


def _default_json(obj):
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class SceneGraph:
    """Labelled nodes and edges in ``networkx.DiGraph``'s order: nodes in the
    order first added, each node's successors in the order their edges were
    first added; adding a node or an edge again keeps its place and replaces
    its label, and an edge adds its missing ends unlabelled. ``nodes()`` and
    ``edges()`` list what ``DiGraph.nodes(data="label")`` and
    ``DiGraph.edges(data="label")`` list."""

    def __init__(self):
        self._label = {}
        self._succ = {}

    def add_node(self, node, label=None):
        self._succ.setdefault(node, {})
        self._label[node] = label

    def add_edge(self, src, tgt, label=None):
        for n in (src, tgt):
            if n not in self._succ:
                self.add_node(n)
        self._succ[src][tgt] = label

    def successors(self, node):
        return list(self._succ[node])

    def __iter__(self):
        return iter(self._succ)

    def nodes(self):
        return list(self._label.items())

    def edges(self):
        return [(u, v, label) for u, succ in self._succ.items()
                for v, label in succ.items()]


def init_camera_view():
    """(reference :41-51): fixed camera looking along -y."""
    camera_view = np.array([0, -1, 0], np.float64)
    camera_pos = np.array([0, 0, 0], np.float64)
    camera_view = camera_view / np.linalg.norm(camera_view)
    angle = get_theta(camera_view, [0, 1, 0])
    if camera_view[0] < 0:
        angle = -angle
    return camera_view, camera_pos, angle


def load_scene_objects(scan_data_root, scan_id, device="cuda"):
    """Per-object boxes from a processed scan (reference :71-110): each
    instance's min and max over its points by one segment reduction on
    ``device`` (exact, whatever the order of the reduction), in the points'
    own dtype."""
    device = resolve_device(device)
    root = Path(scan_data_root)
    inst_to_label = torch.load(
        root / "instance_id_to_label" / f"{scan_id}.pth", weights_only=False
    )
    pcd = torch.load(
        root / "pcd_with_global_alignment" / f"{scan_id}.pth", weights_only=False
    )
    points = torch.as_tensor(np.asarray(pcd[0])).to(device)
    instance = torch.as_tensor(np.asarray(pcd[-1])).to(device)
    ids, inverse = torch.unique(instance, sorted=True, return_inverse=True)
    index = inverse[:, None].expand(-1, points.shape[1])
    box = torch.empty((ids.shape[0], points.shape[1]), dtype=points.dtype,
                      device=device)
    mins = box.scatter_reduce(0, index, points, "amin", include_self=False)
    maxs = box.scatter_reduce(0, index, points, "amax", include_self=False)
    point_max, point_min = points.max(0).values, points.min(0).values
    objects = []
    for i, mn, mx in zip(ids.cpu().numpy(), mins.cpu().numpy(),
                         maxs.cpu().numpy()):
        if i < 0 or int(i) not in inst_to_label:
            continue
        objects.append({
            "id": int(i),
            "label": inst_to_label[int(i)],
            "position": ((mn + mx) / 2).tolist(),
            "size": (mx - mn).tolist(),
        })
    return {
        "scan": scan_id,
        "point_max": point_max.cpu().numpy().tolist(),
        "point_min": point_min.cpu().numpy().tolist(),
        "objects": objects,
        "inst_to_label": {int(k): v for k, v in inst_to_label.items()},
    }


def build_scene_graph(scene, camera_angle=None, dataset="scannet", rng=None):
    """Build one scene's graph. Returns (graph, objects_rels, multi_rels,
    nodes) — relation triples are [src_id, tgt_id, phrase], their phrases
    drawn from ``rng`` (a ``random.Random``; a fresh unseeded one when
    None)."""
    if rng is None:
        rng = random.Random()
    if camera_angle is None:
        _, _, camera_angle = init_camera_view()

    x_max, y_max, z_max = scene["point_max"]
    x_min, y_min, z_min = scene["point_min"]
    scene_center = np.array([(x_max + x_min) / 2, (y_max + y_min) / 2,
                             (z_max + z_min) / 2])
    if z_max == z_min:
        z_max = z_min + 5
    scene_high = z_max - z_min

    G = SceneGraph()
    nodes = {}
    floor_idx = -100
    obj_z_min = 1000.0
    label_counts = {}
    for name in scene["inst_to_label"].values():
        label_counts[name] = label_counts.get(name, 0) + 1

    for obj in scene["objects"]:
        if np.asarray(obj["size"]).sum() == 0:
            continue
        if any(b in obj["label"] for b in BAD_LABELS):
            continue
        if obj["label"] == "floor":
            floor_idx = int(obj["id"])
        node = ObjNode(
            id=int(obj["id"]),
            position=np.asarray(obj["position"]) - scene_center,
            label=obj["label"],
            size=obj["size"],
            children=obj.get("children"),
            room_id=obj.get("room_id"),
            dataset=dataset,
        )
        obj_z_min = min(obj_z_min, obj["position"][2] - obj["size"][2] / 2)
        nodes[node.id] = node
        G.add_node(node.id, label=node.label)

    G.add_node(-1, label="CAMERA")
    G.add_node(-2, label="wall")

    # synthetic/expanded floor node (reference :204-236)
    fx, fy, fz = scene_center[0], scene_center[1], obj_z_min
    if floor_idx == -100:
        floor_idx = -3
        G.add_node(-3, label="floor")
        nodes[-3] = ObjNode(
            id=-3, position=np.array([fx, fy, fz]) - scene_center, label="floor",
            size=[(x_max - x_min) * 1.2, (y_max - y_min) * 1.2,
                  (z_max - z_min) * 0.1], dataset=dataset,
        )
    else:
        old = nodes[floor_idx]
        fsize = [max((x_max - x_min) * 1.2, old.size[0]),
                 max((y_max - y_min) * 1.2, old.size[0]),
                 old.size[2] if old.size[2] > 0 else (z_max - z_min) * 0.1]
        nodes[floor_idx] = ObjNode(
            id=floor_idx, position=np.array([fx, fy, fz]) - scene_center,
            label="floor", size=fsize, dataset=dataset,
        )

    support_rels, embedded_rels, supported = cal_support_relations(nodes, rng)
    for src, tgt, _ in support_rels:
        G.add_edge(src, tgt, label="support")

    hanging_rels = cal_hanging_relations(nodes, supported, scene_high, rng)

    proximity_rels = []
    for node in list(G):
        # a depth-1 breadth-first search from node: its successors
        succ = [s for s in G.successors(node) if s != node and s in nodes]
        if len(succ) > 1:
            proximity_rels += cal_proximity_relations(
                succ, camera_angle, nodes, scene_high, rng
            )

    # oppo-support + added-hanging rewrites (reference :279-296)
    objects_rels = support_rels + embedded_rels + hanging_rels
    oppo = []
    for idx, (src, tgt, rel) in enumerate(objects_rels):
        if rel in D.support_express:
            oppo.append(generate_relation(src, tgt, "oppo_support", rng))
        if src == -2 or tgt == -2 or src not in nodes or tgt not in nodes:
            continue
        sl, tl = nodes[src].label, nodes[tgt].label
        if D.added_hanging.get(sl) == tl or D.added_hanging.get(tl) == sl:
            objects_rels[idx][2] = "hanging"
    objects_rels += oppo + proximity_rels

    furniture = list(nodes.keys())
    multi_rels = {
        "aligned": find_aligned_furniture(furniture, nodes, 0.065),
        "middle": find_middle_furniture(furniture, nodes),
    }
    return G, objects_rels, multi_rels, nodes


def generate_ssg(scan_data_root, out_dir, dataset="scannet", scan_ids=None,
                 device="cuda", seed=None):
    """Process all scans -> {out_dir}/relationships.json + objects.json.
    The boxes are reduced on ``device``; every scene's phrases come from one
    ``random.Random(seed)``, which draws what the JAX package draws after
    ``random.seed(seed)``."""
    device = resolve_device(device)
    rng = random.Random(seed)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = Path(scan_data_root)
    if scan_ids is None:
        scan_ids = sorted(
            p.stem for p in (root / "pcd_with_global_alignment").glob("*.pth")
        )
    relationships, objects = {}, {}
    for scan_id in scan_ids:
        scene = load_scene_objects(root, scan_id, device)
        if not scene["objects"]:
            continue
        _, rels, multi, nodes = build_scene_graph(scene, dataset=dataset,
                                                  rng=rng)
        relationships[scan_id] = {"relationships": rels, "multi": multi}
        objects[scan_id] = scene["objects"]
    with (out_dir / "relationships.json").open("w") as f:
        json.dump(relationships, f, default=_default_json)
    with (out_dir / "objects.json").open("w") as f:
        json.dump(objects, f, default=_default_json)
    return relationships, objects


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser("scene-graph generation")
    parser.add_argument("--scan_data", required=True,
                        help="dir containing pcd_with_global_alignment/")
    parser.add_argument("--out", required=True)
    parser.add_argument("--dataset", default="scannet")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args()
    generate_ssg(args.scan_data, args.out, args.dataset, device=args.device,
                 seed=args.seed)

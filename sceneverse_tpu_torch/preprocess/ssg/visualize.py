"""SSG relation visualizer, the port's own copy of
``sceneverse_tpu/preprocess/ssg/visualize.py`` (reference
preprocess/ssg/ssg_data/ssg_visualize.py:6-54, an open3d window loop; open3d
is not a dependency, so this renders the same content — scene points, the
relation's source/target boxes, and the relation phrase — to PNG files with
matplotlib, on the host).

Usage:
    python -m sceneverse_tpu_torch.preprocess.ssg.visualize \
        --scene-path <scan_data dir> --scan-id <id> \
        --relationships <relationships.json> --out out/ [--limit 8]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _draw_box(ax, node, color):
    x0, y0 = node.x_min, node.y_min
    w, h = node.x_max - node.x_min, node.y_max - node.y_min
    import matplotlib.patches as patches

    ax.add_patch(patches.Rectangle((x0, y0), w, h, fill=False,
                                   edgecolor=color, linewidth=2))
    ax.annotate(node.label, (node.position[0], node.position[1]),
                color=color, fontsize=8, ha="center")


def vis_dataset(nodes, relations, scene_path, scan_id, out_dir,
                limit: int | None = None):
    """Top-down renders, one PNG per relation (reference shows one open3d
    window per relation, :16-47). ``rel[1] == -2`` rows are single-object
    global relations, matching the reference's special case."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    pcd = torch.load(Path(scene_path) / "pcd_with_global_alignment" /
                     f"{scan_id}.pth", weights_only=False)
    points, colors = np.asarray(pcd[0]), np.asarray(pcd[1])
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sub = np.random.RandomState(0).choice(
        len(points), size=min(len(points), 20000), replace=False)

    written = []
    for i, rel in enumerate(relations):
        if limit is not None and len(written) >= limit:
            break
        if len(rel) != 3:
            continue
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(points[sub, 0], points[sub, 1], s=0.3,
                   c=np.clip(colors[sub] / 255.0, 0, 1))
        src = nodes.get(rel[0]) if rel[0] in nodes else None
        if rel[1] == -2 or rel[1] == "-2":  # single-object global relation
            if src is None:
                plt.close(fig)
                continue
            _draw_box(ax, src, "green")
            title = f"{src.label} {rel[2]}"
        else:
            tgt = nodes.get(rel[1])
            if src is None or tgt is None:
                plt.close(fig)
                continue
            _draw_box(ax, src, "green")
            _draw_box(ax, tgt, "red")
            title = f"{src.label} [{rel[2]}] {tgt.label}"
        ax.set_title(title)
        ax.set_aspect("equal")
        path = out_dir / f"{scan_id}_rel{i:03d}.png"
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None):
    from sceneverse_tpu_torch.preprocess.ssg.objnode import ObjNode

    p = argparse.ArgumentParser()
    p.add_argument("--scene-path", required=True)
    p.add_argument("--scan-id", required=True)
    p.add_argument("--relationships", required=True)
    p.add_argument("--objects", required=True,
                   help="objects.json with id/label/position/size per object")
    p.add_argument("--out", default="ssg_vis")
    p.add_argument("--limit", type=int, default=8)
    args = p.parse_args(argv)

    objs = json.loads(Path(args.objects).read_text())
    nodes = {o["id"]: ObjNode(o["id"], o["label"], o["position"], o["size"])
             for o in objs}
    rels = json.loads(Path(args.relationships).read_text())
    if isinstance(rels, dict):  # relationships.json keyed by scan
        rels = rels.get(args.scan_id, [])
    written = vis_dataset(nodes, rels, args.scene_path, args.scan_id,
                          args.out, limit=args.limit)
    print(f"wrote {len(written)} renders to {args.out}")


if __name__ == "__main__":
    main()

"""Scene / instance / referral visualizer over processed ``.pth`` scans
(reference visualize_data.py:23-118): the port's own copy of
``visualize_data.py``, on the host.

Usage:
    python visualize_data_torch.py --root <scan_data dir> --dataset <name>
        [--vis_refer] [--scan_id <id>] [--out <dir>]

Renders with open3d when importable (interactive), else matplotlib 3D
scatter written to PNG (headless).
"""

from __future__ import annotations

import argparse
import json
import os
import random
from pathlib import Path

import numpy as np


def load_scan(root, scan_id):
    import torch

    pcd = torch.load(
        Path(root) / "scan_data/pcd_with_global_alignment" / f"{scan_id}.pth",
        weights_only=False, map_location="cpu",
    )
    inst2label = torch.load(
        Path(root) / "scan_data/instance_id_to_label" / f"{scan_id}.pth",
        weights_only=False, map_location="cpu",
    )
    points, colors, instance = pcd[0], pcd[1], pcd[-1]
    return np.asarray(points), np.asarray(colors), np.asarray(instance), inst2label


def instance_colors(instance):
    """Deterministic per-instance colors from the ScanNet-200 palette
    (SCANNET_COLOR_MAP_200, reference data/datasets/constant.py:408-610);
    unassigned points (-1) render gray."""
    from sceneverse_tpu_torch.data.datasets.constant import SCANNET_COLOR_MAP_200

    table = np.asarray(
        [v for k, v in sorted(SCANNET_COLOR_MAP_200.items()) if k > 0],
        np.float64,
    )
    ids = np.unique(instance)
    palette = {i: table[i % len(table)] for i in ids}
    palette[-1] = np.array([128.0, 128.0, 128.0])
    return np.stack([palette[i] for i in instance])


def render(points, colors, title, out_path=None):
    # always export the colored geometry itself: the file-output equivalent
    # of the reference's interactive open3d viewer (visualize_data.py:23-118),
    # inspectable in any external PLY viewer
    if out_path is not None:
        from sceneverse_tpu_torch.preprocess.mesh_io import save_ply

        ply_path = os.path.splitext(out_path)[0] + ".ply"
        save_ply(ply_path, points, colors)
        print(f"wrote {ply_path}")
    try:
        import open3d as o3d

        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(points)
        pc.colors = o3d.utility.Vector3dVector(np.clip(colors / 255.0, 0, 1))
        o3d.visualization.draw_geometries([pc], window_name=title)
        return
    except ImportError:
        pass
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sub = np.random.RandomState(0).choice(
        len(points), size=min(len(points), 60_000), replace=False
    )
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[sub, 0], points[sub, 1], points[sub, 2],
               c=np.clip(colors[sub] / 255.0, 0, 1), s=0.5)
    ax.set_title(title)
    out_path = out_path or f"{title.replace('/', '_')}.png"
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"wrote {out_path}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--dataset", default="scannet")
    parser.add_argument("--scan_id", default=None)
    parser.add_argument("--vis_refer", action="store_true")
    parser.add_argument("--out", default=".")
    args = parser.parse_args()

    scan_dir = Path(args.root) / "scan_data/pcd_with_global_alignment"
    scan_ids = sorted(p.stem for p in scan_dir.glob("*.pth"))
    if not scan_ids:
        raise SystemExit(f"no scans under {scan_dir}")
    scan_id = args.scan_id or scan_ids[0]
    points, colors, instance, inst2label = load_scan(args.root, scan_id)

    os.makedirs(args.out, exist_ok=True)
    render(points, colors, f"{args.dataset}/{scan_id}/rgb",
           os.path.join(args.out, f"{scan_id}_rgb.png"))
    render(points, instance_colors(instance), f"{args.dataset}/{scan_id}/instances",
           os.path.join(args.out, f"{scan_id}_inst.png"))

    if args.vis_refer:
        anno_path = Path(args.root) / "annotations/refer/scanrefer.jsonl"
        if anno_path.exists():
            annos = [json.loads(l) for l in open(anno_path) if l.strip()]
            annos = [a for a in annos if a["scan_id"] == scan_id]
            if annos:
                item = random.choice(annos)
                tgt = int(item["target_id"])
                mask = instance == tgt
                hi = colors.copy()
                hi[mask] = [255.0, 0.0, 0.0]
                print(f"utterance: {item['utterance']}")
                render(points, hi, f"{args.dataset}/{scan_id}/refer_{tgt}",
                       os.path.join(args.out, f"{scan_id}_refer.png"))


if __name__ == "__main__":
    main()

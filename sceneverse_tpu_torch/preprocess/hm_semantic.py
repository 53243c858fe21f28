"""HM3D semantic-annotation mapper, the port's own copy of
``sceneverse_tpu/preprocess/hm_semantic.py`` (reference
preprocess/sceneverse2hmsemantic.py:1-61, marked deprecated there), on the
host. Parses the HM3D ``<uid>.semantic.txt`` color table and writes ``tgt_id2obj_id.json`` per scene mapping dense target ids to
(object id, object name).

Usage:
    python -m sceneverse_tpu_torch.preprocess.hm_semantic --data_root <hm3d-train-annots>
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def load_semantic_anno(semantic_txt):
    """Parse the HM3D semantic color table: ``id,RRGGBB,"name",...`` lines
    (header skipped). Returns (colors (N,3) uint8, names, color→name,
    color→id)."""
    colors, names = [], []
    color_to_name, color_to_id = {}, {}
    with open(semantic_txt, encoding="utf-8") as f:
        for line in f.readlines()[1:]:
            fields = line.split(",")
            obj_id = int(fields[0])
            hexstr = fields[1].zfill(6)
            rgb = tuple(int(hexstr[i : i + 2], 16) for i in (0, 2, 4))
            name = fields[2].strip().strip('"')
            names.append(name)
            colors.append(rgb)
            color_to_name[rgb] = name
            color_to_id[rgb] = obj_id
    return np.asarray(colors, dtype=np.uint8), names, color_to_name, color_to_id


def scene_proc(scene_dir):
    """Write ``tgt_id2obj_id.json`` for one ``hm3d-…-annots/<name>-<uid>``
    scene directory; target ids are 1-based over the distinct annotation
    colors (reference :34-51)."""
    scene_name = os.path.basename(os.path.normpath(scene_dir))
    scene_uid = scene_name.split("-")[1]
    sem_path = os.path.join(scene_dir, f"{scene_uid}.semantic.txt")
    colors, _, color_to_name, color_to_id = load_semantic_anno(sem_path)
    tgt_id2obj_id = {}
    for i, rgb in enumerate(set(map(tuple, colors.tolist()))):
        tgt_id2obj_id[i + 1] = (color_to_id[rgb], color_to_name[rgb])
    out_path = os.path.join(scene_dir, "tgt_id2obj_id.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(tgt_id2obj_id, f, indent=4)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", default="./hm3d-train-annots")
    args = parser.parse_args(argv)
    for scene_dir in sorted(glob.glob(os.path.join(args.data_root, "*"))):
        scene_proc(scene_dir)


if __name__ == "__main__":
    main()

"""Synthetic on-disk SceneVerse data tree for tests/debug: the port's own
copy of ``sceneverse_tpu/data/fixture.py`` (the same arguments write the
same files).

Writes the exact directory layout ScanBase consumes (SURVEY.md §2.6 /
reference DATA.md): per-scan ``.pth`` point clouds + instance maps,
annotation jsons/jsonls, split files and the ScanNet label tsv — so tests
exercise the real loading/matching/cropping code paths, not mocks.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

CATEGORIES = ["wall", "floor", "ceiling", "chair", "table", "sofa", "bed",
              "lamp", "door", "window"]


def write_synthetic_tree(root, n_scans=3, n_objects=6, pts_per_obj=80,
                         seed=0, prefix="scene", annos_per_obj=1):
    """Create a SceneVerse-format data tree under ``root``. Returns root.

    ``annos_per_obj`` > 1 writes multiple referring annotations per object
    (real ScanRefer averages ~36 captions/scene) — used by the input-pipeline
    benchmark to get a GPS-scale item count from a few scans.
    """
    import torch

    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / "scan_data/pcd_with_global_alignment").mkdir(parents=True, exist_ok=True)
    (root / "scan_data/instance_id_to_label").mkdir(parents=True, exist_ok=True)
    (root / "annotations/meta_data").mkdir(parents=True, exist_ok=True)
    (root / "annotations/splits").mkdir(parents=True, exist_ok=True)
    (root / "annotations/refer").mkdir(parents=True, exist_ok=True)

    # meta: raw category list + labels tsv
    with open(root / "annotations/meta_data/scannetv2_raw_categories.json", "w") as f:
        json.dump(CATEGORIES, f)
    with open(root / "annotations/meta_data/scannetv2-labels.combined.tsv", "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\t"
                "nyu40class\tnyuClass\n")
        nyu40 = ["wall", "floor", "ceiling", "chair", "table", "sofa", "bed",
                 "lamp", "door", "window"]
        for i, name in enumerate(CATEGORIES):
            f.write(f"{i+1}\t{name}\t{name}\t10\t{i+1}\t0\t{nyu40[i]}\t{name}\n")

    scan_ids = [f"{prefix}{i:04d}_00" for i in range(n_scans)]
    annos = []
    item = 0
    for scan_id in scan_ids:
        points, instance = [], []
        inst_to_label = {}
        for obj_i in range(n_objects):
            cat = CATEGORIES[obj_i % len(CATEGORIES)]
            center = rng.randn(3) * 3
            pts = center + rng.randn(pts_per_obj, 3) * 0.3
            points.append(pts)
            instance.append(np.full(pts_per_obj, obj_i))
            inst_to_label[obj_i] = cat
        points = np.concatenate(points).astype(np.float32)
        colors = rng.randint(0, 255, points.shape).astype(np.float32)
        instance = np.concatenate(instance).astype(np.int64)
        torch.save(
            (points, colors, None, instance),
            root / f"scan_data/pcd_with_global_alignment/{scan_id}.pth",
        )
        torch.save(inst_to_label,
                   root / f"scan_data/instance_id_to_label/{scan_id}.pth")
        # referring annotations for every non-bg object
        for obj_i in range(n_objects):
            cat = inst_to_label[obj_i]
            if cat in ("wall", "floor", "ceiling"):
                continue
            for k in range(annos_per_obj):
                utt = f"the {cat} near the wall on the left" if k == 0 else \
                    f"find the {cat} number {k} beside the big window"
                annos.append({
                    "item_id": f"item{item}",
                    "scan_id": scan_id,
                    "target_id": obj_i,
                    "instance_type": cat,
                    "utterance": utt,
                    "tokens": utt.split(),
                })
                item += 1

    with open(root / "annotations/anno.json", "w") as f:
        json.dump(annos, f)
    with open(root / "annotations/refer/scanrefer.jsonl", "w") as f:
        for a in annos:
            f.write(json.dumps(a) + "\n")

    # Every other annotation layout base.py's source switch can read
    # (reference data/datasets/base.py:144-213), so ONE tree can serve all
    # family base_dirs and the full all_pretrain source mix:
    #   refer/{sr3d,nr3d,sr3d+}.jsonl      referit3d (len(tokens)<=24 filter)
    #   refer/ssg_ref_<sub>.json           sgrefer
    #   refer/ssg_obj_caption_<sub>.json   sgcaption
    #   ssg_ref_<src>.json                 non-ScanNet family bare sources
    def _retag(tag):
        return [dict(a, item_id=f"{tag}_{a['item_id']}") for a in annos]

    for sub in ("sr3d", "nr3d", "sr3d+"):
        with open(root / f"annotations/refer/{sub}.jsonl", "w") as f:
            for a in _retag(sub):
                f.write(json.dumps(a) + "\n")
    for sub in ("rel2_gpt", "rel2_template", "relm_gpt", "relm_template",
                "star_gpt", "star_template"):
        with open(root / f"annotations/refer/ssg_ref_{sub}.json", "w") as f:
            json.dump(_retag(f"sgref_{sub}"), f)
        with open(root / f"annotations/ssg_ref_{sub}.json", "w") as f:
            json.dump(_retag(f"ssg_{sub}"), f)
    for sub in ("gpt", "template"):
        with open(root / f"annotations/refer/ssg_obj_caption_{sub}.json",
                  "w") as f:
            json.dump(_retag(f"sgcap_{sub}"), f)
    with open(root / "annotations/scene_cap.json", "w") as f:
        json.dump(
            {sid: {"captions": [f"a synthetic room {sid}"]} for sid in scan_ids}, f
        )
    for split in ("train", "val", "test"):
        text = "\n".join(scan_ids) + "\n"
        (root / f"annotations/splits/scannetv2_{split}.txt").write_text(text)
        (root / f"annotations/splits/{split}_split.txt").write_text(text)

    # ---- QA annotations (ScanQA + SQA3D layouts) ----
    (root / "annotations/qa").mkdir(parents=True, exist_ok=True)
    (root / "annotations/sqa_task/balanced").mkdir(parents=True, exist_ok=True)
    answers = ["chair", "table", "two", "red", "yes"]
    qa_items = []
    qid = 0
    for scan_id in scan_ids:
        for obj_i in range(3, min(n_objects, 6)):
            qa_items.append({
                "scene_id": scan_id,
                "question_id": f"q{qid}",
                "question": f"What is next to the {CATEGORIES[obj_i % len(CATEGORIES)]}?",
                "answers": [answers[qid % len(answers)]],
                "object_ids": [obj_i],
                "object_names": [CATEGORIES[obj_i % len(CATEGORIES)]],
            })
            qid += 1
    for split in ("train", "val", "test_w_obj"):
        with open(root / f"annotations/qa/ScanQA_v1.0_{split}.json", "w") as f:
            json.dump(qa_items, f)

    with open(root / "annotations/sqa_task/answer_dict.json", "w") as f:
        json.dump([{a: i for i, a in enumerate(sorted(set(answers) | {"u"}))},
                   {}], f)
    sqa_annos, sqa_questions = [], []
    for i, item in enumerate(qa_items):
        sqa_annos.append({
            "scene_id": item["scene_id"],
            "question_id": 1000 + i,
            "answers": [{"answer": item["answers"][0],
                         "answer_confidence": "yes", "answer_id": 1}],
            "position": {"x": 0.0, "y": 0.0, "z": 0.0},
            "rotation": {"_x": 0, "_y": 0, "_z": 0, "_w": 1},
        })
        sqa_questions.append({
            "scene_id": item["scene_id"],
            "question_id": 1000 + i,
            "situation": "I am standing by the table.",
            "alternative_situation": ["I just sat on the sofa."],
            "question": item["question"],
        })
    for split in ("train", "test"):
        with open(root / "annotations/sqa_task/balanced/"
                  f"v1_balanced_sqa_annotations_{split}_scannetv2.json", "w") as f:
            json.dump({"annotations": sqa_annos}, f)
        with open(root / "annotations/sqa_task/balanced/"
                  f"v1_balanced_questions_{split}_scannetv2.json", "w") as f:
            json.dump({"questions": sqa_questions}, f)
    return root

"""Synthetic raw scans in the layouts the four processors read (3RScan,
MultiScan, ARKitScenes, Structured3D), written from a ``RandomState`` for
tests and the card's smoke run. Objects are Gaussian clusters of vertices;
each writer also writes what its processor has to get right at the edges:
vertices far from every label vertex (3RScan), faces of two objects sharing
vertices (MultiScan), overlapping boxes (ARKitScenes), a skipped wall class
(Structured3D), and labels outside each dataset's map."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sceneverse_tpu_torch.preprocess import label_convert as LC

UNMAPPED_LABEL = "not_a_mapped_label"


def write_binary_ply(path, vertices, colors=None, faces=None, face_ids=None):
    """binary_little_endian PLY: x/y/z f32, optional red/green/blue u8, and
    optional triangles with an int ``objectId`` per face."""
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rows = np.empty(n, np.dtype(fields))
    for i, axis in enumerate("xyz"):
        rows[axis] = vertices[:, i]
    if colors is not None:
        for i, c in enumerate(("red", "green", "blue")):
            rows[c] = colors[:, i]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
        ffields = [("n", "u1"), ("v", "<i4", (3,))]
        if face_ids is not None:
            header.append("property int objectId")
            ffields.append(("objectId", "<i4"))
        frows = np.empty(len(faces), np.dtype(ffields))
        frows["n"] = 3
        frows["v"] = faces
        if face_ids is not None:
            frows["objectId"] = face_ids
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rows.tobytes())
        if faces is not None:
            f.write(frows.tobytes())


def _clusters(rng, n, n_objects, spread=4.0, sigma=0.3):
    """(n, 3) f64 points in ``n_objects`` Gaussian clusters and each point's
    cluster."""
    centers = rng.uniform(-spread, spread, (n_objects, 3))
    centers[:, 2] = rng.uniform(0.5, 2.0, n_objects)
    owner = np.sort(rng.randint(0, n_objects, n))
    return centers[owner] + rng.randn(n, 3) * sigma, owner, centers


def _z_rotation(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _labels(rng, names, n):
    names = sorted(names)
    return [names[i] for i in rng.randint(0, len(names), n)]


def write_rscan_scan(root, scan_id, rng, n_vertices, n_objects, texture=None):
    """``<root>/<scan_id>/``: mesh.refined.v2.obj (with uvs and faces; with
    ``texture=(h, w)`` also a material and an h x w PNG),
    labels.instances.annotated.v2.ply (binary), the segments and semseg
    JSONs. One vertex in 20 lies far from every label vertex; the label
    mesh is the rest moved by up to 0.02; the last object's group carries a
    label outside the 3RScan map."""
    scan = Path(root) / scan_id
    scan.mkdir(parents=True, exist_ok=True)
    n_far = max(1, n_vertices // 20)
    pts, owner, centers = _clusters(rng, n_vertices - n_far, n_objects)
    far = rng.uniform(-1, 1, (n_far, 3)) + [20.0, 20.0, 0.0]
    verts = np.concatenate([pts, far])
    n_uv = max(1, n_vertices // 2)
    uvs = rng.uniform(0, 1, (n_uv, 2))
    faces = rng.randint(0, n_vertices, (n_vertices, 3))
    face_uvs = rng.randint(0, n_uv, (n_vertices, 3))
    lines = []
    if texture is not None:
        from PIL import Image

        lines.append("mtllib mesh.refined.mtl")
        (scan / "mesh.refined.mtl").write_text(
            "newmtl textured\nmap_Kd mesh.refined_0.png\n")
        Image.fromarray(rng.randint(0, 256, (*texture, 3)).astype(np.uint8)
                        ).save(scan / "mesh.refined_0.png")
    lines += [f"v {x:.17g} {y:.17g} {z:.17g}" for x, y, z in verts]
    lines += [f"vt {u:.17g} {v:.17g}" for u, v in uvs]
    lines += [" ".join(["f"] + [f"{a + 1}/{t + 1}" for a, t in zip(f, ft)])
              for f, ft in zip(faces, face_uvs)]
    (scan / "mesh.refined.v2.obj").write_text("\n".join(lines) + "\n")

    label_verts = (pts + rng.uniform(-0.01, 0.01, pts.shape)).astype(np.float32)
    write_binary_ply(scan / "labels.instances.annotated.v2.ply", label_verts,
                     rng.randint(0, 256, label_verts.shape).astype(np.uint8))
    segs_per_obj = 3
    seg_indices = owner * segs_per_obj + rng.randint(0, segs_per_obj, len(owner))
    (scan / "mesh.refined.0.010000.segs.v2.json").write_text(
        json.dumps({"segIndices": seg_indices.tolist()}))
    theta = rng.uniform(-0.5, 0.5)
    rot = _z_rotation(theta)
    names = _labels(rng, LC.RSCAN_SCANNET, n_objects)
    names[-1] = UNMAPPED_LABEL
    groups = [{
        "id": o + 1, "objectId": o + 1, "label": names[o],
        "segments": list(range(o * segs_per_obj, (o + 1) * segs_per_obj)),
        "obb": {"normalizedAxes": rot.flatten().tolist(),
                "centroid": centers[o].tolist(),
                "axesLengths": rng.uniform(0.5, 1.5, 3).tolist()},
    } for o in range(n_objects)]
    (scan / "semseg.v2.json").write_text(json.dumps({"segGroups": groups}))


def write_multiscan_scan(root, scan_id, rng, n_vertices, n_faces, n_objects):
    """``<root>/<scan_id>/``: ``<scan_id>.ply`` (binary, per-face
    ``objectId``) and ``<scan_id>.annotations.json``. Faces join vertices a
    few indices apart, so faces of neighbouring objects share vertices; one
    face in 10 carries an id that no annotation names, and the last object
    a label outside the MultiScan map."""
    scan = Path(root) / scan_id
    scan.mkdir(parents=True, exist_ok=True)
    verts, owner, _ = _clusters(rng, n_vertices, n_objects)
    a = rng.randint(0, n_vertices, n_faces)
    faces = np.clip(a[:, None] + rng.randint(-4, 5, (n_faces, 3)), 0,
                    n_vertices - 1)
    object_ids = owner[a] + 1
    object_ids[rng.uniform(size=n_faces) < 0.1] = n_objects + 7
    write_binary_ply(scan / f"{scan_id}.ply", verts.astype(np.float32),
                     rng.randint(0, 256, verts.shape).astype(np.uint8),
                     faces, object_ids)
    names = _labels(rng, LC.MULTISCAN_SCANNET, n_objects)
    names[-1] = UNMAPPED_LABEL
    objects = [{"objectId": o + 1, "label": f"{names[o]}.{o}"}
               for o in range(n_objects)]
    (scan / f"{scan_id}.annotations.json").write_text(
        json.dumps({"objects": objects}))


def write_arkit_scan(root, split, scan_id, rng, n_vertices, n_boxes):
    """``<root>/<split>/<scan_id>/``: ``<scan_id>_3dod_mesh.ply`` (binary)
    and ``<scan_id>_3dod_annotation.json`` with oriented boxes, each twice
    its cluster's spread wide, so that neighbouring boxes overlap; the last
    box has a label outside the ARKitScenes map."""
    scan = Path(root) / split / scan_id
    scan.mkdir(parents=True, exist_ok=True)
    verts, _, centers = _clusters(rng, n_vertices, n_boxes, spread=1.5)
    write_binary_ply(scan / f"{scan_id}_3dod_mesh.ply", verts.astype(np.float32),
                     rng.randint(0, 256, verts.shape).astype(np.uint8))
    names = _labels(rng, LC.ARKITSCENE_SCANNET, n_boxes)
    names[-1] = UNMAPPED_LABEL
    theta = rng.uniform(-0.5, 0.5)
    data = [{"label": names[k], "segments": {"obbAligned": {
        "normalizedAxes": _z_rotation(theta + rng.uniform(-0.02, 0.02))
        .flatten().tolist(),
        "centroid": centers[k].tolist(),
        "axesLengths": rng.uniform(0.6, 1.4, 3).tolist()}}}
        for k in range(n_boxes)]
    (scan / f"{scan_id}_3dod_annotation.json").write_text(
        json.dumps({"data": data}))


def write_s3d_scan(root, split, scan_id, rng, n_points, n_boxes):
    """``<root>/<split>/<scan_id>_point_cloud.npy`` ((N, 6): xyz, colours in
    [-1, 1]) and ``<scan_id>_annotation.npy`` (axis-aligned boxes and their
    classes; the first box is class 38, which the processor skips)."""
    split_dir = Path(root) / split
    split_dir.mkdir(parents=True, exist_ok=True)
    pts, _, centers = _clusters(rng, n_points, n_boxes, spread=2.0)
    data = np.concatenate([pts, rng.uniform(-1, 1, pts.shape)], axis=1)
    np.save(split_dir / f"{scan_id}_point_cloud.npy", data)
    boxes = np.concatenate([centers, rng.uniform(0.6, 1.6, (n_boxes, 3))], 1)
    classes = [int(c) for c in rng.choice(
        [k for k in LC.S3D_SCANNET if k not in (38, 39, 40)], n_boxes)]
    classes[0] = 38
    np.save(split_dir / f"{scan_id}_annotation.npy",
            {"gt_boxes_upright_depth": boxes, "class": classes})

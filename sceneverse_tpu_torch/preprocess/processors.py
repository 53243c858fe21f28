"""Per-dataset offline scene processors (reference preprocess/{rscan,
multiscan,arkitscenes,structured3d}.py), the port's own copy of
``sceneverse_tpu/preprocess/processors.py``: raw release -> per-scan
``(vertices, colors, instance)`` .pth + ``instance_id_to_label`` .pth in the
layout the data layer consumes.

Shared pipeline (reference rscan.py:42-111):
  per-vertex instance ids (nearest label vertex / face ids / box containment)
  -> axis-alignment by bbox-rotation histogram (align_utils, host)
  -> colors to [0, 255] -> floor-centered translation -> 240K point cap
  -> save .pth outputs + train/val split files.

What scales with the vertex count runs as float64 torch ops on the
processor's device (``cfg.device``, default ``cuda``); file parsing, the box
work and the cap's index draw stay on the host. The saved arrays are numpy
arrays, so either package's data layer reads them on a machine without a
card.
"""

from __future__ import annotations

import copy
import json
import re
from glob import glob
from pathlib import Path

import numpy as np
import torch

from sceneverse_tpu_torch.preprocess import label_convert as LC
from sceneverse_tpu_torch.preprocess.align_utils import (
    calc_align_matrix,
    compute_box_3d,
    rotate_z_axis_by_degrees,
)
from sceneverse_tpu_torch.preprocess.build import PROCESSOR_REGISTRY, ProcessorBase
from sceneverse_tpu_torch.preprocess.mesh_io import load_ply

PTS_LIMIT = 240_000  # offline scene point cap (reference preprocess/README.md)
NN_MAX_DIST = 0.1  # a vertex takes its nearest label vertex's instance within this
# float64 elements in one block of query-to-label squared distances (1 GiB);
# the search holds two such blocks at a time
NN_BLOCK_ELEMS = 1 << 27
F64 = torch.float64


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def nearest_vertex(query, ref, block_elems=NN_BLOCK_ELEMS):
    """Distance to and index of the nearest row of ``ref`` (R, 3) for each
    row of ``query`` (Q, 3), both float64 on one device, by brute force over
    blocks of query rows. The squared distance is summed from explicit
    differences, x then y then z, as a k-d tree's query sums it: the
    |a|^2 + |b|^2 - 2ab expansion cancels, which can move a distance across
    ``NN_MAX_DIST`` or change the nearest index. At an exact tie the lowest
    index wins."""
    rows = max(1, block_elems // max(1, ref.shape[0]))
    rx, ry, rz = ref.T.contiguous()
    dist = torch.empty(query.shape[0], dtype=query.dtype, device=query.device)
    index = torch.empty(query.shape[0], dtype=torch.long, device=query.device)
    for s in range(0, query.shape[0], rows):
        q = query[s:s + rows]
        d2 = (q[:, 0:1] - rx).square_()
        t = (q[:, 1:2] - ry).square_()
        d2 += t
        torch.sub(q[:, 2:3], rz, out=t).square_()
        d2 += t
        best, arg = d2.min(dim=1)
        dist[s:s + rows] = best.sqrt_()
        index[s:s + rows] = arg
        del d2, t
    return dist, index


def face_instances(n_vertices, faces, face_objs, labelled, device):
    """Per-vertex object id from per-face ids: the last face, in file order,
    whose id is in ``labelled`` and that touches a vertex gives it that id;
    -1 where no such face does (the reference's loop over faces overwrites).
    Computed as each vertex's highest labelled face index (a scatter-amax,
    which does not depend on the order of the writes, unlike ``index_put_``
    with repeated indices on CUDA), then one gather."""
    instance = torch.full((n_vertices,), -1, dtype=torch.long, device=device)
    if faces is None or face_objs is None:
        return instance
    faces = torch.from_numpy(np.asarray(faces, np.int64)).to(device)
    objs = torch.from_numpy(np.asarray(face_objs, np.int64)).to(device)
    keys = torch.tensor(list(labelled), dtype=torch.long, device=device)
    hit = torch.isin(objs, keys).nonzero().squeeze(1)
    if hit.numel() == 0:
        return instance
    last = torch.full_like(instance, -1)
    last.scatter_reduce_(0, faces[hit].reshape(-1),
                         hit.repeat_interleave(faces.shape[1]), "amax")
    return torch.where(last >= 0, objs[last.clamp(min=0)], instance)


def _read_obj(obj_path):
    """Host half of the OBJ reader (replaces trimesh's uv_to_color path,
    reference rscan.py:103-104): vertices (V, 3) f64, and where the material
    names a texture that exists and the file has uvs, ``(uvs (T, 2) f64,
    vertex ids, uv ids, image (H, W, 3) uint8)``, each vertex with the uv of
    the last face corner that names it, else None."""
    verts, uvs, vert_uv = [], [], {}
    mtl_image = None
    obj_path = Path(obj_path)
    for line in open(obj_path, encoding="utf-8", errors="replace"):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vt":
            uvs.append([float(parts[1]), float(parts[2])])
        elif parts[0] == "f":
            for token in parts[1:4]:
                ids = token.split("/")
                vi = int(ids[0]) - 1
                if len(ids) > 1 and ids[1]:
                    vert_uv[vi] = int(ids[1]) - 1
        elif parts[0] == "mtllib":
            mtl = obj_path.parent / parts[1]
            if mtl.exists():
                for ml in open(mtl, encoding="utf-8", errors="replace"):
                    mp = ml.split()
                    if mp and mp[0] in ("map_Kd",):
                        mtl_image = obj_path.parent / mp[1]
    vertices = np.asarray(verts, np.float64)
    if mtl_image is None or not mtl_image.exists() or not uvs:
        return vertices, None
    from PIL import Image

    image = np.array(Image.open(mtl_image).convert("RGB"))
    n = len(vert_uv)
    return vertices, (np.asarray(uvs, np.float64),
                      np.fromiter(vert_uv.keys(), np.int64, n),
                      np.fromiter(vert_uv.values(), np.int64, n), image)


def texture_colors(n_vertices, texture, device):
    """Per-vertex colors in [0, 1]: 0.5 grey, or each textured vertex's
    texel at its uv (nearest texel, truncated like the reference's
    ``int()``), one gather on ``device``."""
    colors = torch.full((n_vertices, 3), 0.5, dtype=F64, device=device)
    if texture is None:
        return colors
    uvs, vert_ids, uv_ids, image = texture
    img = torch.from_numpy(image).to(device, F64) / 255.0
    h, w = img.shape[:2]
    uv = torch.from_numpy(uvs).to(device)[torch.from_numpy(uv_ids).to(device)]
    px = (uv[:, 0] * (w - 1)).trunc_().long().clamp_(max=w - 1)
    py = ((1 - uv[:, 1]) * (h - 1)).trunc_().long().clamp_(max=h - 1)
    colors[torch.from_numpy(vert_ids).to(device)] = img[py, px]
    return colors


class _SceneProcessor(ProcessorBase):
    """Common machinery: split recording, parallel driving, final save."""

    def record_splits(self, scan_ids, ratio=0.8):
        split_dir = self.save_root / "split"
        split_dir.mkdir(parents=True, exist_ok=True)
        if (split_dir / "train_split.txt").exists():
            return
        scan_ids = sorted(scan_ids)
        n_train = int(ratio * len(scan_ids)) + 1
        splits = {"train": scan_ids[:n_train], "val": scan_ids[n_train:]}
        for name, ids in splits.items():
            (split_dir / f"{name}_split.txt").write_text("\n".join(ids))

    def _as_device(self, array):
        return torch.as_tensor(array).to(self.device, F64)

    def _finalize_and_save(self, scan_id, vertices, vertex_colors,
                           vertex_instance, inst_to_label, bbox_list=None,
                           align=True):
        """Tensors on ``self.device`` in; the cap's indices are drawn on the
        host from ``self.rng`` (the draw the reference's global
        ``np.random.choice`` makes from the same seed) and gathered on the
        device; numpy arrays out."""
        align_angle = 0.0
        with self.device_pass():
            if align and bbox_list:
                align_angle = calc_align_matrix(bbox_list)
                vertices = rotate_z_axis_by_degrees(vertices, align_angle)
            vertices = vertices.to(F64)
            vertex_colors = vertex_colors.to(F64)
            if vertex_colors.max() <= 1:
                vertex_colors = vertex_colors * 255.0
            center = vertices.mean(dim=0)
            center[2] = vertices[:, 2].min()
            vertices = vertices - center
            assert vertex_colors.shape == vertices.shape
            assert vertex_colors.shape[0] == vertex_instance.shape[0]
            if vertices.shape[0] > PTS_LIMIT:
                idx = torch.from_numpy(self.rng.choice(
                    vertices.shape[0], PTS_LIMIT, replace=False)).to(self.device)
                vertices, vertex_colors, vertex_instance = (
                    vertices[idx], vertex_colors[idx], vertex_instance[idx]
                )
            arrays = (_host(vertices), _host(vertex_colors),
                      _host(vertex_instance))
        if self.check_key(self.output.get("pcd")):
            torch.save(inst_to_label, str(self.inst2label_path / f"{scan_id}.pth"))
            torch.save(arrays, str(self.pcd_path / f"{scan_id}.pth"))
            np.save(self.pcd_path / f"{scan_id}_align_angle.npy", align_angle)

    def process_scans(self):
        """With ``num_workers > 1`` the scans go to joblib's workers (joblib
        is imported only then, and its absence raises), each scan drawing
        its cap from a ``RandomState`` seeded by (seed, scan position). The
        reference's workers draw from unseeded global states there, so only
        ``num_workers = 1`` gives the reference's draws."""
        scan_ids = self.read_all_scans()
        self.log_starting_info(len(scan_ids))
        if self.num_workers > 1:
            from joblib import Parallel, delayed

            Parallel(n_jobs=self.num_workers)(
                delayed(self._scene_job)(pos, s) for pos, s in enumerate(scan_ids)
            )
        else:
            for s in scan_ids:
                self.scene_proc(s)
        self.record_splits(self._split_ids(scan_ids))

    def _scene_job(self, pos, scan_id):
        job = copy.copy(self)
        seed = self.cfg.get("seed")
        job.rng = np.random.RandomState(None if seed is None else [seed, pos])
        job.scene_proc(scan_id)

    def _split_ids(self, scan_ids):
        return scan_ids


@PROCESSOR_REGISTRY.register()
class RScanProcessor(_SceneProcessor):
    """3RScan (reference preprocess/rscan.py:18-149)."""

    def read_all_scans(self):
        return [p.split("/")[-1] for p in glob(str(self.data_root) + "/*")]

    def scene_proc(self, scan_id):
        root = self.data_root / scan_id
        if not (root / "labels.instances.annotated.v2.ply").exists():
            return
        vertices, texture = _read_obj(root / "mesh.refined.v2.obj")
        label_ply = load_ply(root / "labels.instances.annotated.v2.ply")
        segments = json.load(open(root / "mesh.refined.0.010000.segs.v2.json",
                                  encoding="utf-8"))
        aggregation = json.load(open(root / "semseg.v2.json", encoding="utf-8"))
        with self.device_pass():
            vertices = self._as_device(vertices)
            vertex_colors = texture_colors(vertices.shape[0], texture, self.device)
        self.process_point_cloud(
            scan_id, vertices, vertex_colors, label_ply, segments, aggregation
        )

    def process_point_cloud(self, scan_id, vertices, vertex_colors, label_ply,
                            segments, aggregation):
        seg_indices = np.asarray(segments["segIndices"])
        seg_to_inst = {}
        inst_to_label = {}
        bbox_list = []
        for group in aggregation["segGroups"]:
            if group["label"] not in LC.RSCAN_SCANNET:
                continue
            inst_to_label[group["id"]] = LC.RSCAN_SCANNET[group["label"]]
            rotation = np.asarray(group["obb"]["normalizedAxes"]).reshape(3, 3)
            centroid = np.asarray(group["obb"]["centroid"]).reshape(3)
            scale = np.asarray(group["obb"]["axesLengths"]).reshape(3)
            bbox_list.append(compute_box_3d(scale.tolist(), centroid, rotation))
            for seg in group["segments"]:
                seg_to_inst[seg] = group["id"]
        lut = np.full(int(seg_indices.max()) + 1, -1, np.int64)
        for seg, inst in seg_to_inst.items():
            if seg < lut.shape[0]:
                lut[seg] = inst

        # nearest label-mesh vertex within 0.1m assigns the instance
        # (reference rscan.py:74-91)
        with self.device_pass():
            vertices = self._as_device(vertices)
            vertex_colors = self._as_device(vertex_colors)
            dist, nn = nearest_vertex(
                vertices, self._as_device(label_ply["vertices"]))
            seg_of_nn = torch.from_numpy(seg_indices).to(self.device)[nn]
            instance = torch.where(
                dist <= NN_MAX_DIST,
                torch.from_numpy(lut).to(self.device)[seg_of_nn], -1)
        self._finalize_and_save(
            scan_id, vertices, vertex_colors, instance, inst_to_label, bbox_list
        )


@PROCESSOR_REGISTRY.register()
class MultiScanProcessor(_SceneProcessor):
    """MultiScan (reference preprocess/multiscan.py): per-face objectId plys +
    semantic annotation jsons."""

    def read_all_scans(self):
        out = []
        for p in glob(str(self.data_root) + "/*"):
            m = re.findall(r"scene\_[0-9]{5}\_[0-9]{2}", p)
            if m:
                out.append(m[0])
        return sorted(set(out))

    def scene_proc(self, scan_id):
        root = self.data_root / scan_id
        ply_path = root / f"{scan_id}.ply"
        anno_path = root / f"{scan_id}.annotations.json"
        if not ply_path.exists() or not anno_path.exists():
            return
        annotations = json.load(open(anno_path, encoding="utf-8"))
        mesh = load_ply(ply_path)

        # object label map from annotations: objects carry 'objectId'+'label'
        inst_to_label = {}
        for obj in annotations.get("objects", []):
            label = obj["label"].split(".")[0]
            if label in LC.MULTISCAN_SCANNET:
                inst_to_label[obj["objectId"]] = LC.MULTISCAN_SCANNET[label]

        with self.device_pass():
            vertices = self._as_device(mesh["vertices"])
            colors = (self._as_device(mesh["colors"])
                      if mesh["colors"] is not None
                      else torch.full_like(vertices, 127.0))
            instance = face_instances(
                vertices.shape[0], mesh.get("faces"),
                mesh.get("face_object_ids"), inst_to_label, self.device)
        self._finalize_and_save(
            scan_id, vertices, colors, instance, inst_to_label, align=False
        )


@PROCESSOR_REGISTRY.register()
class ARKitScenesProcessor(_SceneProcessor):
    """ARKitScenes (reference preprocess/arkitscenes.py): oriented-box
    containment labels each vertex; boxes drive axis alignment."""

    def read_all_scans(self):
        out = []
        for split in ("Training", "Validation"):
            for p in glob(str(self.data_root) + f"/{split}/*"):
                out.append((split, p.split("/")[-1]))
        return out

    def _split_ids(self, scan_ids):
        return [s[1] for s in scan_ids]

    def record_splits(self, scan_ids, ratio=None):
        split_dir = self.save_root / "split"
        split_dir.mkdir(parents=True, exist_ok=True)
        train = [s for s in self._all_scans if s[0] == "Training"]
        val = [s for s in self._all_scans if s[0] == "Validation"]
        (split_dir / "train_split.txt").write_text("\n".join(s[1] for s in train))
        (split_dir / "val_split.txt").write_text("\n".join(s[1] for s in val))

    def process_scans(self):
        self._all_scans = self.read_all_scans()
        self.log_starting_info(len(self._all_scans))
        for split, scan_id in self._all_scans:
            self.scene_proc(split, scan_id)
        self.record_splits(None)

    def scene_proc(self, split, scan_id):
        root = self.data_root / split / scan_id
        ply_path = root / f"{scan_id}_3dod_mesh.ply"
        anno_path = root / f"{scan_id}_3dod_annotation.json"
        if not ply_path.exists() or not anno_path.exists():
            return
        mesh = load_ply(ply_path)
        annotations = json.load(open(anno_path, encoding="utf-8"))

        with self.device_pass():
            vertices = self._as_device(mesh["vertices"])
            colors = (self._as_device(mesh["colors"])
                      if mesh["colors"] is not None
                      else torch.full_like(vertices, 127.0))
            instance = torch.zeros(vertices.shape[0], dtype=torch.long,
                                   device=self.device)
            inst_to_label = {}
            bbox_list = []
            for i, info in enumerate(annotations["data"]):
                label = info["label"]
                if label not in LC.ARKITSCENE_SCANNET:
                    continue
                obj_id = i + 1
                obb = info["segments"]["obbAligned"]
                rotation = np.asarray(obb["normalizedAxes"]).reshape(3, 3)
                centroid = np.asarray(obb["centroid"]).reshape(3)
                scale = np.asarray(obb["axesLengths"]).reshape(3)
                # analytic oriented-box containment (replaces
                # trimesh.contains); a later box overwrites an earlier one
                local = ((vertices - self._as_device(centroid))
                         @ self._as_device(rotation).T)
                inside = (local.abs() <= self._as_device(scale / 2 + 1e-9)).all(dim=1)
                instance.masked_fill_(inside, obj_id)
                inst_to_label[obj_id] = LC.ARKITSCENE_SCANNET[label]
                bbox_list.append(compute_box_3d(scale.tolist(), centroid, rotation))
        if not bbox_list:
            return
        self._finalize_and_save(
            scan_id, vertices, colors, instance, inst_to_label, bbox_list
        )


@PROCESSOR_REGISTRY.register()
class Structured3DProcessor(_SceneProcessor):
    """Structured3D (reference preprocess/structured3d.py): point clouds with
    axis-aligned gt boxes; classes 38/39/40 (walls etc.) skipped."""

    def read_all_scans(self):
        out = []
        for split in ("train", "val", "test"):
            for p in glob(str(self.data_root) + f"/{split}/*"):
                stem = p.split("/")[-1]
                out.append((split, "_".join(stem.split("_")[:-2])))
        return out

    def process_scans(self):
        scans = self.read_all_scans()
        self.log_starting_info(len(scans))
        for split, scan_id in scans:
            self.scene_proc(split, scan_id)
        split_dir = self.save_root / "split"
        split_dir.mkdir(parents=True, exist_ok=True)
        for name in ("train", "val", "test"):
            ids = [s[1] for s in scans if s[0] == name]
            (split_dir / f"{name}_split.txt").write_text("\n".join(ids))

    def scene_proc(self, split, scan_id):
        root = self.data_root / split
        pc_path = root / f"{scan_id}_point_cloud.npy"
        anno_path = root / f"{scan_id}_annotation.npy"
        if not pc_path.exists() or not anno_path.exists():
            return
        data = np.load(pc_path, allow_pickle=True)
        annotations = np.load(anno_path, allow_pickle=True).item()

        with self.device_pass():
            data = self._as_device(data[:, :6])
            vertices = data[:, :3]
            colors = (data[:, 3:6] + 1) / 2.0 * 255.0
            instance = torch.full((vertices.shape[0],), -1, dtype=torch.long,
                                  device=self.device)
            inst_to_label = {}
            for _id, box in enumerate(annotations["gt_boxes_upright_depth"]):
                cls = annotations["class"][_id]
                if cls in (38, 39, 40):
                    continue
                centroid, dim = np.asarray(box[:3]), np.asarray(box[3:6])
                inside = ((vertices > self._as_device(centroid - dim / 2))
                          & (vertices < self._as_device(centroid + dim / 2))
                          ).all(dim=1)
                instance.masked_fill_(inside, _id)
                inst_to_label[_id] = LC.S3D_SCANNET[cls]
        self._finalize_and_save(
            scan_id, vertices, colors, instance, inst_to_label, align=False
        )

"""Minimal PLY mesh reader (vertices, per-vertex colors, faces) in pure
numpy: the port's own copy of ``sceneverse_tpu/preprocess/mesh_io.py``. Mesh
IO is file parsing and stays on the host. Replaces trimesh/open3d (used by
the reference processors for mesh IO; neither is a dependency). Supports
ascii and binary_little_endian PLY with x/y/z, optional
red/green/blue[/alpha], optional vertex_indices faces.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path):
    """Returns dict with 'vertices' (N,3) f32, 'colors' (N,3) u8 or None,
    'faces' (M,3) i64 or None."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elements = []  # (name, count, [(prop_name, dtype, is_list, idx_dtype)])
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property" and elements:
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], _PLY_DTYPES[parts[3]], True,
                                            _PLY_DTYPES[parts[2]]))
                else:
                    elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]], False, None))

        out = {"vertices": None, "colors": None, "faces": None}
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [f.readline() for _ in range(count)], dtype=np.float64,
                        ndmin=2,
                    )
                    names = [p[0] for p in props]
                    data = {n: rows[:, i] for i, n in enumerate(names)}
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    data = {p[0]: raw[p[0]] for p in props}
                out["vertices"] = np.stack(
                    [data["x"], data["y"], data["z"]], axis=1
                ).astype(np.float32)
                if "red" in data:
                    out["colors"] = np.stack(
                        [data["red"], data["green"], data["blue"]], axis=1
                    ).astype(np.uint8)
            elif name == "face":
                faces = []
                extra = {p[0]: [] for p in props if not p[2]}  # scalar props
                scalar_props = [p for p in props if not p[2]]
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        n = int(vals[0])
                        faces.append([int(v) for v in vals[1 : 1 + n]][:3])
                        for j, p in enumerate(scalar_props):
                            extra[p[0]].append(float(vals[1 + n + j]))
                else:
                    lp = next(p for p in props if p[2])
                    cnt_dt = np.dtype("<" + lp[3])
                    idx_dt = np.dtype("<" + lp[1])
                    sdt = [np.dtype("<" + p[1]) for p in scalar_props]
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                        idx = np.frombuffer(f.read(idx_dt.itemsize * n), idx_dt)
                        faces.append(idx[:3].astype(np.int64))
                        for p, dt in zip(scalar_props, sdt):
                            extra[p[0]].append(
                                np.frombuffer(f.read(dt.itemsize), dt)[0]
                            )
                out["faces"] = np.asarray(faces, np.int64) if faces else None
                for pname, vals in extra.items():
                    out[f"face_{pname}"] = np.asarray(vals)
    if "face_objectId" in out:
        out["face_object_ids"] = out["face_objectId"].astype(np.int64)
    return out


def save_ply(path, vertices, colors=None, faces=None):
    """Write a binary_little_endian PLY (x/y/z f32, optional red/green/blue
    u8 per vertex, optional triangle faces).

    This is the file-output half of the reference's open3d visualization
    surface (reference visualize_data.py:23-118 renders colored geometry
    interactively; open3d is not a dependency, so colored geometry exports
    to .ply instead — openable in any external viewer). Round-trips through
    :func:`load_ply`."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.ascontiguousarray(
            np.clip(np.asarray(colors), 0, 255), np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        faces = np.ascontiguousarray(faces, np.int32)
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    if colors is not None:
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    else:
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    rows = np.empty(n, vdt)
    rows["x"], rows["y"], rows["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if colors is not None:
        rows["red"], rows["green"], rows["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2])

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rows.tobytes())
        if faces is not None:
            fdt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            frows = np.empty(len(faces), fdt)
            frows["n"] = 3
            frows["v"] = faces[:, :3]
            f.write(frows.tobytes())
    return path

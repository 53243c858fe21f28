"""The port's offline tools against the JAX package on the CPU: mesh IO,
``common/io_utils.py``, the four scene processors end to end on raw scans
written from a seed, and the HM3D semantic mapper.

Both sides run on the same raw files. Before each run the JAX package's
global ``np.random`` is seeded and the port's processor gets the same seed
(``cfg.seed``, its own ``RandomState``), so the 240K cap (cut to 100 here,
in both modules) draws the same indices. Instance ids, labels, split files
and align angles must be equal; vertices and colours within 1e-9 (the
port's mean and rotation sum in torch's order, not numpy's)."""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

import sceneverse_tpu.preprocess.processors as jax_proc
from sceneverse_tpu.common import io_utils as jax_io
from sceneverse_tpu.config import Config as JaxConfig
from sceneverse_tpu.preprocess import hm_semantic as jax_hm
from sceneverse_tpu.preprocess import mesh_io as jax_mesh
from sceneverse_tpu_torch.common import io_utils
from sceneverse_tpu_torch.config import Config
from sceneverse_tpu_torch.preprocess import fixture, hm_semantic, mesh_io
from sceneverse_tpu_torch.preprocess import processors as proc

VERTEX_TOL = 1e-9
SEED = 5
CAP = 100


def _raw_rscan(root, rng):
    fixture.write_rscan_scan(root, "scan0001", rng, 150, 3, texture=(4, 4))
    fixture.write_rscan_scan(root, "scan0002", rng, 120, 3)


def _raw_multiscan(root, rng):
    fixture.write_multiscan_scan(root, "scene_00000_00", rng, 150, 300, 4)
    fixture.write_multiscan_scan(root, "scene_00001_00", rng, 60, 90, 2)


def _raw_arkit(root, rng):
    fixture.write_arkit_scan(root, "Training", "41069021", rng, 200, 4)
    fixture.write_arkit_scan(root, "Validation", "42444946", rng, 90, 3)


def _raw_s3d(root, rng):
    fixture.write_s3d_scan(root, "train", "scene_00000", rng, 160, 5)
    fixture.write_s3d_scan(root, "val", "scene_00001", rng, 80, 3)


PROCESSORS = {
    "RScanProcessor": _raw_rscan,
    "MultiScanProcessor": _raw_multiscan,
    "ARKitScenesProcessor": _raw_arkit,
    "Structured3DProcessor": _raw_s3d,
}


def _cfg(raw, out, **extra):
    return {"data_root": str(raw), "save_root": str(out), "num_workers": 1,
            "output": {"pcd": True}, **extra}


def _outputs(out):
    """{relative path: content} of a processor's outputs."""
    got = {}
    for path in sorted(out.rglob("*")):
        rel = str(path.relative_to(out))
        if path.suffix == ".pth":
            got[rel] = torch.load(path, weights_only=False)
        elif path.suffix == ".npy":
            got[rel] = np.load(path)
        elif path.is_file():
            got[rel] = path.read_text()
    return got


def _assert_same_outputs(got, want):
    assert got.keys() == want.keys()
    assert any("pcd_with_global_alignment" in k for k in got)
    for key, ref in want.items():
        out = got[key]
        if "pcd_with_global_alignment" in key and key.endswith(".pth"):
            assert len(out) == len(ref) == 3, key
            for a in out:
                assert type(a) is np.ndarray, key
            (v, c, inst), (rv, rc, rinst) = out, ref
            assert v.dtype == rv.dtype == np.float64 and v.shape == rv.shape
            assert c.dtype == rc.dtype and c.shape == rc.shape
            np.testing.assert_allclose(v, rv, rtol=0, atol=VERTEX_TOL)
            np.testing.assert_allclose(c, rc, rtol=0, atol=VERTEX_TOL)
            assert inst.dtype == rinst.dtype
            np.testing.assert_array_equal(inst, rinst)
        elif isinstance(ref, np.ndarray):
            assert out.dtype == ref.dtype
            np.testing.assert_array_equal(out, ref)
        else:
            assert out == ref, key


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_matches_jax(name, tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    PROCESSORS[name](raw, np.random.RandomState(0))
    monkeypatch.setattr(jax_proc, "PTS_LIMIT", CAP)
    monkeypatch.setattr(proc, "PTS_LIMIT", CAP)

    np.random.seed(SEED)
    getattr(jax_proc, name)(JaxConfig(_cfg(raw, tmp_path / "jax"))).process_scans()
    port = getattr(proc, name)(
        Config(_cfg(raw, tmp_path / "port", device="cpu", seed=SEED)))
    port.process_scans()
    assert port.device_seconds > 0

    want = _outputs(tmp_path / "jax")
    _assert_same_outputs(_outputs(tmp_path / "port"), want)
    # every fixture exercises the cap and labels some but not all vertices
    pcds = [v for k, v in want.items()
            if "pcd_with" in k and k.endswith(".pth")]
    assert any(len(p[0]) == CAP for p in pcds)
    inst = np.concatenate([p[2] for p in pcds])
    assert (inst > 0).any() and (inst <= 0).any()


def test_rscan_texture_and_far_vertices(tmp_path, monkeypatch):
    """The textured scan's colours come from the PNG (not the 0.5 grey),
    the untextured scan's are all grey, and the far vertices stay
    unlabelled."""
    raw = tmp_path / "raw"
    _raw_rscan(raw, np.random.RandomState(0))
    monkeypatch.setattr(proc, "PTS_LIMIT", 10**6)
    proc.RScanProcessor(Config(_cfg(raw, tmp_path / "port", device="cpu"))
                        ).process_scans()
    pcd = tmp_path / "port/scan_data/pcd_with_global_alignment"
    v, c, inst = torch.load(pcd / "scan0001.pth", weights_only=False)
    assert not np.all(c == 127.5)
    assert (inst[-7:] == -1).all()  # 150 // 20 far vertices at the end
    _, c2, _ = torch.load(pcd / "scan0002.pth", weights_only=False)
    assert np.all(c2 == 127.5)


def test_face_instances_match_the_face_loop():
    """The scatter-amax of face indices against the reference's loop, where
    the last labelled face touching a vertex wins, on faces that share
    vertices heavily."""
    rng = np.random.RandomState(3)
    n_vertices, n_faces = 40, 300
    faces = rng.randint(0, n_vertices, (n_faces, 3))
    objs = rng.randint(0, 6, n_faces)
    labelled = {1: "a", 2: "b", 4: "c"}
    want = np.full(n_vertices, -1, np.int64)
    for f, oid in zip(faces, objs):
        if oid in labelled:
            want[f] = oid
    got = proc.face_instances(n_vertices, faces, objs, labelled, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    none = proc.face_instances(n_vertices, faces, objs, {9: "x"}, "cpu")
    assert (none == -1).all()


@pytest.mark.parametrize("block_elems", [1, 64, 1 << 27])
def test_nearest_vertex_matches_kdtree(block_elems):
    rng = np.random.RandomState(1)
    ref = rng.randn(50, 3)
    query = np.concatenate([rng.randn(30, 3), ref[:5] + 1e-3, ref[5:8]])
    dist, index = proc.nearest_vertex(torch.from_numpy(query),
                                      torch.from_numpy(ref), block_elems)
    want_d, want_i = cKDTree(ref).query(query, k=1)
    np.testing.assert_array_equal(index.numpy(), want_i)
    np.testing.assert_allclose(dist.numpy(), want_d, rtol=0, atol=1e-15)
    assert (dist.numpy()[-3:] == 0).all()


def test_nearest_vertex_takes_the_lowest_index_at_a_tie():
    ref = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, 1.0, 0]],
                       dtype=torch.float64)
    query = torch.tensor([[0.0, 0, 0], [0, 2.0, 0]], dtype=torch.float64)
    dist, index = proc.nearest_vertex(query, ref, block_elems=4)
    assert index.tolist() == [0, 1]
    assert dist.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_without_device_and_without_cuda_raises(name, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(proc, name)(Config(_cfg(tmp_path, tmp_path / "o", **extra)))


def test_parallel_workers_draw_from_seeded_states(tmp_path, monkeypatch):
    """``num_workers > 1`` (joblib) gives each scan a ``RandomState`` seeded
    by (seed, position): two runs with one seed write the same arrays."""
    raw = tmp_path / "raw"
    _raw_multiscan(raw, np.random.RandomState(0))
    monkeypatch.setattr(proc, "PTS_LIMIT", CAP)
    runs = []
    for k in range(2):
        cfg = _cfg(raw, tmp_path / f"p{k}", device="cpu", seed=SEED,
                   num_workers=2)
        proc.MultiScanProcessor(Config(cfg)).process_scans()
        runs.append(_outputs(tmp_path / f"p{k}"))
    _assert_same_outputs(*runs)


# ----------------------------------------------------------------- mesh IO
def _write_ascii_ply(path, verts, cols, faces, face_ids):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nproperty int objectId\n")
        f.write("end_header\n")
        for v, c in zip(verts, cols):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for face, oid in zip(faces, face_ids):
            f.write(f"3 {face[0]} {face[1]} {face[2]} {oid}\n")


@pytest.mark.parametrize("fmt", ["ascii", "binary", "binary_bare"])
def test_load_ply_matches_jax(fmt, tmp_path):
    """Vertices, colours, faces and face ids; ``binary_bare`` has faces
    only (no colours, no face ids)."""
    rng = np.random.RandomState(2)
    verts = rng.randn(12, 3).astype(np.float32)
    cols = rng.randint(0, 256, (12, 3)).astype(np.uint8)
    faces = rng.randint(0, 12, (7, 3))
    face_ids = rng.randint(0, 4, 7)
    path = tmp_path / f"{fmt}.ply"
    if fmt == "ascii":
        _write_ascii_ply(path, verts, cols, faces, face_ids)
    elif fmt == "binary":
        fixture.write_binary_ply(path, verts, cols, faces, face_ids)
    else:
        fixture.write_binary_ply(path, verts, None, faces)
    got, want = mesh_io.load_ply(path), jax_mesh.load_ply(path)
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["faces"], faces)
    if fmt == "binary_bare":
        assert got["colors"] is None and "face_object_ids" not in got
    else:
        np.testing.assert_array_equal(got["face_object_ids"], face_ids)


@pytest.mark.parametrize("parts", ["full", "clip", "bare"])
def test_save_ply_writes_jax_bytes(parts, tmp_path):
    rng = np.random.RandomState(7)
    verts = rng.randn(17, 3)
    args = {"full": (rng.randint(0, 256, (17, 3)), rng.randint(0, 17, (5, 3))),
            "clip": (np.array([[-5.0, 300.0, 128.0]] * 17), None),
            "bare": (None, None)}[parts]
    got = mesh_io.save_ply(tmp_path / "port.ply", verts, *args)
    want = jax_mesh.save_ply(tmp_path / "jax.ply", verts, *args)
    assert got.read_bytes() == want.read_bytes()
    back = mesh_io.load_ply(got)
    np.testing.assert_array_equal(back["vertices"], verts.astype(np.float32))


# ----------------------------------------------------------------- io_utils
IO_DATA = {"a": [1, 2.5, "x"], "b": {"c": None}}
IO_PAIRS = {
    "pickle": ("save_pickle", "load_pickle", IO_DATA),
    "json": ("save_json", "load_json", IO_DATA),
    "jsonl": ("save_jsonl", "load_jsonl", [{"a": 1}, {"b": [2, 3]}]),
    "yaml": ("save_yaml", "load_yaml", IO_DATA),
    "tensor": ("save_tensor", "load_tensor", {"t": np.arange(4)}),
    "numpy": ("save_numpy", "load_numpy", np.arange(6.0).reshape(2, 3)),
    "csv": ("save_csv", "load_csv", [["1", "a"], ["2", "b"]]),
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("kind", sorted(IO_PAIRS))
def test_io_utils_round_trip_and_read_jax_files(kind, tmp_path):
    save, load, data = IO_PAIRS[kind]
    suffix = ".npy" if kind == "numpy" else f".{kind}"
    mine, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    getattr(io_utils, save)(data, mine)
    getattr(jax_io, save)(data, theirs)
    for path in (mine, theirs):
        assert _same(getattr(io_utils, load)(path), data), path
        assert _same(getattr(jax_io, load)(path), data), path
    if kind not in ("tensor",):  # torch.save records the file's name
        assert mine.read_bytes() == theirs.read_bytes()


def test_io_utils_mesh_images_and_dirs(tmp_path):
    io_utils.make_dir(tmp_path / "a/b")
    assert (tmp_path / "a/b").is_dir()
    rng = np.random.RandomState(4)
    verts = rng.randn(9, 3)
    faces = rng.randint(0, 9, (4, 3))
    mesh_io.save_ply(tmp_path / "m.ply", verts, None, faces)
    (v, f), (jv, jf) = (io_utils.load_ply(tmp_path / "m.ply"),
                        jax_io.load_ply(tmp_path / "m.ply"))
    assert v.dtype == jv.dtype == np.float64
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    image = rng.randint(0, 256, (3, 5, 3)).astype(np.uint8)
    Image.fromarray(image).save(tmp_path / "i.png")
    for flag in ("color", "gray"):
        got = io_utils.load_imgs([tmp_path / "i.png"], flag)
        want = jax_io.load_imgs([tmp_path / "i.png"], flag)
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(io_utils.load_imgs([tmp_path / "i.png"])[0],
                                  image)


# -------------------------------------------------------------- HM3D mapper
def test_hm_semantic_matches_jax(tmp_path):
    table = ("HM3D Semantic Annotations\n" + "".join(
        f'{i},{c},"{n}",\n' for i, (c, n) in enumerate(
            [("FF0000", "chair"), ("00FF00", "table"), ("FF", "lamp"),
             ("FF0000", "chair"), ("0A0B0C", "sofa")], 1)))
    outs = []
    for side, mod in (("port", hm_semantic), ("jax", jax_hm)):
        scene = tmp_path / side / "00001-abcdef"
        scene.mkdir(parents=True)
        (scene / "abcdef.semantic.txt").write_text(table)
        mod.main(["--data_root", str(tmp_path / side)])
        outs.append((scene / "tgt_id2obj_id.json").read_text())
    assert outs[0] == outs[1]
    assert len(json.loads(outs[0])) == 4

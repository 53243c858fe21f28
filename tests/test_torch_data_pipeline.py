"""The port's data pipeline against the JAX package's, on an on-disk
SceneVerse tree written by ``sceneverse_tpu.data.fixture`` at a small size.

Both packages run the same numpy code on the same seeds, so the tolerance is
exact equality everywhere: every family's items on every split (train items
after the same ``np.random`` / ``random`` seeds), both wrappers, the
obj-pretrain datasets, the ``all_pretrain.yaml`` source mix, the augmentor
with every switch on, the ``pc_type: pred`` branch on Mask3D files this test
writes, the per-scene and final-refer builders, the tokenizer, the
``data_utils`` functions, the fixture writer itself, the native library, the
materialized stores and batch loader, and loaders with worker processes.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import sceneverse_tpu.data  # noqa: F401 (registries)
import sceneverse_tpu_torch.data  # noqa: F401 (registries)
from sceneverse_tpu.config import Config as JConfig
from sceneverse_tpu.config import load_config as jload
from sceneverse_tpu.data import build as jbuild
from sceneverse_tpu.data.fixture import write_synthetic_tree
from sceneverse_tpu_torch.config import Config as TConfig
from sceneverse_tpu_torch.config import load_config as tload
from sceneverse_tpu_torch.data import build as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_PRETRAIN = os.path.join(REPO, "configs", "final", "all_pretrain.yaml")
FAMILIES = ["ScanNet", "RScan", "ARKitScene", "MultiScan", "HM", "ProcThor",
            "S3D"]
BASE_KEYS = {"ScanNet": "scan_family_base", "RScan": "rscan_base",
             "ARKitScene": "arkitscene_base", "MultiScan": "multiscan_base",
             "HM": "hm_base", "ProcThor": "procthor_base", "S3D": "s3d_base"}
SCANNET_SOURCES = {
    "sources": ["scanrefer", "referit3d", "sgrefer", "sgcaption"],
    "referit3d": {"anno_type": ["sr3d", "nr3d"], "sr3d_plus_aug": True},
    "sgrefer": {"anno_type": ["rel2_gpt", "star_template"]},
    "sgcaption": {"anno_type": ["gpt", "template"]},
}
OTHER_SOURCES = {"sources": ["anno", "rel2_template", "relm_gpt"]}
ALL_ON_AUG = {
    "aug_list": ["scene_aug", "obj_aug"],
    "scene_aug": {
        "translation": {"enabled": True, "value": [1.0, 1.0, 1.0], "p": 1.0},
        "scaling": {"enabled": True, "p": 1.0, "value": [0.9, 1.1]},
        "flip": {"enabled": True, "p": 1.0},
        "rotation": {"enabled": True, "p": 1.0, "axis_align": True,
                     "value": [0.0, 0.0, 1.0], "shuffle": True},
        "color_jitter": True,
        "order_shuffle": True,
    },
    "obj_aug": {
        "translation": {"enabled": True, "value": [0.1, 0.1, 0.1], "p": 1.0},
        "rotation": {"enabled": True, "p": 1.0, "axis_align": False,
                     "value": [0.0, 0.0, 0.1], "shuffle": True},
        "random_jitter": {"enabled": True, "value": 0.01},
        "pts_shuffle": True,
    },
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 scans x 14 objects (11 foreground: the crop to max_obj_len - 1 = 5
    runs) x 40 points (subsampling to 32 without replacement, 64 with)."""
    return write_synthetic_tree(tmp_path_factory.mktemp("sv"), n_scans=3,
                                n_objects=14, pts_per_obj=40)


@pytest.fixture(scope="module")
def pred_root(tmp_path_factory):
    """A tree with Mask3D predictions: per scan a sparse (n_pred, n_points)
    mask whose rows are each object's points (some shrunk, one empty, one
    spanning two objects) and their labels."""
    from scipy import sparse

    root = write_synthetic_tree(tmp_path_factory.mktemp("svpred"), n_scans=2,
                                n_objects=10, pts_per_obj=40, seed=3)
    (root / "mask").mkdir()
    rng = np.random.RandomState(5)
    for scan in ("scene0000_00", "scene0001_00"):
        pts, _, _, inst = torch.load(
            root / f"scan_data/pcd_with_global_alignment/{scan}.pth",
            weights_only=False)
        rows = []
        for i in range(10):
            m = inst == i
            if i % 3 == 1:  # a prediction holding part of the object
                m &= rng.rand(len(m)) < 0.7
            rows.append(m)
        rows.append(np.zeros(len(inst), bool))  # an empty prediction
        rows.append((inst == 3) | (inst == 4))  # two objects merged
        mask = sparse.csr_matrix(np.stack(rows).astype(np.int8))
        sparse.save_npz(root / f"mask/{scan}.mask.npz", mask)
        np.save(root / f"mask/{scan}.label.npy",
                rng.randint(0, 10, len(rows)))
    return root


def _cfg_dict(root, split_cfgs=None, **args):
    data_args = {
        "max_obj_len": 6, "max_seq_len": 16, "num_points": 32,
        "pc_type": "gt", "sem_type": "607", "filter_lang": False,
        "txt_mask_ratio": 0.15, "pc_mask_ratio": 0.1, "rot_aug": True,
        "mask_strategy": "random", "use_scene_cap": True,
        "max_scene_cap_len": 24,
    }
    data_args.update(args)
    data = {"args": data_args, **{k: str(root) for k in BASE_KEYS.values()},
            **{s: ["ScanNetSpatialRefer"] for s in ("train", "val", "test")}}
    for fam in FAMILIES:
        src = SCANNET_SOURCES if fam == "ScanNet" else OTHER_SOURCES
        data[f"{fam}SpatialRefer"] = {s: src for s in ("train", "val", "test")}
    data.update(split_cfgs or {})
    return {
        "rng_seed": 7, "num_gpu": 1,
        "debug": {"flag": False, "debug_size": -1},
        "data": data,
        "data_wrapper": {"train": "MaskDatasetWrapper",
                         "val": "ScanFamilyDatasetWrapperOld",
                         "test": "ScanFamilyDatasetWrapperOld"},
        "dataloader": {"batchsize": 4, "num_workers": 0},
    }


def _cfgs(root, data_aug=None, **args):
    d = _cfg_dict(root, **args)
    if data_aug is not None:
        d["data_aug"] = data_aug
    return JConfig(d), TConfig(d)


def _seeded(i):
    np.random.seed(1000 + i)
    random.seed(2000 + i)


def _same(a, b, where=""):
    """Exact equality of items / batches: keys, types, dtypes, values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a.keys(),
                                                            b.keys())
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        if a.dtype == object:
            assert a.tolist() == b.tolist(), where
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _items(jds, tds, n=6):
    """The first ``n`` items of both datasets, each after the same global
    seeds on both sides: train items draw from ``np.random`` and
    ``random``, and so does the augmentor on every split where ``data_aug``
    is set (its queue is empty off train, its subsampling is not)."""
    assert len(jds) == len(tds) > 0
    for i in range(min(n, len(jds))):
        _seeded(i)
        want = jds[i]
        _seeded(i)
        _same(want, tds[i], f"item {i}")


# ----------------------------------------------------------------- datasets
@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("family", FAMILIES)
def test_spatial_refer_items_match_jax(root, family, split):
    jc, tc = _cfgs(root)
    name = f"{family}SpatialRefer"
    jds = jbuild.DATASET_REGISTRY.get(name)(jc, split)
    tds = tbuild.DATASET_REGISTRY.get(name)(tc, split)
    assert (tds.split, tds.pc_type) == (jds.split, jds.pc_type)
    _items(jds, tds)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("family", FAMILIES)
def test_pretrain_obj_items_match_jax(root, family, split):
    jc, tc = _cfgs(root, max_obj_len=5)  # 11 objects: the shuffle-crop runs
    name = f"{family}PretrainObj"
    jds = jbuild.DATASET_REGISTRY.get(name)(jc, split)
    tds = tbuild.DATASET_REGISTRY.get(name)(tc, split)
    _items(jds, tds)


@pytest.mark.parametrize("wrapper,split", [
    ("MaskDatasetWrapper", "train"),
    ("ScanFamilyDatasetWrapperOld", "val"),
    ("ScanFamilyDatasetWrapperOld", "test"),
    ("ScanFamilyDatasetWrapperOld", "train"),
    ("VisualizeDatasetWrapper", "train"),
])
def test_wrapped_items_match_jax(root, wrapper, split):
    from sceneverse_tpu.data.datasets.dataset_wrapper import \
        DATASETWRAPPER_REGISTRY as JW
    from sceneverse_tpu_torch.data.datasets.dataset_wrapper import \
        DATASETWRAPPER_REGISTRY as TW

    extra = {}
    if wrapper == "VisualizeDatasetWrapper":  # whole-scene clouds
        extra = {"data_aug": ALL_ON_AUG, "load_scene_pcds": True,
                 "max_pcd_num_points": 600, "bg_points_num": 100}
    jc, tc = _cfgs(root, **extra)
    jds = JW.get(wrapper)(jc, jbuild.DATASET_REGISTRY.get(
        "ScanNetSpatialRefer")(jc, split))
    tds = TW.get(wrapper)(tc, tbuild.DATASET_REGISTRY.get(
        "ScanNetSpatialRefer")(tc, split))
    _items(jds, tds)


def test_all_pretrain_source_mix_matches_jax(root):
    """configs/final/all_pretrain.yaml's data section with every root at
    the one tree: the same concatenated train set, item for item at each
    family's first index, and the same val / test datasets."""
    over = [f"data.{k}={root}" for k in (
        "scan_family_base", "rscan_base", "arkitscene_base",
        "multiscan_base", "hm_base")] + [
        "data.args.max_obj_len=6", "data.args.max_seq_len=16",
        "data.args.num_points=32", "data.args.pc_type=gt",
        "data.args.max_scene_cap_len=24", "num_gpu=1"]
    jc, tc = jload(ALL_PRETRAIN, over), tload(ALL_PRETRAIN, over)
    jtrain, ttrain = jbuild.get_dataset(jc, "train"), tbuild.get_dataset(
        tc, "train")
    assert len(ttrain) == len(jtrain)
    assert [len(d) for d in ttrain.datasets] == [len(d) for d in
                                                 jtrain.datasets]
    offsets = np.cumsum([0] + [len(d) for d in jtrain.datasets])[:-1]
    for k, i in enumerate(list(offsets) + [len(jtrain) - 1]):
        _seeded(k)
        want = jtrain[int(i)]
        _seeded(k)
        _same(want, ttrain[int(i)], f"train item {i}")
    for split in ("val", "test"):
        jl, tl = jbuild.get_dataset(jc, split), tbuild.get_dataset(tc, split)
        assert len(tl) == len(jl) == 1
        _items(jl[0], tl[0], n=3)


@pytest.mark.parametrize("route", ["forward", "item", "scene"])
def test_augmentor_with_every_switch_matches_jax(root, route):
    from sceneverse_tpu.data.datasets.data_augmentor import DataAugmentor as JA
    from sceneverse_tpu_torch.data.datasets.data_augmentor import \
        DataAugmentor as TA

    if route == "forward":
        rng = np.random.RandomState(0)
        pcds = [rng.randn(50, 6).astype(np.float32) for _ in range(4)]
        bg = rng.randn(30, 6).astype(np.float32)
        outs = []
        for aug in (JA(JConfig(ALL_ON_AUG), "train"),
                    TA(TConfig(ALL_ON_AUG), "train")):
            outs.append(aug.forward({"obj_pcds": pcds, "bg_pcds": bg,
                                     "num_points": 16},
                                    rng=np.random.RandomState(1)))
        _same(*outs)
        return
    extra = {"data_aug": ALL_ON_AUG}
    if route == "scene":
        extra.update(load_scene_pcds=True, max_pcd_num_points=600,
                     bg_points_num=100)
    jc, tc = _cfgs(root, **extra)
    jds = jbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(jc, "train")
    tds = tbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(tc, "train")
    _items(jds, tds, n=4)


@pytest.mark.parametrize("split", ["val", "test", "train"])
def test_pred_branch_matches_jax(pred_root, split):
    """``pc_type: pred`` on Mask3D files: labels by IoU match to the gt
    boxes, IoU>=0.25 / 0.5 target lists, pred background (train forces
    gt, as in JAX)."""
    jc, tc = _cfgs(pred_root, pc_type="pred", max_obj_len=5)
    jds = jbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(jc, split)
    tds = tbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(tc, split)
    assert tds.pc_type == jds.pc_type == ("gt" if split == "train"
                                          else "pred")
    scan = tds.scan_data["scene0000_00"]
    assert len(scan["obj_pcds_pred"]) == 11  # the empty prediction dropped
    _same(jds.scan_data["scene0000_00"]["inst_labels_pred"],
          scan["inst_labels_pred"])
    _items(jds, tds, n=8)


@pytest.mark.parametrize("builder", ["perscene_gt", "perscene_pred",
                                     "finalrefer"])
def test_perscene_and_finalrefer_match_jax(root, pred_root, builder):
    from sceneverse_tpu.data.data_utils import per_scene_pad as jpad
    from sceneverse_tpu_torch.data.data_utils import per_scene_pad as tpad

    pred = builder == "perscene_pred"
    jc, tc = _cfgs(pred_root if pred else root, data_aug=ALL_ON_AUG,
                   load_scene_pcds=True, max_pcd_num_points=600,
                   bg_points_num=100, max_obj_len=5,
                   pc_type="pred" if pred else "gt")
    split = "val" if pred else "train"
    dss = [reg.get("ScanNetSpatialRefer")(c, split) for reg, c in
           ((jbuild.DATASET_REGISTRY, jc), (tbuild.DATASET_REGISTRY, tc))]
    outs = []
    for ds, pad in zip(dss, (jpad, tpad)):
        random.seed(3)
        if builder == "finalrefer":
            for i in range(3):
                ids, masks = ds.tokenizer.encode(
                    ds.lang_data[i]["utterance"], 16)
                ds.lang_data[i] = dict(ds.lang_data[i], txt_ids=ids,
                                       txt_masks=masks)
            get = ds._getitem_finalrefer
        else:
            ds.lang_data = pad(ds.lang_data, max_len=4,
                               tokenizer=ds.tokenizer, max_seq_len=16)
            get = ds._getitem_perscene
        got = []
        for i in range(3):
            _seeded(i)
            got.append(get(i))
        outs.append(got)
    _same(*outs)


# ---------------------------------------------------------------- tokenizer
TEXTS = [
    "the chair near the wall on the left",
    "Is it the TABLE, or the sofa?! (a 3-seat one); ok...",
    "Café naïve façade: ÉLAN résumé",
    "房间里的椅子 next to 桌子",
    "[CLS] find the [MASK] by the window [SEP] [PAD] [UNK]",
    "  tabs\tand\nnewlines  and  a verylongunbrokenwordthatgoesonandonandon",
    "",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    toks = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + ["the", "chair", "near", "wall", "on", "left", "is", "it", ",",
               "table", "or", "sofa", "?", "!", "(", ")", "a", "3", "-",
               "seat", "one", ";", "ok", ".", "cafe", "naive", "fa", "##cade",
               ":", "el", "##an", "resume", "房", "间", "里", "的", "椅", "子",
               "next", "to", "桌", "find", "by", "window", "tab", "##s",
               "and", "new", "##lines", "very", "##long"])
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(toks) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("vocab", ["hash", "file"])
@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(vocab_file, text, vocab):
    from sceneverse_tpu.data.tokenizer import WordPieceTokenizer as JT
    from sceneverse_tpu_torch.data.tokenizer import WordPieceTokenizer as TT

    path = vocab_file if vocab == "file" else None
    jt, tt = JT(path), TT(path)
    ids = tt.tokenize_to_ids(text)
    assert ids == jt.tokenize_to_ids(text)
    _same(jt.encode(text, 12), tt.encode(text, 12))
    _same(jt.batch_encode([text, "the chair"], 40),
          tt.batch_encode([text, "the chair"], 40))
    assert tt.decode(ids) == jt.decode(ids)
    assert (tt.vocab_size, tt.mask_token_id) == (jt.vocab_size,
                                                 jt.mask_token_id)


def test_get_tokenizer_resolves_as_jax(vocab_file):
    from sceneverse_tpu.data.tokenizer import get_tokenizer as jget
    from sceneverse_tpu_torch.data.tokenizer import get_tokenizer as tget

    for d in ({}, {"data": {"vocab_file": vocab_file}}):
        jt, tt = jget(JConfig(d)), tget(TConfig(d))
        assert (tt.vocab is None) == (jt.vocab is None)
        assert tt.vocab == jt.vocab and tt.vocab_size == jt.vocab_size


# --------------------------------------------------------------- data_utils
def _du_case(du, name, tok):
    rng = np.random.RandomState(4)
    if name == "random_word":
        tokens = rng.randint(1000, 30000, (3, 40))
        np.random.seed(9)  # the global stream, as the wrapper draws
        a = du.random_word(tokens, np.ones_like(tokens), tok, 0.15)
        return a, du.random_word(tokens, np.ones_like(tokens), tok, 0.15,
                                 rng=np.random.RandomState(1))
    if name == "random_point_cloud":
        np.random.seed(9)
        return du.random_point_cloud(rng.rand(50) > 0.3, 0.1)
    if name == "boxes_iou_matrix":
        return du.boxes_iou_matrix(rng.randn(5, 3), rng.rand(5, 3) + 0.2,
                                   rng.randn(4, 3), rng.rand(4, 3) + 0.2)
    if name == "build_rotate_mat":
        np.random.seed(9)
        return [du.build_rotate_mat(s, r) for s in ("train", "val")
                for r in (True, False)] + [du.build_rotate_mat(
                    "train", True, rng=np.random.RandomState(2))]
    if name == "pad_array":
        return [du.pad_array(rng.randn(3, 4), 6, pad=1.0, dtype=np.float32),
                du.pad_array(np.arange(4), 4), du.pad_array([1, 2], 5, -100)]
    if name == "merge_tokens":
        a = tok.encode("this is a room with chairs", 20)
        b = tok.encode("the chair near the wall", 12)
        return du.merge_tokens(*a, *b, max_len=14, tokenizer=tok)
    if name == "per_scene_pad":
        items = [{"scan_id": f"s{i % 2}", "utterance": f"item {i} chair"}
                 for i in range(7)]
        random.seed(5)
        return du.per_scene_pad(items, max_len=3, tokenizer=tok,
                                max_seq_len=8)
    if name == "answers":
        qa = du.ScanQAAnswer(["chair", "two", "red"])
        sqa = du.SQA3DAnswer(["yes", "no", "u"])
        return ([qa.stoi(v) for v in ("two", "blue")], qa.itos(1), len(qa),
                [sqa.stoi(v) for v in ("no", "maybe")], sqa.itos(0), len(sqa),
                du.clean_answer("The   RIGTH  chair2!!"),
                du.get_sqa_question_type("What color is it?"),
                du.is_explicitly_view_dependent("the left one".split()))
    if name == "box_utils":
        c, s = du.convert_pc_to_box(rng.randn(20, 6))
        corners = du.construct_bbox_corners(c, s)
        return (c, s, corners, du.box3d_iou(corners, du.construct_bbox_corners(
            [0.1, 0.0, 0.0], s)), du.transform_points(rng.randn(6, 3),
                                                       rng.randn(4, 4)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "random_word", "random_point_cloud", "boxes_iou_matrix",
    "build_rotate_mat", "label_converter", "pad_array", "merge_tokens",
    "per_scene_pad", "answers", "box_utils"])
def test_data_utils_match_jax(root, name):
    from sceneverse_tpu.data import data_utils as jdu
    from sceneverse_tpu.data.tokenizer import WordPieceTokenizer as JT
    from sceneverse_tpu_torch.data import data_utils as tdu
    from sceneverse_tpu_torch.data.tokenizer import WordPieceTokenizer as TT

    if name == "label_converter":
        tsv = root / "annotations/meta_data/scannetv2-labels.combined.tsv"
        assert vars(tdu.LabelConverter(tsv)) == vars(jdu.LabelConverter(tsv))
        return
    _same(_du_case(jdu, name, JT()), _du_case(tdu, name, TT()))


# ------------------------------------------------------------------ fixture
def test_fixture_writes_the_same_tree(tmp_path):
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree as tw

    kw = dict(n_scans=2, n_objects=7, pts_per_obj=30, seed=4,
              annos_per_obj=2)
    a = write_synthetic_tree(tmp_path / "jax", **kw)
    b = tw(tmp_path / "torch", **kw)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert len(files) > 30
    for rel in files:
        if rel.suffix == ".pth":
            _same(torch.load(a / rel, weights_only=False),
                  torch.load(b / rel, weights_only=False), str(rel))
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# ------------------------------------------------------------------- native
def test_native_post_matches_jax():
    from sceneverse_tpu.data.native import obj_processing_post_native as jn
    from sceneverse_tpu_torch.data.native import \
        obj_processing_post_native as tn

    rng = np.random.RandomState(0)
    pcds = [rng.randn(n, 6).astype(np.float32) for n in (10, 40, 33, 1)]
    rot = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    for r, seed in ((None, 3), (rot, 11)):
        _same(jn(pcds, 32, rot=r, seed=seed), tn(pcds, 32, rot=r, seed=seed))


@pytest.mark.parametrize("split", ["train", "val"])
def test_native_loader_items_match_jax(root, split):
    jc, tc = _cfgs(root, native_loader=True)
    jds = jbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(jc, split)
    tds = tbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(tc, split)
    _items(jds, tds, n=4)


def test_native_loader_raises_where_jax_falls_back(root, tmp_path,
                                                   monkeypatch):
    """No library (here: a source g++ rejects): the port raises with the
    compiler's message; the JAX package takes its numpy path."""
    from sceneverse_tpu_torch.data import native

    bad = tmp_path / "batchops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    _, tc = _cfgs(root, native_loader=True)
    tds = tbuild.DATASET_REGISTRY.get("ScanNetSpatialRefer")(tc, "val")
    with pytest.raises(RuntimeError, match="batchops"):
        tds[0]
    with pytest.raises(RuntimeError, match="batchops"):  # and stays so
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------- materialized
@pytest.fixture(scope="module")
def stores(root, tmp_path_factory):
    """Each package's stores under its own root."""
    from sceneverse_tpu.data.materialized import ensure_materialized as je
    from sceneverse_tpu_torch.data.materialized import \
        ensure_materialized as te

    base = tmp_path_factory.mktemp("stores")
    out = {}
    for name, split in (("ScanNetSpatialRefer", "train"),
                        ("ScanNetSpatialRefer", "val"),
                        ("RScanSpatialRefer", "train"),
                        ("ScanNetPretrainObj", "train")):
        jc, tc = _cfgs(root, materialized_root=str(base / "jax"))
        tc.data.args.materialized_root = str(base / "torch")
        out[name, split] = (je(jc, name, split), te(tc, name, split))
    return out


@pytest.mark.parametrize("name,split", [
    ("ScanNetSpatialRefer", "train"), ("ScanNetSpatialRefer", "val"),
    ("RScanSpatialRefer", "train"), ("ScanNetPretrainObj", "train")])
def test_materialized_store_matches_jax_file_by_file(stores, name, split):
    a, b = stores[name, split]
    assert a != b and b.parent.name == "torch"
    files = sorted(p.name for p in a.iterdir())
    assert files == sorted(p.name for p in b.iterdir()) and len(files) > 9
    for f in files:
        if f.endswith(".npy"):
            _same(np.load(a / f, allow_pickle=True),
                  np.load(b / f, allow_pickle=True), f)
        else:
            assert json.loads((a / f).read_text()) == json.loads(
                (b / f).read_text()), f


@pytest.mark.parametrize("n_threads", [1, 2])
def test_materialized_batches_match_jax(root, stores, n_threads):
    from sceneverse_tpu.data.materialized import MaterializedBatchLoader as JL
    from sceneverse_tpu_torch.data.materialized import \
        MaterializedBatchLoader as TL

    jc, tc = _cfgs(root, materialized="fast", max_obj_len=5)
    keys = [("ScanNetSpatialRefer", "train"), ("RScanSpatialRefer", "train")]
    jl = JL(jc, [stores[k][0] for k in keys], n_threads=n_threads)
    tl = TL(tc, [stores[k][1] for k in keys], n_threads=n_threads)
    assert len(tl) == len(jl) > 2
    for epoch in range(2):
        for b, (want, got) in enumerate(zip(jl, tl)):
            _same({k: v.copy() for k, v in want.items()}, got,
                  f"epoch {epoch} batch {b}")
            if b == 2:
                break


@pytest.mark.parametrize("split", ["train", "val"])
def test_materialized_items_match_jax(root, stores, split):
    from sceneverse_tpu.data.materialized import MaterializedSpatialRefer as J
    from sceneverse_tpu_torch.data.materialized import \
        MaterializedSpatialRefer as T

    jc, tc = _cfgs(root, materialized=True)
    store = stores["ScanNetSpatialRefer", split]
    _items(J(jc, split, store_path=store[0]),
           T(tc, split, store_path=store[1]))


def test_materialized_cli_builds_the_stores(root, tmp_path):
    from sceneverse_tpu_torch.data.materialized import main

    over = [f"data.{k}={root}" for k in (
        "scan_family_base", "rscan_base", "arkitscene_base",
        "multiscan_base", "hm_base")] + [
        "data.args.pc_type=gt", f"data.args.materialized_root={tmp_path}"]
    main(["--config", ALL_PRETRAIN, "--splits", "train,val", *over])
    got = sorted(p.name for p in tmp_path.iterdir())
    assert got == sorted([f"{f}SpatialRefer_train" for f in (
        "ScanNet", "ARKitScene", "MultiScan", "HM", "RScan")]
        + ["ScanNetSpatialRefer_val"])


# ------------------------------------------------------------------ loaders
def test_collates_and_concat_match_jax(root):
    jc, tc = _cfgs(root)
    jds = [jbuild.DATASET_REGISTRY.get(n)(jc, "val")
           for n in ("ScanNetSpatialRefer", "HMSpatialRefer")]
    tds = [tbuild.DATASET_REGISTRY.get(n)(tc, "val")
           for n in ("ScanNetSpatialRefer", "HMSpatialRefer")]
    jcat, tcat = jbuild.ConcatDataset(jds), tbuild.ConcatDataset(tds)
    assert len(tcat) == len(jcat)
    idx = [0, len(jds[0]) - 1, len(jds[0]), len(jcat) - 1]
    jitems, titems = [jcat[i] for i in idx], [tcat[i] for i in idx]
    _same(jitems, titems)
    _same(jbuild.numpy_collate(jitems), tbuild.numpy_collate(titems))
    _same(jbuild.shm_collate(jitems), tbuild.shm_collate(titems))


def test_loaders_with_workers_match(root):
    """Val: two spawn-context workers give the single process's batches
    (per-item seeds); train: the port's two workers give JAX's two workers'
    batches (both seed each worker's numpy from the loader's generator)."""
    jc, tc = _cfgs(root)
    one = list(tbuild.build_dataloader(tc, "val"))
    _same([{k: v for k, v in b.items()} for b in
           jbuild.build_dataloader(jc, "val")], one)
    jc, tc = _cfgs(root)
    jc.dataloader.num_workers = tc.dataloader.num_workers = 2
    two = list(tbuild.build_dataloader(tc, "val"))
    assert len(two) == len(one)
    for a, b in zip(one, two):
        assert set(a) == set(b)
        for k, v in a.items():
            w = b[k]
            if isinstance(v, np.ndarray):
                assert torch.is_tensor(w), k
                w = w.numpy()
            _same(v, w, k)
    train = tbuild.build_dataloader(tc, "train")
    assert train.multiprocessing_context.get_start_method() == "spawn"
    got = list(train)
    want = list(jbuild.build_dataloader(jc, "train"))
    assert len(got) == len(want) > 2
    for a, b in zip(want, got):
        _same({k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                   and v.dtype != object else v) for k, v in a.items()}, b)

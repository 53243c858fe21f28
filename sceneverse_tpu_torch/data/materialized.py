"""Offline-materialized input pipeline (SURVEY §7 design stance; VERDICT r2
item 1).

The live path (reference data/datasets/base.py:324-512,697-740 ported to
``datasets/base.py``) re-does per-item work every epoch that is actually
static: loading per-scan ``.pth`` clouds, splitting instances, parsing
annotation JSON, and WordPiece tokenization. On modest hosts that caps the
feed rate below the chip rate (BASELINE.md "Input pipeline").

This module splits the pipeline at the static/random boundary:

  * :func:`materialize_dataset` runs the static work ONCE and writes a flat,
    mmap-able store per (family, split): a packed (N, 6) float32 point array
    with per-object offsets, per-scan object tables, raw token ids, and the
    per-item annotation columns.
  * :class:`MaterializedSpatialRefer` / :class:`MaterializedPretrainObj` are
    drop-in ScanBase datasets backed by the store. They inherit the live
    ``_getitem_*`` builders unchanged (object point clouds become zero-copy
    views into the mmap), so per-item outputs are bit-identical to the live
    datasets — the equivalence test in ``tests/test_materialized.py`` asserts
    it. Startup cost drops from "torch.load every scan" to "mmap open".
  * :class:`MaterializedBatchLoader` is the production train path: it fuses
    dataset + MaskDatasetWrapper + collate into whole-batch assembly — the
    native C++ ``assemble_objects`` scatter-writes subsampled/normalized
    objects straight into the final (B, O, P, C) batch buffer (no per-item
    dicts, no pad copies, no collate, no tokenizer), and the text/masking
    work is vectorized over the batch. Per-epoch randomness (crop, subsample,
    rotation, BERT masking) is preserved; the RNG streams differ from the
    live path (same distributions), like the existing native loader.

Store layout (directory of .npy files + meta.json):
  points.npy      (N, C) f32      all object points, scan-major, mmap'd
  obj_off.npy     (n_obj+1,) i64  prefix offsets into points
  obj_label.npy   (n_obj,) i32    int category ids
  obj_inst.npy    (n_obj,) i32    instance ids (gt branch)
  scan_off.npy    (n_scan+1,) i64 prefix offsets into the object table
  item_*.npy                      per-item columns (SpatialRefer stores only)
  sent_tok.npy / sent_off.npy     ragged raw sentence token ids (no specials)
  cap_tok.npy / cap_off.npy / scan_cap_off.npy   ragged scene-caption tokens
  meta.json                       int2cat, id_to_scannetid, fingerprint, ...
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter
from pathlib import Path

import numpy as np

from sceneverse_tpu_torch.data.build import DATASET_REGISTRY
from sceneverse_tpu_torch.data.datasets.base import ScanBase
from sceneverse_tpu_torch.data.tokenizer import get_tokenizer
from sceneverse_tpu_torch.parallel import mesh

STORE_VERSION = 3


# --------------------------------------------------------------------- writer
def _fingerprint(cfg, name, split) -> str:
    """Content fingerprint: anything that changes WHAT the store contains
    (not how it is consumed — max_obj_len / num_points / max_seq_len are
    per-run knobs applied at assembly time)."""
    split_cfg = cfg.data[name][split] if name in cfg.data else {}
    payload = json.dumps({
        "v": STORE_VERSION, "name": name, "split": split,
        "sources": _cfg_container(split_cfg),
        "pc_type": cfg.data.args.pc_type,
        "use_scene_cap": bool(cfg.data.args.get("use_scene_cap", False)),
        "subset_ratio": cfg.data.args.get("subset_ratio", 0),
        "debug": [bool(cfg.select("debug.flag", False)),
                  int(cfg.select("debug.debug_size", -1))],
    }, sort_keys=True, default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def _cfg_container(node):
    if hasattr(node, "to_dict"):
        return node.to_dict()
    if hasattr(node, "items"):
        return {k: _cfg_container(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_cfg_container(v) for v in node]
    return node


def materialize_dataset(ds: ScanBase, out_dir, fingerprint="") -> Path:
    """Write the flat store for a live family dataset (unwrapped)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tok = get_tokenizer(ds.cfg)

    scan_ids = sorted(ds.scan_data.keys())
    scan_index = {s: i for i, s in enumerate(scan_ids)}

    # ---- scan/object tables + packed points
    parts, obj_off, obj_label, obj_inst, scan_off = [], [0], [], [], [0]
    for sid in scan_ids:
        entry = ds.scan_data[sid]
        for pc in entry["obj_pcds"]:
            pc = np.ascontiguousarray(pc, np.float32)
            parts.append(pc)
            obj_off.append(obj_off[-1] + len(pc))
        obj_label.extend(entry["inst_labels"])
        obj_inst.extend(entry.get("inst_ids", [-1] * len(entry["obj_pcds"])))
        scan_off.append(scan_off[-1] + len(entry["obj_pcds"]))
    points = (np.concatenate(parts, axis=0) if parts
              else np.zeros((0, 6), np.float32))
    # per-object full-cloud stats [mean(3), min(3), max(3)] — the fast path
    # derives obj_locs/obj_boxes from these in closed form (exact under the
    # axis-aligned 90-degree rotation augmentation)
    stats = np.zeros((len(parts), 9), np.float32)
    for i, pc in enumerate(parts):
        xyz = pc[:, :3]
        stats[i, 0:3] = xyz.mean(0)
        stats[i, 3:6] = xyz.min(0)
        stats[i, 6:9] = xyz.max(0)
    np.save(out / "obj_stats.npy", stats)
    np.save(out / "points.npy", points)
    np.save(out / "obj_off.npy", np.asarray(obj_off, np.int64))
    np.save(out / "obj_label.npy", np.asarray(obj_label, np.int32))
    np.save(out / "obj_inst.npy", np.asarray(obj_inst, np.int32))
    np.save(out / "scan_off.npy", np.asarray(scan_off, np.int64))
    np.save(out / "scan_ids.npy", np.asarray(scan_ids))

    # ---- scene captions (ragged strings + ragged token ids)
    cap_strs, cap_tok, cap_tok_off, scan_cap_off = [], [], [0], [0]
    caps_map = getattr(ds, "scene_caps", None) or {}
    for sid in scan_ids:
        caps = caps_map.get(sid)
        caps = caps["captions"] if caps is not None else []
        for c in caps:
            cap_strs.append(c)
            ids = tok.tokenize_to_ids(c)
            cap_tok.extend(ids)
            cap_tok_off.append(len(cap_tok))
        scan_cap_off.append(scan_cap_off[-1] + len(caps))
    np.save(out / "cap_str.npy", np.asarray(cap_strs, dtype=object),
            allow_pickle=True)
    np.save(out / "cap_tok.npy", np.asarray(cap_tok, np.int32))
    np.save(out / "cap_off.npy", np.asarray(cap_tok_off, np.int64))
    np.save(out / "scan_cap_off.npy", np.asarray(scan_cap_off, np.int64))

    # ---- per-item columns (SpatialRefer only)
    lang = getattr(ds, "lang_data", None)
    n_items = 0
    if lang is not None:
        n_items = len(lang)
        item_scan = np.asarray([scan_index[it["scan_id"]] for it in lang],
                               np.int32)
        item_tgt_inst = np.asarray([int(it["target_id"]) for it in lang],
                                   np.int32)
        sentences = [it["utterance"] for it in lang]
        sent_tok, sent_off = [], [0]
        for s in sentences:
            ids = tok.tokenize_to_ids(s)
            sent_tok.extend(ids)
            sent_off.append(len(sent_tok))
        np.save(out / "item_scan.npy", item_scan)
        np.save(out / "item_tgt_inst.npy", item_tgt_inst)
        np.save(out / "item_id.npy",
                np.asarray([it["item_id"] for it in lang], dtype=object),
                allow_pickle=True)
        np.save(out / "item_type.npy",
                np.asarray([it["instance_type"] for it in lang],
                           dtype=object), allow_pickle=True)
        np.save(out / "item_sentence.npy",
                np.asarray(sentences, dtype=object), allow_pickle=True)
        np.save(out / "sent_tok.npy", np.asarray(sent_tok, np.int32))
        np.save(out / "sent_off.npy", np.asarray(sent_off, np.int64))

    meta = {
        "version": STORE_VERSION,
        "fingerprint": fingerprint,
        "family": type(ds).__name__,
        "source": getattr(ds, "SOURCE", "scannet"),
        "split": ds.split,
        "n_scans": len(scan_ids),
        "n_items": n_items,
        "channels": int(points.shape[1]) if points.size else 6,
        "int2cat": ds.int2cat,
        # {raw_id: scannetid} with consecutive keys 0..N-1 -> index list
        "id_to_scannetid": [
            int(ds.label_converter.id_to_scannetid[i])
            for i in range(len(ds.label_converter.id_to_scannetid))
        ],
        "has_lang": lang is not None,
        "vocab_size": tok.vocab_size,
        "cls_id": tok.cls_token_id, "sep_id": tok.sep_token_id,
        "pad_id": tok.pad_token_id, "mask_id": tok.mask_token_id,
    }
    (out / "meta.json").write_text(json.dumps(meta))
    return out


def ensure_materialized(cfg, name: str, split: str) -> Path:
    """Build (or reuse) the store for one registered family dataset."""
    fp = _fingerprint(cfg, name, split)
    root = cfg.data.args.get("materialized_root") or os.path.join(
        str(cfg.data.scan_family_base), "materialized")
    out = Path(root) / f"{name}_{split}"
    meta_path = out / "meta.json"
    if meta_path.exists():
        try:
            meta = json.loads(meta_path.read_text())
            if meta.get("fingerprint") == fp and \
                    meta.get("version") == STORE_VERSION:
                return out
        except (json.JSONDecodeError, OSError):
            pass
    live = DATASET_REGISTRY.get(name)(cfg, split)
    return materialize_dataset(live, out, fingerprint=fp)


# --------------------------------------------------------------------- reader
class _LabelConverterShim:
    def __init__(self, id_to_scannetid):
        self.id_to_scannetid = id_to_scannetid


class MaterializedStore:
    """mmap view over a materialized directory."""

    def __init__(self, path):
        self.path = Path(path)
        self.meta = json.loads((self.path / "meta.json").read_text())
        self.points = np.load(self.path / "points.npy", mmap_mode="r")
        self.obj_off = np.load(self.path / "obj_off.npy")
        self.obj_stats = np.load(self.path / "obj_stats.npy")
        self.obj_label = np.load(self.path / "obj_label.npy")
        self.obj_inst = np.load(self.path / "obj_inst.npy")
        self.scan_off = np.load(self.path / "scan_off.npy")
        self.scan_ids = [str(s) for s in np.load(self.path / "scan_ids.npy")]
        self.cap_str = np.load(self.path / "cap_str.npy", allow_pickle=True)
        self.cap_tok = np.load(self.path / "cap_tok.npy")
        self.cap_off = np.load(self.path / "cap_off.npy")
        self.scan_cap_off = np.load(self.path / "scan_cap_off.npy")
        if self.meta["has_lang"]:
            self.item_scan = np.load(self.path / "item_scan.npy")
            self.item_tgt_inst = np.load(self.path / "item_tgt_inst.npy")
            self.item_id = np.load(self.path / "item_id.npy",
                                   allow_pickle=True)
            self.item_type = np.load(self.path / "item_type.npy",
                                     allow_pickle=True)
            self.item_sentence = np.load(self.path / "item_sentence.npy",
                                         allow_pickle=True)
            self.sent_tok = np.load(self.path / "sent_tok.npy")
            self.sent_off = np.load(self.path / "sent_off.npy")

    def scan_objects(self, scan_idx: int):
        """(global object index range) for one scan."""
        return int(self.scan_off[scan_idx]), int(self.scan_off[scan_idx + 1])

    def object_view(self, obj_idx: int) -> np.ndarray:
        return self.points[self.obj_off[obj_idx]:self.obj_off[obj_idx + 1]]

    def scan_caps(self, scan_idx: int):
        lo, hi = int(self.scan_cap_off[scan_idx]), int(
            self.scan_cap_off[scan_idx + 1])
        return lo, hi


def _store_backed_scan_data(store: MaterializedStore, id_to_scannetid):
    """Reconstruct the ScanBase.scan_data mapping with zero-copy mmap views
    in place of loaded arrays."""
    scan_data = {}
    for si, sid in enumerate(store.scan_ids):
        lo, hi = store.scan_objects(si)
        labels = [int(l) for l in store.obj_label[lo:hi]]
        scan_data[sid] = {
            "obj_pcds": [store.object_view(o) for o in range(lo, hi)],
            "inst_labels": labels,
            "inst_ids": [int(i) for i in store.obj_inst[lo:hi]],
            "label_count": Counter(labels),
            "label_count_multi": Counter(
                id_to_scannetid[l] for l in labels),
        }
    return scan_data


class MaterializedSpatialRefer(ScanBase):
    """Drop-in for the <Family>SpatialRefer datasets, store-backed.

    Inherits the live ``_getitem_refer`` unchanged — per-item outputs are
    bit-identical to the live dataset for the same index and RNG state
    (asserted in tests/test_materialized.py)."""

    def __init__(self, cfg, split, store_path=None, name=None):
        super().__init__(cfg, split)
        name = name or "ScanNetSpatialRefer"
        store_path = store_path or ensure_materialized(cfg, name, split)
        self.store = MaterializedStore(store_path)
        meta = self.store.meta
        self.SOURCE = meta["source"]
        self.int2cat = list(meta["int2cat"])
        self.cat2int = {w: i for i, w in enumerate(self.int2cat)}
        self.label_converter = _LabelConverterShim(meta["id_to_scannetid"])
        self.max_obj_len = cfg.data.args.max_obj_len - 1  # SpatialRefer quirk
        self.filter_lang = cfg.data.args.filter_lang
        self.scan_ids = list(self.store.scan_ids)
        self.scan_data = _store_backed_scan_data(
            self.store, meta["id_to_scannetid"])
        self.lang_data = [
            {"item_id": self.store.item_id[i],
             "scan_id": self.scan_ids[int(self.store.item_scan[i])],
             "target_id": int(self.store.item_tgt_inst[i]),
             "instance_type": self.store.item_type[i],
             "utterance": self.store.item_sentence[i]}
            for i in range(self.store.meta["n_items"])
        ]
        if self.use_scene_cap:
            self.scene_caps = {}
            for si, sid in enumerate(self.scan_ids):
                lo, hi = self.store.scan_caps(si)
                if hi > lo:
                    self.scene_caps[sid] = {
                        "captions": [str(c) for c in self.store.cap_str[lo:hi]]
                    }
        else:
            self.scene_caps = None

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        data_dict = self._getitem_refer(index)
        data_dict["source"] = self.SOURCE
        return data_dict


class MaterializedPretrainObj(ScanBase):
    """Drop-in for the <Family>PretrainObj datasets, store-backed."""

    def __init__(self, cfg, split, store_path=None, name=None):
        super().__init__(cfg, split)
        name = name or "ScanNetPretrainObj"
        store_path = store_path or ensure_materialized(cfg, name, split)
        self.store = MaterializedStore(store_path)
        meta = self.store.meta
        self.SOURCE = meta["source"]
        self.int2cat = list(meta["int2cat"])
        self.cat2int = {w: i for i, w in enumerate(self.int2cat)}
        self.label_converter = _LabelConverterShim(meta["id_to_scannetid"])
        self.scan_ids = list(self.store.scan_ids)
        self.scan_data = _store_backed_scan_data(
            self.store, meta["id_to_scannetid"])

    def __len__(self):
        return len(self.scan_ids)

    def __getitem__(self, index):
        data_dict = self._getitem_obj_pretrain(index)
        data_dict["source"] = self.SOURCE
        return data_dict


# ------------------------------------------------------------ fast batch path
class MaterializedBatchLoader:
    """Fused dataset + MaskDatasetWrapper + collate for the train loop.

    Yields batches with exactly the MaskDatasetWrapper key schema
    (datasets/dataset_wrapper.py key_list); padding semantics preserved
    (obj_fts 1.0 / obj_locs 0.0 / obj_labels -100). The per-object
    subsample/normalize runs in the native C++ ``assemble_objects`` directly
    into the batch buffer; set ``n_threads`` (default
    ``cfg.dataloader.num_workers`` or 1) to scale across host cores without
    worker processes or pickling.
    """

    def __init__(self, cfg, stores, seed=None, n_threads=None):
        self.cfg = cfg
        self.stores = [MaterializedStore(s) if not isinstance(
            s, MaterializedStore) else s for s in stores]
        args = cfg.data.args
        if args.get("filter_lang", False):
            raise NotImplementedError(
                "materialized fast path: filter_lang selection is per-sentence"
                " — use the per-item materialized dataset instead")
        self.batch_size = int(cfg.dataloader.batchsize)
        # SpatialRefer quirk: datasets crop to max_obj_len-1 objects, the
        # wrapper pads batches to max_obj_len (reference scannet.py:61 vs
        # dataset_wrapper.py pad)
        self.max_obj_len = int(args.max_obj_len)
        self.crop_len = self.max_obj_len - 1
        self.num_points = int(args.num_points)
        self.max_seq_len = int(args.max_seq_len)
        self.txt_mask_ratio = float(args.txt_mask_ratio)
        self.pc_mask_ratio = float(args.pc_mask_ratio)
        self.rot_aug = bool(args.get("rot_aug", False))
        self.use_scene_cap = bool(args.get("use_scene_cap", False))
        self.max_cap_len = int(args.get("max_scene_cap_len",
                                        self.max_seq_len))
        self.n_threads = int(n_threads if n_threads is not None
                             else (cfg.dataloader.get("num_workers") or 1)) or 1
        self.seed = int(cfg.get("rng_seed", 42) if seed is None else seed)
        self.epoch = 0

        meta = self.stores[0].meta
        self.vocab_size = meta["vocab_size"]
        self.cls_id, self.sep_id = meta["cls_id"], meta["sep_id"]
        self.pad_id, self.mask_id = meta["pad_id"], meta["mask_id"]

        # Precompute per-store foreground object tables + per-item views.
        self._prep = []
        offset = 0
        for st in self.stores:
            bg = {i for i, c in enumerate(st.meta["int2cat"])
                  if c in ("wall", "floor", "ceiling")}
            labels = np.asarray(st.obj_label)
            fg_mask = ~np.isin(labels, sorted(bg))
            # per-scan foreground object global indices (ragged)
            per_scan_fg = [
                np.flatnonzero(fg_mask[st.scan_off[s]:st.scan_off[s + 1]])
                + st.scan_off[s]
                for s in range(len(st.scan_ids))
            ]
            # target position: global object index by (scan, instance id).
            # Vectorized via a stable sort on the composite (scan, inst) key
            # — the per-item flatnonzero loop this replaces was O(items x
            # objs/scan) in Python and dominated loader startup at the
            # production item count (2.5M items, bench_scale.py drill).
            # Stable order => searchsorted lands on the FIRST matching
            # object, preserving the reference's first-match semantics.
            inst = np.asarray(st.obj_inst, np.int64)
            n_items = st.meta["n_items"]
            if inst.size and n_items:
                obj_scan = np.repeat(
                    np.arange(len(st.scan_ids), dtype=np.int64),
                    np.diff(np.asarray(st.scan_off)))
                base = int(inst.min())
                width = int(inst.max()) - base + 2
                key = obj_scan * width + (inst - base)
                order = np.argsort(key, kind="stable")
                skey = key[order]
                t = st.item_tgt_inst.astype(np.int64)
                in_range = (t >= base) & (t - base < width)
                ikey = st.item_scan.astype(np.int64) * width + (t - base)
                pos = np.searchsorted(skey, ikey)
                pos_c = np.minimum(pos, len(skey) - 1)
                found = in_range & (skey[pos_c] == ikey)
                tgt_obj = np.where(found, order[pos_c], -1).astype(np.int64)
            else:
                tgt_obj = np.full(n_items, -1, np.int64)
            self._prep.append({
                "store": st, "per_scan_fg": per_scan_fg, "tgt_obj": tgt_obj,
                "item_base": offset,
            })
            offset += st.meta["n_items"]
        self.n_items = offset
        self._store_of_item = np.concatenate([
            np.full(p["store"].meta["n_items"], k, np.int32)
            for k, p in enumerate(self._prep)
        ]) if self._prep else np.zeros(0, np.int32)

    def __len__(self):
        return self.n_items // self.batch_size  # drop_last, like the trainer

    # -- helpers -----------------------------------------------------------
    def _encode_row(self, ids, max_len, out_row, mask_row):
        ids = ids[: max_len - 2]
        n = len(ids) + 2
        out_row[0] = self.cls_id
        out_row[1:n - 1] = ids
        out_row[n - 1] = self.sep_id
        mask_row[:n] = 1

    def _ring_buffer(self, B, O, P, C):
        """Persistent double-buffered obj_fts (the 120 MB np.full prefill per
        batch measured ~30% of assembly time). A yielded batch stays valid
        until the SECOND next(); the trainer is done with a batch (copied to
        the card, or on the CPU used in place) before it asks for the next.
        Only padding slots that held data last time get re-filled."""
        if not hasattr(self, "_ring") or self._ring[0][0].shape != (B * O, P, C):
            self._ring = [
                (np.full((B * O, P, C), 1.0, np.float32),
                 np.zeros(B * O, bool))
                for _ in range(2)
            ]
            self._ring_i = 0
        self._ring_i ^= 1
        buf, filled = self._ring[self._ring_i]
        return buf, filled

    def _assemble(self, idxs, rng):
        B, O, P = len(idxs), self.max_obj_len, self.num_points
        C = self.stores[0].meta["channels"]
        obj_fts, fts_filled = self._ring_buffer(B, O, P, C)
        obj_locs = np.zeros((B * O, 6), np.float32)
        obj_boxes = np.zeros((B * O, 6), np.float32)
        obj_labels = np.full((B, O), -100, np.int64)
        tgt_object_id = np.zeros((B, 1), np.int64)
        n_objs = np.zeros(B, np.int64)
        txt_ids = np.full((B, self.max_seq_len), self.pad_id, np.int64)
        txt_masks = np.zeros((B, self.max_seq_len), np.int64)
        cap_ids = np.full((B, self.max_cap_len), self.pad_id, np.int64)
        cap_masks = np.zeros((B, self.max_cap_len), np.int64)

        sel_obj, sel_slot, sel_item, sel_store = [], [], [], []
        item_rot = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        thetas = [0.0, np.pi / 2, np.pi, np.pi * 1.5]
        for b, gidx in enumerate(idxs):
            k_store = int(self._store_of_item[gidx])
            p = self._prep[k_store]
            st = p["store"]
            i = int(gidx) - p["item_base"]
            scan = int(st.item_scan[i])
            fg = p["per_scan_fg"][scan]
            tgt = int(p["tgt_obj"][i])
            if tgt >= 0 and tgt not in fg:
                # bg-labeled target: live _select_foreground appends it last
                fg = np.concatenate([fg, [tgt]])
            # target-first crop to max_obj_len (live _crop_objects semantics:
            # keep target, then same-label objects in index order, then a
            # random fill from the rest)
            K = self.crop_len
            if len(fg) > K:
                tgt_label = int(st.obj_label[tgt]) if tgt >= 0 else -1
                labels = st.obj_label[fg]
                same = fg[(labels == tgt_label) & (fg != tgt)]
                other = fg[(labels != tgt_label) & (fg != tgt)]
                keep = [tgt] if tgt >= 0 else []
                keep.extend(same[: K - len(keep)])
                if len(keep) < K:
                    fill = rng.permutation(other)[: K - len(keep)]
                    keep.extend(fill)
                sel = np.asarray(keep[:K], np.int64)
            else:
                sel = np.asarray(fg, np.int64)
            n = len(sel)
            n_objs[b] = n
            obj_labels[b, :n] = st.obj_label[sel]
            hit = np.flatnonzero(sel == tgt)
            tgt_object_id[b, 0] = int(hit[0]) if hit.size else n

            # 90-degree z-rotation augmentation (live build_rotate_mat
            # semantics on the train split)
            if self.rot_aug:
                th = thetas[int(rng.integers(4))]
                if th != 0.0:
                    c, s = np.cos(th), np.sin(th)
                    item_rot[b] = np.asarray(
                        [[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            base = b * O
            sel_obj.extend(sel)
            sel_slot.extend(range(base, base + n))
            sel_item.extend([b] * n)
            sel_store.extend([k_store] * n)

            # text: raw token slices -> [CLS] ids [SEP] pad
            s_lo, s_hi = int(st.sent_off[i]), int(st.sent_off[i + 1])
            sent = st.sent_tok[s_lo:s_hi]
            self._encode_row(sent, self.max_seq_len, txt_ids[b], txt_masks[b])
            if self.use_scene_cap:
                c_lo, c_hi = st.scan_caps(scan)
                if c_hi > c_lo:
                    k = c_lo + int(rng.integers(c_hi - c_lo))
                    cap = st.cap_tok[st.cap_off[k]:st.cap_off[k + 1]]
                else:
                    cap = self._default_cap_ids()
                merged = np.concatenate([cap, sent])
                self._encode_row(merged, self.max_cap_len, cap_ids[b],
                                 cap_masks[b])

        if sel_obj:
            from sceneverse_tpu_torch.data.native import sample_objects_native

            obj = np.asarray(sel_obj, np.int64)
            slot = np.asarray(sel_slot, np.int64)
            item = np.asarray(sel_item, np.int64)
            store_of = np.asarray(sel_store, np.int32)
            rots = item_rot[item]  # (n_sel, 3, 3)

            # locs/boxes in closed form from the offline per-object stats:
            # mean rotates exactly; the axis-aligned bbox maps exactly under
            # the 90-degree z rotations (corners permute/negate)
            for k in range(len(self.stores)):
                st = self.stores[k]
                rows = np.flatnonzero(store_of == k) \
                    if len(self.stores) > 1 else slice(None)
                if len(self.stores) > 1 and rows.size == 0:
                    continue
                o = obj[rows]
                stats = st.obj_stats[o]  # (m, 9): mean, mn, mx
                R = rots[rows]
                mean = np.einsum("mij,mj->mi", R, stats[:, 0:3])
                c1 = np.einsum("mij,mj->mi", R, stats[:, 3:6])
                c2 = np.einsum("mij,mj->mi", R, stats[:, 6:9])
                mn = np.minimum(c1, c2)
                mx = np.maximum(c1, c2)
                s = slot[rows]
                obj_locs[s, 0:3] = mean
                obj_locs[s, 3:6] = mx - mn
                obj_boxes[s, 0:3] = (mx + mn) * 0.5
                obj_boxes[s, 3:6] = mx - mn
                sample_objects_native(
                    self._points(k), st.obj_off[o],
                    st.obj_off[o + 1] - st.obj_off[o], s, P, obj_fts,
                    rots=np.ascontiguousarray(R.reshape(-1, 9)),
                    seed=int(rng.integers(2 ** 31)),
                    n_threads=self.n_threads)

            # re-pad slots dirtied by the PREVIOUS use of this ring buffer
            now = np.zeros(B * O, bool)
            now[slot] = True
            stale = np.flatnonzero(fts_filled & ~now)
            if stale.size:
                obj_fts[stale] = 1.0
            fts_filled[:] = now

        # BERT 15% / 80-10-10 masking, vectorized over the batch
        prob = rng.random(txt_ids.shape)
        pick = (prob < self.txt_mask_ratio) & (txt_masks != 0)
        sub = np.where(pick, prob / max(self.txt_mask_ratio, 1e-9), 1.0)
        masked = txt_ids.copy()
        masked[pick & (sub < 0.8)] = self.mask_id
        rand_ids = rng.integers(0, self.vocab_size, size=txt_ids.shape)
        swap = pick & (sub >= 0.8) & (sub < 0.9)
        masked[swap] = rand_ids[swap]
        lm_labels = np.where(pick, txt_ids, -1).astype(np.int64)

        obj_masks = np.arange(O)[None, :] < n_objs[:, None]
        drop = rng.random((B, O)) < self.pc_mask_ratio
        obj_sem_masks = (obj_masks & ~drop).astype(np.int64)

        batch = {
            "txt_ids": masked, "txt_masks": txt_masks,
            "masked_lm_labels": lm_labels,
            "obj_masks": obj_masks,
            "obj_fts": obj_fts.reshape(B, O, P, C),
            "obj_locs": obj_locs.reshape(B, O, 6),
            "obj_labels": obj_labels,
            "obj_sem_masks": obj_sem_masks,
            "tgt_object_id": tgt_object_id,
        }
        if self.use_scene_cap:
            batch["scene_txt_ids"] = cap_ids
            batch["scene_txt_masks"] = cap_masks
        return batch

    def _default_cap_ids(self):
        if not hasattr(self, "_default_cap"):
            self._default_cap = np.asarray(
                get_tokenizer(self.cfg).tokenize_to_ids("This is a scene."),
                np.int32)
        return self._default_cap

    def _points(self, k):
        """Contiguous float32 view of store k's point table. The mmap array
        is already C-contiguous float32, so this is zero-copy (asarray keeps
        the mmap backing; the native op reads straight from page cache)."""
        pts = np.asarray(self.stores[k].points)
        assert pts.dtype == np.float32 and pts.flags.c_contiguous
        return pts

    def __iter__(self):
        """Global batches; over a world of N processes each rank builds the
        whole global batch, as every JAX process does (the crops' random
        fills draw from one stream in item order), and keeps its dp
        shard's ``mesh.rank_rows``."""
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        order = rng.permutation(self.n_items)
        rows = mesh.rank_rows(self.batch_size, mesh.dp_world(),
                              mesh.dp_rank())
        for b in range(len(self)):
            batch = self._assemble(
                order[b * self.batch_size:(b + 1) * self.batch_size], rng)
            yield batch if mesh.dp_world() == 1 else {
                k: v[rows] for k, v in batch.items()}


def build_materialized_train_loader(cfg):
    """Train-loader branch for ``data.args.materialized: true``
    (wired in data/build.py). Materializes each train family on first use."""
    names = cfg.data.get("train")
    if isinstance(names, str):
        names = [names]
    wrapper = cfg.data_wrapper["train"] if "data_wrapper" in cfg else None
    if wrapper != "MaskDatasetWrapper":
        raise NotImplementedError(
            f"materialized fast path covers the MaskDatasetWrapper train "
            f"schema; got wrapper {wrapper!r}")
    import sceneverse_tpu_torch.data.datasets.families  # noqa: F401 (registry)

    # rank 0 writes a missing store; the others read it after the barrier
    if mesh.rank() == 0:
        stores = [ensure_materialized(cfg, n, "train") for n in names]
    mesh.barrier()
    if mesh.rank() != 0:
        stores = [ensure_materialized(cfg, n, "train") for n in names]
    return MaterializedBatchLoader(cfg, stores)


def main(argv=None):
    """CLI: python -m sceneverse_tpu_torch.data.materialized --config <yaml>
    [--splits train,val] — pre-build the stores for a config's datasets."""
    import argparse

    from sceneverse_tpu_torch.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--splits", default="train,val")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    import sceneverse_tpu_torch.data.datasets.families  # noqa: F401

    for split in args.splits.split(","):
        names = cfg.data.get(split)
        if isinstance(names, str):
            names = [names]
        for name in names or []:
            out = ensure_materialized(cfg, name, split)
            meta = json.loads((Path(out) / "meta.json").read_text())
            print(f"{name}/{split}: {meta['n_scans']} scans, "
                  f"{meta['n_items']} items -> {out}", flush=True)


if __name__ == "__main__":
    main()

"""The port's own copy of ``sceneverse_tpu/data/datasets/families.py``.

The 7 per-dataset families (reference data/datasets/{scannet,rscan,
arkitscene,multiscan,hm,procthor,s3d}.py — 14 registered classes that are
~identical 88-line shells differing only in base_dir config key and source
tag). Factored into one factory that registers the same class names.
"""

from __future__ import annotations

import collections

from sceneverse_tpu_torch.data.build import DATASET_REGISTRY
from sceneverse_tpu_torch.data.datasets.base import ScanBase


class _PretrainObjBase(ScanBase):
    """Object-classification pretraining dataset over whole scans
    (reference scannet.py ScanNetPretrainObj shape)."""

    BASE_DIR_KEY = "scan_family_base"
    SOURCE = "scannet"

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.base_dir = cfg.data[self.BASE_DIR_KEY]
        self.load_scene_pcds = cfg.data.args.get("load_scene_pcds", False)
        if self.load_scene_pcds:
            self.max_pcd_num_points = cfg.data.args.get("max_pcd_num_points")
            assert self.max_pcd_num_points is not None
        self.bg_points_num = cfg.data.args.get("bg_points_num", 1000)

        self.scan_ids = sorted(self._load_split(self.split))
        if self.debug and self.debug_size != -1:
            self.scan_ids = self.scan_ids[: self.debug_size]
        self.scan_data = self._load_scan(self.scan_ids)
        self.scan_ids = sorted(self.scan_data.keys())

    def __len__(self):
        return len(self.scan_ids)

    def __getitem__(self, index):
        data_dict = self._getitem_obj_pretrain(index)
        data_dict["source"] = self.SOURCE
        return data_dict


class _SpatialReferBase(ScanBase):
    """Referring-expression dataset (reference scannet.py ScanNetSpatialRefer
    shape): language-driven items over preloaded scans; builds the
    unique/multiple label-count lookups."""

    BASE_DIR_KEY = "scan_family_base"
    SOURCE = "scannet"

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.base_dir = cfg.data[self.BASE_DIR_KEY]
        self.max_obj_len = cfg.data.args.max_obj_len - 1
        self.filter_lang = cfg.data.args.filter_lang
        self.load_scene_pcds = cfg.data.args.get("load_scene_pcds", False)
        if self.load_scene_pcds:
            self.max_pcd_num_points = cfg.data.args.get("max_pcd_num_points")
            assert self.max_pcd_num_points is not None
        self.bg_points_num = cfg.data.args.get("bg_points_num", 1000)

        split_cfg = cfg.data[type(self).__name__][split]
        all_scan_ids = self._load_split(self.split)
        self.lang_data, self.scan_ids = self._load_lang(split_cfg, all_scan_ids)
        self.scan_data = self._load_scan(self.scan_ids)

        for scan_id in self.scan_ids:
            inst_labels = self.scan_data[scan_id]["inst_labels"]
            self.scan_data[scan_id]["label_count"] = collections.Counter(inst_labels)
            self.scan_data[scan_id]["label_count_multi"] = collections.Counter(
                self.label_converter.id_to_scannetid[l] for l in inst_labels
            )

    def __len__(self):
        return len(self.lang_data)

    def __getitem__(self, index):
        data_dict = self._getitem_refer(index)
        data_dict["source"] = self.SOURCE
        return data_dict


_FAMILIES = {
    # registry prefix -> (base_dir config key, source tag)
    "ScanNet": ("scan_family_base", "scannet"),
    "RScan": ("rscan_base", "rscan"),
    "ARKitScene": ("arkitscene_base", "arkitscene"),
    "MultiScan": ("multiscan_base", "multiscan"),
    "HM": ("hm_base", "hm3d"),
    "ProcThor": ("procthor_base", "procthor"),
    "S3D": ("s3d_base", "s3d"),
}

for prefix, (base_key, source) in _FAMILIES.items():
    for kind, base_cls in (("PretrainObj", _PretrainObjBase),
                           ("SpatialRefer", _SpatialReferBase)):
        name = f"{prefix}{kind}"
        cls = type(name, (base_cls,), {"BASE_DIR_KEY": base_key,
                                       "SOURCE": source,
                                       "__module__": __name__})
        # bind as a module attribute so instances pickle (spawn-context
        # DataLoader workers serialize the dataset object)
        globals()[name] = cls
        DATASET_REGISTRY.register(cls, name=name)

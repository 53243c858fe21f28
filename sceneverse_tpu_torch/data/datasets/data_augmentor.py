"""Config-driven augmentation queue (reference data/datasets/data_augmentor.py
:8-269), train-split only: the port's own copy of
``sceneverse_tpu/data/datasets/data_augmentor.py``.

Pipeline order preserved exactly: per object — flip, scale, subsample,
jitter, (record size), scene translation, per-obj translation — then the
batched scene rotation, then per-obj rotation / color jitter / point shuffle,
finally the optional object-order shuffle. Sizes are recorded BEFORE
translation (like the reference) so obj_locs sizes are pre-translation.
"""

from __future__ import annotations

import math

import numpy as np


def _euler_rot(cfg_rotation, rng):
    if cfg_rotation.get("axis_align"):
        angles = [0, math.pi / 2, math.pi, math.pi * 3 / 2]
        thetas = [rng.choice(angles) * cfg_rotation["value"][i] for i in range(3)]
    else:
        thetas = [
            (rng.rand() * 2 * math.pi - math.pi) * cfg_rotation["value"][i]
            for i in range(3)
        ]
    tx, ty, tz = thetas
    rx = np.array([[1, 0, 0],
                   [0, math.cos(tx), -math.sin(tx)],
                   [0, math.sin(tx), math.cos(tx)]])
    ry = np.array([[math.cos(ty), 0, math.sin(ty)],
                   [0, 1, 0],
                   [-math.sin(ty), 0, math.cos(ty)]])
    rz = np.array([[math.cos(tz), math.sin(tz), 0],
                   [-math.sin(tz), math.cos(tz), 0],
                   [0, 0, 1]])
    mats = [rx, ry, rz]
    if cfg_rotation.get("shuffle", False):
        rng.shuffle(mats)
    return mats[0] @ mats[1] @ mats[2]


class DataAugmentor:
    def __init__(self, cfg, split, **kwargs):
        self.aug_cfg = cfg
        self.queue = []
        if split == "train":
            for aug in cfg.aug_list:
                if aug in cfg:
                    self.queue.append((aug, cfg[aug]))

    # -------------------------------------------------------------- planning
    def _plan(self, obj_len, rng):
        plan = {k: None for k in (
            "scene_trans", "scene_flip", "scene_rot", "scene_scale", "rgb_delta",
            "obj_trans", "obj_rot", "obj_jitter", "pts_shuffle",
        )}
        plan["obj_order"] = list(np.arange(obj_len))
        for name, config in self.queue:
            getattr(self, name)(plan, config, rng)
        return plan

    def scene_aug(self, plan, config, rng):
        if _on(config.get("translation")) and _p(config.get("translation"), rng):
            plan["scene_trans"] = rng.randn(3) * np.asarray(config["translation"]["value"])
        if _on(config.get("scaling")) and _p(config.get("scaling"), rng):
            lo, hi = config["scaling"]["value"]
            plan["scene_scale"] = rng.rand() * (hi - lo) + lo
        if _on(config.get("flip")) and _p(config.get("flip"), rng):
            m = np.eye(3)
            flip_type = int(rng.choice(4))
            if flip_type in (0, 2):
                m[0][0] *= -1
            if flip_type in (1, 2):
                m[1][1] *= -1
            plan["scene_flip"] = m
        if _on(config.get("rotation")) and _p(config.get("rotation"), rng):
            plan["scene_rot"] = _euler_rot(config["rotation"], rng)
        if _on(config.get("color_jitter")):
            plan["rgb_delta"] = rng.randn(3) * 0.1
        if _on(config.get("order_shuffle")):
            plan["obj_order"] = rng.permutation(len(plan["obj_order"]))

    def obj_aug(self, plan, config, rng):
        obj_len = len(plan["obj_order"])
        trans, rots = [], []
        for _ in range(obj_len):
            n = r = None
            if _on(config.get("translation")) and _p(config.get("translation"), rng):
                n = rng.randn(3) * np.asarray(config["translation"]["value"])
            trans.append(n)
            if _on(config.get("rotation")) and _p(config.get("rotation"), rng):
                r = _euler_rot(config["rotation"], rng)
            rots.append(r)
        plan["obj_trans"] = trans
        plan["obj_rot"] = rots
        if _on(config.get("random_jitter")):
            plan["obj_jitter"] = config["random_jitter"]["value"]
        if _on(config.get("pts_shuffle")):
            plan["pts_shuffle"] = True

    # -------------------------------------------------------------- applying
    def forward(self, data_dict, rng=None):
        rng = rng or np.random
        obj_pcds = [np.array(pc, np.float32) for pc in data_dict["obj_pcds"]]
        num_points = data_dict["num_points"]
        plan = self._plan(len(obj_pcds), rng)

        sizes = []
        for i, pc in enumerate(obj_pcds):
            if plan["scene_flip"] is not None:
                pc[:, :3] = pc[:, :3] @ plan["scene_flip"]
            if plan["scene_scale"] is not None:
                c = pc[:, :3].mean(0)
                pc[:, :3] = (pc[:, :3] - c) * plan["scene_scale"] + c
            idxs = rng.choice(len(pc), size=num_points, replace=len(pc) < num_points)
            pc = pc[idxs]
            if plan["obj_jitter"] is not None:
                pc[:, :3] += (rng.randn(len(pc), 3) - 0.5) * plan["obj_jitter"]
            sizes.append(pc[:, :3].max(0) - pc[:, :3].min(0))
            if plan["scene_trans"] is not None:
                pc[:, :3] += plan["scene_trans"]
            if plan["obj_trans"] and plan["obj_trans"][i] is not None:
                pc[:, :3] += plan["obj_trans"][i]
            obj_pcds[i] = pc

        obj_pcds = np.stack(obj_pcds)  # (O, P, 6)
        bg_pcds = data_dict.get("bg_pcds")
        if plan["scene_rot"] is not None:
            obj_pcds[:, :, :3] = obj_pcds[:, :, :3] @ plan["scene_rot"]
            if bg_pcds is not None:
                bg_pcds = np.array(bg_pcds, np.float32)
                bg_pcds[:, :3] = bg_pcds[:, :3] @ plan["scene_rot"]

        for i in range(len(obj_pcds)):
            if plan["obj_rot"] and plan["obj_rot"][i] is not None:
                c = obj_pcds[i, :, :3].mean(0)
                obj_pcds[i, :, :3] = (obj_pcds[i, :, :3] - c) @ plan["obj_rot"][i] + c
            if plan["rgb_delta"] is not None:
                obj_pcds[i, :, 3:] += plan["rgb_delta"]
            if plan["pts_shuffle"]:
                obj_pcds[i] = obj_pcds[i][rng.permutation(num_points)]

        out = dict(data_dict)
        out["obj_pcds"] = obj_pcds
        out["obj_sizes"] = sizes
        out["obj_order"] = plan["obj_order"]
        if bg_pcds is not None:
            out["bg_pcds"] = bg_pcds
        return out


def _on(key):
    """reference check_key (:226-238)."""
    if key is None:
        return False
    if isinstance(key, bool):
        return key
    if isinstance(key, dict):
        return key.get("enabled", True)
    return True


def _p(key, rng):
    """reference check_p (:240-242)."""
    return (not isinstance(key, dict)) or ("p" not in key) or (rng.rand() < key["p"])

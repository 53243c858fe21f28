"""Object graph node, the port's own copy of
``sceneverse_tpu/preprocess/ssg/objnode.py`` (reference
preprocess/ssg/ssg_data/script/ObjNode.py):
axis-aligned box geometry derived from (position, size). Polygon tests use
plain numpy on the axis-aligned rect (the reference used shapely, which is
unnecessary for AABBs)."""

from __future__ import annotations

import numpy as np


class ObjNode:
    def __init__(self, id=None, label=None, position=None, size=None,
                 children=None, room_id=None, dataset="scannet"):
        self.id = id
        self.label = label
        self.size = np.asarray(size, np.float64)
        self.position = np.asarray(position, np.float64)
        self.children = children if children is not None else []
        self.room_id = room_id
        half = self.size / 2
        self.x_min, self.y_min, self.z_min = self.position - half
        self.x_max, self.y_max, self.z_max = self.position + half
        # reference quirk: 'bottom_rect' carries z_max, 'top_rect' z_min
        self.bottom_rect = np.array([
            [self.x_min, self.y_min, self.z_max],
            [self.x_max, self.y_min, self.z_max],
            [self.x_max, self.y_max, self.z_max],
            [self.x_min, self.y_max, self.z_max],
        ])
        self.top_rect = np.array([
            [self.x_min, self.y_min, self.z_min],
            [self.x_max, self.y_min, self.z_min],
            [self.x_max, self.y_max, self.z_min],
            [self.x_min, self.y_max, self.z_min],
        ])

    def __repr__(self):
        return f"[{self.id}:{self.label},{self.position.tolist()}]"


def rect_area(rect2d) -> float:
    """Area of an axis-aligned rect given its (4, >=2) corners."""
    xs = rect2d[:, 0]
    ys = rect2d[:, 1]
    return float((xs.max() - xs.min()) * (ys.max() - ys.min()))


def in_rect(rect, point) -> bool:
    """Point-in-axis-aligned-rect (xy), strict interior like shapely's
    Polygon.contains."""
    xs = rect[:, 0]
    ys = rect[:, 1]
    return bool(xs.min() < point[0] < xs.max() and ys.min() < point[1] < ys.max())

"""3D box utilities: the port's own copy of
``sceneverse_tpu/common/box_utils.py`` (reference common/box_utils.py)."""

from __future__ import annotations

import numpy as np


def get_box3d_min_max(corner):
    """Min/max coords of an axis-aligned (8,3) corner set (reference :26-40)."""
    mn = corner.min(axis=0)
    mx = corner.max(axis=0)
    return mn[0], mx[0], mn[1], mx[1], mn[2], mx[2]


def get_3d_box(center, box_size):
    """(8,3) corners of an axis-aligned box from center + (l,w,h)
    (reference :49-66)."""
    l, w, h = box_size
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    z = [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]
    corners = np.vstack([x, y, z])
    corners[0, :] += center[0]
    corners[1, :] += center[1]
    corners[2, :] += center[2]
    return corners.T


def box3d_iou(corners1, corners2):
    """Axis-aligned 3D IoU (reference :69-93; same math lives vectorized in
    sceneverse_tpu_torch.data.data_utils.boxes_iou_matrix)."""
    from sceneverse_tpu_torch.data.data_utils import box3d_iou as _iou

    return _iou(np.asarray(corners1), np.asarray(corners2))

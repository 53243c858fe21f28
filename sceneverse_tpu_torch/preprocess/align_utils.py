"""Axis-alignment utilities (reference preprocess/utils/align_utils.py), the
port's own copy of ``sceneverse_tpu/preprocess/align_utils.py``. The box
work (corners, the angle search over K boxes x 90 angles) is object-level and
stays numpy on the host; ``rotate_z_axis_by_degrees`` rotates a scan's
vertices and takes a tensor on the processor's device.

``calc_align_matrix`` — the bbox-rotation histogram search (:85-109) — is
vectorized here: all (angle, box) pairs are evaluated in one broadcasted
numpy pass instead of the reference's double Python loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def compute_box_3d(size, center, rotmat):
    """8 corners of an oriented box (reference :4-25)."""
    l, h, w = [i / 2 for i in size]
    center = np.reshape(center, (3,))
    x = [l, l, -l, -l, l, l, -l, -l]
    y = [h, -h, -h, h, h, -h, -h, h]
    z = [w, w, w, w, -w, -w, -w, -w]
    corners = np.dot(np.transpose(rotmat), np.vstack([x, y, z]))
    return (corners + center[:, None]).T


def rotate_z_axis_by_degrees(pointcloud: torch.Tensor, theta, clockwise=True):
    """(reference :27-37): ``pointcloud @ rot`` on the tensor's device, the
    rotation cast to the tensor's dtype."""
    theta = np.deg2rad(theta)
    c, s = float(np.cos(theta)), float(np.sin(theta))
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                       dtype=pointcloud.dtype, device=pointcloud.device)
    if not clockwise:
        rot = rot.T
    return pointcloud @ rot


def euler_angles_to_rotation_matrix(theta):
    """Rz @ Ry @ Rx (reference :40-76)."""
    tx, ty, tz = theta
    rx = np.array([[1, 0, 0],
                   [0, math.cos(tx), -math.sin(tx)],
                   [0, math.sin(tx), math.cos(tx)]])
    ry = np.array([[math.cos(ty), 0, math.sin(ty)],
                   [0, 1, 0],
                   [-math.sin(ty), 0, math.cos(ty)]])
    rz = np.array([[math.cos(tz), -math.sin(tz), 0],
                   [math.sin(tz), math.cos(tz), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx


def _alignment_counts(boxes, angles, thres):
    """Vectorized bottom-face axis-alignment test.

    boxes: (K, 8, 3); angles: (A,) degrees. Returns (A,) counts of boxes
    whose rotated bottom face (corners 4:) is axis-aligned within ``thres``
    (reference is_axis_aligned :79-82: |x0-x1| and |y0-y3| of the bottom).
    """
    rad = np.deg2rad(angles)
    c, s = np.cos(rad), np.sin(rad)
    # rotation applied as pointcloud @ R with R = [[c,-s,0],[s,c,0],[0,0,1]]
    bottoms = boxes[:, 4:, :2]  # (K, 4, 2)
    x, y = bottoms[..., 0], bottoms[..., 1]  # (K, 4)
    # rotated coords per angle: (A, K, 4)
    xr = x[None] * c[:, None, None] + y[None] * s[:, None, None]
    yr = -x[None] * s[:, None, None] + y[None] * c[:, None, None]
    x_diff = np.abs(xr[:, :, 0] - xr[:, :, 1])
    y_diff = np.abs(yr[:, :, 0] - yr[:, :, 3])
    return ((x_diff < thres) & (y_diff < thres)).sum(axis=1)


def calc_align_matrix(bbox_list):
    """Most-aligned z-rotation angle by histogram search (reference :85-109):
    90 bins over [-45, 45] at threshold 0.05; fall back to 180 bins over
    [-90, 90] at threshold 0.15 when nothing aligns."""
    if len(bbox_list) == 0:
        return 0.0
    boxes = np.asarray(bbox_list, np.float64)
    angles = np.round(np.linspace(-45, 45, 90), 3)
    counts = _alignment_counts(boxes, angles, 0.05)
    if counts.max() == 0:
        angles = np.round(np.linspace(-90, 90, 180), 3)
        counts = _alignment_counts(boxes, angles, 0.15)
        if counts.max() == 0:
            return 0.0
    return float(angles[int(np.argmax(counts))])

"""Relation calculators (reference preprocess/ssg/relationships/*), the
port's own copy of ``sceneverse_tpu/preprocess/ssg/relationships.py``:
support/embedded (support.py:4-94), hanging + above/below (hanging.py:4-58),
camera-view-relative 12-direction proximity (proximity.py:5-117), and
aligned/middle multi-object groups (multi_objs.py).

The phrases are drawn from an explicit ``random.Random`` (``rng``) in place
of the global ``random`` module, in the same loops and the same order, so a
``random.Random(s)`` draws what ``random.seed(s)`` makes the global module
draw."""

from __future__ import annotations

import itertools
import math

import numpy as np

from sceneverse_tpu_torch.preprocess.ssg import dictionary as D
from sceneverse_tpu_torch.preprocess.ssg.objnode import in_rect, rect_area


def generate_relation(src, tgt, express, rng):
    """(reference ssg_utils.py:55-80): map a relation kind to a random phrase
    from its bank."""
    banks = {
        "oppo_support": D.opp_support_express,
        "support": D.support_express,
        "embed_express": D.embed_express,
        "inside_express": D.inside_express,
        "hang": D.hanging_express,
        "high": D.above_express,
        "low": D.below_express,
        "close to": D.close_express,
        "under": D.under_express,
    }
    if "oppo_support" in express:
        return [tgt, src, rng.choice(banks["oppo_support"])]
    for kind, bank in banks.items():
        if kind in express:
            return [src, tgt, rng.choice(bank)]
    return [src, tgt, express]


def cw_rotate(point, ang):
    x, y = point[0], point[1]
    a = math.radians(ang)
    return (round(x * math.cos(a) - y * math.sin(a), 5),
            round(x * math.sin(a) + y * math.cos(a), 5))


def get_theta(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    cos = x.dot(y) / (np.linalg.norm(x) * np.linalg.norm(y))
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


# ------------------------------------------------------------------ support
def is_supported(target_obj, obj, radius_range=0.1, threshold_of_z_rate=0.8):
    """(reference support.py:4-48)."""
    z_min, z_max = obj.z_min, obj.z_max
    tz_min, tz_max = target_obj.z_min, target_obj.z_max
    diff_z = z_min - tz_max
    height = z_max - z_min
    z_rate = abs(diff_z) / height if height else 0.0

    if not rect_area(target_obj.bottom_rect[:, 0:2]) > rect_area(obj.bottom_rect[:, 0:2]):
        return False
    if target_obj.label == "floor":
        if not z_min < tz_max:
            return False
    else:
        if z_min > (tz_max * 0.05 if tz_max > 0 else tz_max * 0.95):  # floating
            return False
        if z_min < tz_min:
            return False
        if not diff_z < height * 0.2:
            return False
    if not in_rect(target_obj.bottom_rect, obj.position):
        return False
    if target_obj.label == "floor":
        return "support_express"
    if z_rate < threshold_of_z_rate:
        return "support_express"
    if z_rate < 0.95:
        return "embed_express"
    return "inside_express"


def cal_support_relations(nodes, rng):
    """(reference support.py:51-94 + loop optimizer :51-62): each supported
    object keeps only its highest supporter."""
    support_dict = {}
    embedded = []
    hanging_objs = {}
    for t_id, target in nodes.items():
        for o_id, obj in nodes.items():
            if t_id == o_id:
                continue
            if target.label in D.always_supported or obj.label in D.always_supported:
                continue
            if target.label in D.hanging or obj.label in D.hanging:
                continue
            kind = is_supported(target, obj)
            if not kind:
                continue
            if kind in ("embed_express", "inside_express"):
                embedded.append(generate_relation(t_id, o_id, kind, rng))
            else:
                support_dict.setdefault(o_id, []).append(target)
            hanging_objs[o_id] = 1

    relations = []
    for obj_id, tgts in support_dict.items():
        highest = max(tgts, key=lambda t: t.position[2])
        relations.append(generate_relation(highest.id, obj_id, "support", rng))
    return relations, embedded, hanging_objs


# ------------------------------------------------------------------ hanging
NO_HANGING_LABELS = ("floor", "table", "chair", "desk", "bottle")


def cal_above_below(nodes, src, scene_high, rng):
    """(reference hanging.py:4-30)."""
    out = []
    for tgt_id, tgt in nodes.items():
        if tgt.label == "floor":
            continue
        if np.linalg.norm(tgt.position[:2] - src.position[:2]) < scene_high * 0.85:
            if src.z_min > tgt.z_max and (
                in_rect(src.bottom_rect, tgt.position)
                or in_rect(tgt.bottom_rect, src.position)
            ):
                out.append(generate_relation(src.id, tgt_id, "high", rng))
    return out


def cal_hanging_relations(nodes, supported_objs, scene_high, rng):
    """(reference hanging.py:41-58): unsupported objects hang on the wall."""
    out = []
    for obj_id, obj in nodes.items():
        if obj_id in supported_objs:
            continue
        if any(l in obj.label for l in NO_HANGING_LABELS):
            continue
        desp = generate_relation(obj.id, -2, "hang", rng)
        if "tv" in obj.label:
            desp[2] = "mounted on"
        if "mirror" in obj.label:
            desp[2] = "affixed to"
        out.append(desp)
        out.extend(cal_above_below(nodes, obj, scene_high, rng))
    return out


# ---------------------------------------------------------------- proximity
def get_direction(src_xy, tgt_xy):
    """Clock direction 1..12 of tgt from src (reference proximity.py:5-33)."""
    v = np.array([tgt_xy[0] - src_xy[0], tgt_xy[1] - src_xy[1]], np.float64)
    v = v / np.linalg.norm(v)
    d = round(get_theta(v, [1, 0]) / 30)
    up = {0: "3", 1: "2", 2: "1", 3: "12", 4: "11", 5: "10", 6: "9"}
    down = {0: "3", 1: "4", 2: "5", 3: "6", 4: "7", 5: "8", 6: "9"}
    return (up if tgt_xy[1] > src_xy[1] else down)[d]


def get_oppo_direction(direction):
    """(reference proximity.py:36-44)."""
    if direction in ("2", "3", "4"):
        return "to the left of"
    if direction in ("8", "9", "10"):
        return "to the right of"
    if direction in ("11", "12", "1"):
        return "behind"
    return "in front of"


def _overlap_points(src, tgt):
    return sum(1 for p in tgt.bottom_rect if in_rect(src.bottom_rect, p[:2]))


def _far_apart(src, tgt):
    d = np.linalg.norm(np.asarray(src.position[:2]) - np.asarray(tgt.position[:2]))
    src_w = np.linalg.norm(np.asarray(src.position[:2]) - src.bottom_rect[0][:2])
    tgt_w = np.linalg.norm(np.asarray(tgt.position[:2]) - tgt.bottom_rect[0][:2])
    return d > 1.5 * (src_w + tgt_w)


def cal_proximity_relations(neighbor_ids, camera_angle, nodes, scene_high,
                            rng):
    """(reference proximity.py:63-117)."""
    out = []
    for src, tgt in itertools.combinations(neighbor_ids, 2):
        if nodes[src].room_id != nodes[tgt].room_id:
            continue
        overlap = _overlap_points(nodes[src], nodes[tgt])
        if overlap > 0:
            rel = "under" if overlap >= 3 else "close to"
            out.append(generate_relation(src, tgt, rel, rng))
            out.append(generate_relation(tgt, src, rel, rng))
            continue
        s_new = cw_rotate(nodes[src].position, camera_angle)
        t_new = cw_rotate(nodes[tgt].position, camera_angle)
        if s_new == t_new:
            break
        direction = get_direction(s_new, t_new)
        oppo = get_oppo_direction(direction)
        if _far_apart(nodes[src], nodes[tgt]):
            rel = direction + " o'clock direction far from"
        else:
            rel = direction + " o'clock direction near"
        out.append([tgt, src, rel])
        if oppo is not None:
            out.append([src, tgt, oppo])
    return out


# --------------------------------------------------------------- multi-objs
def are_furniture_aligned(f1, f2, offset_threshold):
    """(reference multi_objs.py:8-38)."""
    d = np.abs(np.asarray(f1["center"]) - np.asarray(f2["center"]))
    if abs(rect_area(f1["rect"][:, :2]) - rect_area(f2["rect"][:, :2])) > offset_threshold:
        return False
    if d[2] > offset_threshold:
        return False
    if d[0] > offset_threshold and d[1] > offset_threshold:
        return False
    if d[0] < offset_threshold:
        return "x"
    if d[1] < offset_threshold:
        return "y"
    return False


def _merge_groups(pairs):
    """Union-find merge of aligned pairs into groups per axis
    (reference multi_objs.py furniture_merge_lists)."""
    groups = []
    for a, b, axis in pairs:
        placed = False
        for g in groups:
            if g["axis"] == axis and (a in g["ids"] or b in g["ids"]):
                g["ids"].update((a, b))
                placed = True
                break
        if not placed:
            groups.append({"axis": axis, "ids": {a, b}})
    return [sorted(g["ids"]) + [g["axis"]] for g in groups]


def find_aligned_furniture(ids, nodes, offset_threshold):
    pairs = []
    for i, a in enumerate(ids):
        fa = {"center": nodes[a].position, "rect": nodes[a].bottom_rect}
        for b in ids[i + 1:]:
            fb = {"center": nodes[b].position, "rect": nodes[b].bottom_rect}
            axis = are_furniture_aligned(fa, fb, offset_threshold)
            if axis:
                pairs.append((a, b, axis))
    return _merge_groups(pairs)


def find_middle_furniture(ids, nodes, tol=0.3):
    """Object centered between two others of the same class along a line
    (reference multi_objs.py find_middle_furniture semantics)."""
    out = []
    for a, m, b in itertools.permutations(ids, 3):
        if a >= b:
            continue
        pa, pm, pb = (np.asarray(nodes[x].position[:2]) for x in (a, m, b))
        mid = (pa + pb) / 2
        if np.linalg.norm(pm - mid) < tol and nodes[a].label == nodes[b].label:
            out.append([a, m, b, "middle"])
    return out


# ---------------------------------------------------------------------------
# Camera-relative + global-position relations (reference
# preprocess/ssg/relationships/camera.py:5-70). NOTE: the reference never
# imports or calls these functions anywhere (verified: no `import camera` in
# the tree) — they are dead code there. Implemented for surface completeness
# and exposed as an optional pass; not wired into ssg_main's default output,
# matching the reference's effective behavior.
# ---------------------------------------------------------------------------
def _linear_equation(p1x, p1y, p2x, p2y):
    """(reference camera.py:5-13): signed line coefficients through 2 points."""
    sign = 1
    a = p2y - p1y
    if a < 0:
        sign = -1
        a = sign * a
    b = sign * (p1x - p2x)
    c = sign * (p1y * p2x - p1x * p2y)
    return a, b, c


def cal_global_position(obj, floor, distance_rate=1.6):
    """(reference camera.py:16-31, sic 'cal_glocal_position'): 'in the
    center' / 'in the corner' of the room by 2-D distance to the floor
    node's center / bottom-rect corners."""
    tgt = obj.position
    if float(np.linalg.norm(tgt[:2] - floor.position[:2])) < distance_rate:
        return "in the center"
    for point in floor.bottom_rect:
        if float(np.linalg.norm(tgt[:2] - np.asarray(point)[:2])) < distance_rate:
            return "in the corner"
    return None


def cal_camera_relations(nodes, camera_position, camera_view, inst_count,
                         floor_idx, fov=60):
    """(reference camera.py:34-70): per object, an FOV-based relation to the
    fixed camera ('in front of' / 'behind' / 'left' / 'right', camera id
    '-1'), plus a self-referential global-position relation for labels with
    more than one instance."""
    camera_position = np.asarray(camera_position, np.float64)
    camera_view = np.asarray(camera_view, np.float64)
    relationships = []
    for obj_id, node in nodes.items():
        if node.label == "floor":
            continue
        vector = node.position - camera_position
        vector = vector / np.linalg.norm(vector)
        angle = get_theta(vector, camera_view)
        a, b, c = _linear_equation(
            camera_view[0] + camera_position[0],
            camera_view[1] + camera_position[1],
            camera_position[0], camera_position[1],
        )
        if abs(angle) < fov / 2:
            rela = "in front of"
        elif abs(angle) > 180 - fov / 2:
            rela = "behind"
        elif a * node.position[0] + b * node.position[1] + c > 0:
            rela = "right" if camera_view[1] > 0 else "left"
        else:
            rela = "left" if camera_view[1] > 0 else "right"
        relationships.append(["-1", obj_id, rela])
        if inst_count.get(node.label, 0) > 1:
            rela = cal_global_position(node, nodes[floor_idx])
            if rela is not None:
                relationships.append([obj_id, obj_id, rela])
    return relationships

"""IO helpers: the port's own copy of ``sceneverse_tpu/common/io_utils.py``
(reference common/io_utils.py)."""

from __future__ import annotations

import csv
import json
import pickle
from pathlib import Path

import numpy as np


def make_dir(dir_path):
    Path(dir_path).mkdir(parents=True, exist_ok=True)


def load_pickle(filename):
    with Path(filename).open("rb") as f:
        return pickle.load(f)


def save_pickle(data, filename):
    with Path(filename).open("wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_json(filename):
    with Path(filename).open("rb") as f:
        return json.load(f)


def save_json(data, filename, save_pretty=True, sort_keys=False):
    with Path(filename).open("w") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys))
        else:
            json.dump(data, f, sort_keys=sort_keys)


def load_jsonl(filename):
    with Path(filename).open(encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(data, filename):
    with Path(filename).open("w") as f:
        for row in data:
            f.write(json.dumps(row) + "\n")


def load_csv(filename, delimiter=","):
    with Path(filename).open(encoding="utf-8") as f:
        return list(csv.reader(f, delimiter=delimiter))


def load_numpy(filename):
    return np.load(filename, allow_pickle=True)


def save_numpy(data, filename):
    np.save(filename, data)


def save_csv(data, filename, cols=None, delimiter=","):
    """(reference io_utils.py:81-89)."""
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f, delimiter=delimiter)
        if cols is not None:
            writer.writerow(cols)
        writer.writerows(data)


def load_yaml(filename):
    """(reference io_utils.py:55-57)."""
    import yaml

    with open(filename) as f:
        return yaml.safe_load(f)


def save_yaml(data, filename):
    """(reference io_utils.py:60-62)."""
    import yaml

    with open(filename, "w") as f:
        yaml.dump(data, f, default_flow_style=False)


def load_tensor(filename):
    """(reference io_utils.py:100-102; torch.load of array payloads)."""
    import torch

    return torch.load(filename, weights_only=False)


def save_tensor(data, filename):
    """(reference io_utils.py:104-106)."""
    import torch

    torch.save(data, filename)


def load_ply(filepath):
    """(reference io_utils.py:108-120): (vertices, faces) float/int arrays.
    Native reader — no plyfile dependency (preprocess/mesh_io.py)."""
    from sceneverse_tpu_torch.preprocess.mesh_io import load_ply as _load

    mesh = _load(filepath)
    return np.asarray(mesh["vertices"], np.float64), mesh.get("faces")


def load_imgs(img_paths, flag="color"):
    """(reference io_utils.py:17-19, cv2.imread loop); PIL serves the same
    decode."""
    from PIL import Image

    mode = {"color": "RGB", "gray": "L"}[flag]
    return [np.asarray(Image.open(p).convert(mode)) for p in img_paths]

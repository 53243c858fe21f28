"""Dataset registry, dataset construction and the numpy collate.

The port's own copy of the framework-free part of
``sceneverse_tpu/data/build.py`` (``DATASET_REGISTRY``, ``get_dataset``,
``numpy_collate``). Items are dicts of numpy arrays with
static shapes; the trainer batches them with a ``torch.utils.data``
``DataLoader`` (``trainer/build.py``). The JAX package's process sharding,
materialized store and dataset wrappers are not ported.
"""

from __future__ import annotations

import numpy as np

from sceneverse_tpu_torch.registry import Registry

DATASET_REGISTRY = Registry("dataset")


def numpy_collate(items: list) -> dict:
    """Stack dict-of-array items; non-numeric fields become lists."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (bool, np.bool_)):  # before int: bool < int
            out[key] = np.asarray(vals, dtype=bool)
        elif isinstance(first, (int, np.integer)):
            out[key] = np.asarray(vals, dtype=np.int64)
        elif isinstance(first, (float, np.floating)):
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = vals  # strings / metadata
    return out


def get_dataset(cfg, split="train"):
    """The datasets of a split: concatenated for train, a list for eval."""
    from torch.utils.data import ConcatDataset

    from sceneverse_tpu_torch.data.datasets import synthetic  # noqa: F401

    names = cfg.data.get(split)
    if isinstance(names, str):
        names = [names]
    if "data_wrapper" in cfg and cfg.data_wrapper.get(split):
        raise NotImplementedError(
            f"dataset wrapper {cfg.data_wrapper[split]!r} is not ported yet")
    if cfg.data.args.get("materialized", False):
        raise NotImplementedError("materialized datasets are not ported yet")
    datasets = [DATASET_REGISTRY.get(n)(cfg, split) for n in names]
    if split == "train":
        return ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]
    return datasets

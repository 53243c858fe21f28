"""Dataset registry, dataset construction and the loaders.

The port's own copy of ``sceneverse_tpu/data/build.py``: items are dicts of
numpy arrays with static shapes (objects padded to max_obj_len, points to
num_points, text to max_seq_len), built by the datasets under
``datasets/`` and wrapped by ``data_wrapper``; ``build_dataloader`` batches
them with a ``torch.utils.data`` ``DataLoader`` (spawn-context workers and
the shared-memory tensor collate when ``dataloader.num_workers`` > 0, the
numpy collate otherwise), or, for ``data.args.materialized: fast`` on the
train split, with ``materialized.MaterializedBatchLoader``.

Batches are numpy arrays with no workers and CPU tensors with workers;
``trainer/build.py::to_device`` takes both.

``dataloader.batchsize`` is the global batch. Over a world of N processes
(``parallel/mesh.py``) each rank loads b = batch / N rows: in training,
rows ``[r b, (r + 1) b)`` of every global batch, all ranks drawing the
same permutation from the generator seeded by ``rng_seed``, so the ranks'
batches of a step, concatenated, are the one-process batch and each rank
builds only its own items; in evaluation, its uneven contiguous shard of
each dataset (``sharding.ShardedDataset``, JAX ``data/build.py:184-193``),
which the evaluators' cross-rank (value, count) sums make exact.
"""

from __future__ import annotations

import numpy as np
from torch.utils.data import ConcatDataset

from sceneverse_tpu_torch.parallel import mesh
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
    """Instantiate datasets for a split, wrap with the configured wrapper,
    concat for train (reference data/build.py:14-39)."""
    import sceneverse_tpu_torch.data  # noqa: F401 (registries)
    from sceneverse_tpu_torch.data.datasets.dataset_wrapper import \
        DATASETWRAPPER_REGISTRY

    names = cfg.data.get(split)
    if isinstance(names, str):
        names = [names]
    wrapper_name = cfg.data_wrapper[split] if "data_wrapper" in cfg else None

    def build_one(name):
        if cfg.data.args.get("materialized", False):
            # offline-materialized store-backed datasets (data/materialized.py)
            from sceneverse_tpu_torch.data.materialized import (
                MaterializedPretrainObj, MaterializedSpatialRefer)

            if name.endswith("SpatialRefer"):
                ds = MaterializedSpatialRefer(cfg, split, name=name)
            elif name.endswith("PretrainObj"):
                ds = MaterializedPretrainObj(cfg, split, name=name)
            else:
                ds = DATASET_REGISTRY.get(name)(cfg, split)
        else:
            ds = DATASET_REGISTRY.get(name)(cfg, split)
        if wrapper_name:
            ds = DATASETWRAPPER_REGISTRY.get(wrapper_name)(cfg, ds)
        return ds

    datasets = [build_one(n) for n in names]
    if split == "train":
        return ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]
    return datasets


def shm_collate(items: list) -> dict:
    """numpy_collate + torch-tensor wrapping of the array fields.

    With num_workers > 0 the collated batch crosses the worker->main process
    boundary: plain numpy arrays go through pickle pipes, while torch
    tensors ride torch's shared-memory transport."""
    import torch

    out = numpy_collate(items)
    return {
        k: (torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) and v.dtype != object else v)
        for k, v in out.items()
    }


class RankBatches:
    """This rank's rows of each global batch a ``BatchSampler`` yields."""

    def __init__(self, batches, rows: slice):
        self.batches, self.rows = batches, rows

    def __iter__(self):
        for batch in self.batches:
            yield batch[self.rows]

    def __len__(self):
        return len(self.batches)


def _make_loader(dataset, cfg, shuffle, drop_last):
    import torch
    from torch.utils.data import BatchSampler, DataLoader, RandomSampler

    workers = int(cfg.dataloader.get("num_workers", 0))
    batch = int(cfg.dataloader.batchsize)
    rows = mesh.rank_rows(batch, mesh.dp_world(), mesh.dp_rank())
    # a generator of its own, as JAX ``data/build.py::_seeded_generator``:
    # iterating one loader moves no other loader's shuffle
    gen = torch.Generator().manual_seed(int(cfg.get("rng_seed", 42)))
    if shuffle:
        # DataLoader(shuffle=True)'s sampler and generator draws, so one
        # rank sees the batches of the single-process loader
        sampling = {"batch_sampler": RankBatches(BatchSampler(
            RandomSampler(dataset, generator=gen), batch, drop_last), rows)}
    else:
        sampling = {"batch_size": rows.stop - rows.start,
                    "drop_last": drop_last}
    return DataLoader(
        dataset,
        num_workers=workers,
        collate_fn=shm_collate if workers > 0 else numpy_collate,
        pin_memory=False,
        persistent_workers=workers > 0,
        generator=gen,
        **sampling,
        # workers hold numpy only and must never touch the parent's CUDA
        # context: spawn, not fork; persistent_workers pays the start once
        multiprocessing_context="spawn" if workers > 0 else None,
    )


def build_dataloader(cfg, split="train"):
    """Train: one shuffled drop-last loader over the concat dataset (the
    fused materialized batch loader for ``data.args.materialized: fast``).
    Eval: one loader per dataset, in order; a single one is returned as the
    loader itself."""
    if split == "train" and cfg.data.args.get("materialized") == "fast":
        from sceneverse_tpu_torch.data.materialized import \
            build_materialized_train_loader

        return build_materialized_train_loader(cfg)
    dataset = get_dataset(cfg, split)
    if split == "train":
        return _make_loader(dataset, cfg, shuffle=True, drop_last=True)
    if mesh.dp_world() > 1:
        from sceneverse_tpu_torch.data.sharding import ShardedDataset

        dataset = [ShardedDataset(ds, mesh.dp_world(), mesh.dp_rank())
                   for ds in dataset]
    loaders = [
        _make_loader(ds, cfg, shuffle=False, drop_last=False) for ds in dataset
    ]
    return loaders[0] if len(loaders) == 1 else loaders

"""Per-process dataset shards and the eval remainder (the port's copy of
``sceneverse_tpu/data/sharding.py``).

The reference runs one loader per DDP rank through a DistributedSampler
that pads every rank to equal length by wrapping around, then drops the
duplicated tail at metric time (``gather_for_metrics``, reference
common/misc.py:84-132). Two modes give its result:

* ``shard_indices(n, world, rank)`` (``pad=False``, the default):
  contiguous uneven shards; every sample is on exactly one process, the
  last processes may hold one sample fewer. The evaluators' (value, count)
  sums over the ranks (``evaluator/build.py``) then give the reference's
  truncated-gather ratios with no mask.
* ``pad=True``: equal-length shards padded by wraparound and a validity
  mask over the duplicated tail, for callers that need the same number of
  batches on every rank. Masking (value, count) by validity gives the
  truncation exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def shard_indices(n: int, world: int, rank: int,
                  pad: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Indices (and validity mask) of ``rank``'s shard of ``range(n)``.

    Returns (indices, valid) with ``valid[i]`` False only for wraparound
    padding (pad=True). The valid indices of all ranks are ``range(n)``,
    each once.
    """
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    if not pad:
        # contiguous uneven split: the first (n % world) ranks get one extra
        base, extra = divmod(n, world)
        start = rank * base + min(rank, extra)
        size = base + (1 if rank < extra else 0)
        idx = np.arange(start, start + size)
        return idx, np.ones(size, bool)
    per_rank = -(-n // world) if n else 0  # ceil
    idx = np.arange(rank * per_rank, (rank + 1) * per_rank)
    valid = idx < n
    idx = np.where(valid, idx, idx % max(n, 1))
    return idx, valid


class ShardedDataset:
    """View of a dataset restricted to this process's shard (uneven mode)."""

    def __init__(self, dataset, world: int, rank: int):
        self.dataset = dataset
        self.indices, _ = shard_indices(len(dataset), world, rank)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def __getattr__(self, name):
        # collate / meta attributes (e.g. answer vocabularies) come from the
        # base. Dunders and 'dataset' itself are not delegated: unpickling
        # (spawned loader workers) looks them up before __dict__ is back
        if name.startswith("__") or name == "dataset":
            raise AttributeError(name)
        return getattr(self.dataset, name)

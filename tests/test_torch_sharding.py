"""The port's per-process shards and its data-parallel helpers in a world
of 1: ``sceneverse_tpu_torch/data/sharding.py`` against the JAX package's
over a grid of (n, world, pad), the port's copy of each
``tests/test_eval_sharding.py`` case, and ``parallel/mesh.py`` without a
process group (every collective the identity, ``rank_rows``,
``init_from_env`` with no torchrun variables, ``parallel.mp`` > 1 refused
without a process group).
The two-process runs are in ``tests/test_torch_ddp.py``."""

import numpy as np
import pytest
import torch

from sceneverse_tpu.data.sharding import ShardedDataset as JaxSharded
from sceneverse_tpu.data.sharding import shard_indices as jax_shard_indices
from sceneverse_tpu_torch.config import Config
from sceneverse_tpu_torch.data.sharding import ShardedDataset, shard_indices
from sceneverse_tpu_torch.parallel import mesh


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 10, 31])
def test_shard_indices_match_jax(n, world, pad):
    for rank in range(world):
        idx, valid = shard_indices(n, world, rank, pad=pad)
        jidx, jvalid = jax_shard_indices(n, world, rank, pad=pad)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)


def test_shard_indices_reject_a_rank_outside_the_world():
    with pytest.raises(ValueError):
        shard_indices(5, 2, 2)


# ---------------------------------------- the port's copy of test_eval_sharding
@pytest.mark.parametrize("n", [0, 1, 7, 8, 10, 31])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_uneven_shards_partition_exactly(n, world):
    seen, sizes = [], []
    for rank in range(world):
        idx, valid = shard_indices(n, world, rank)
        assert valid.all()
        seen.extend(idx.tolist())
        sizes.append(len(idx))
    assert sorted(seen) == list(range(n))
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n", [1, 7, 10, 31])
@pytest.mark.parametrize("world", [1, 3, 4])
def test_padded_shards_mask_duplicates(n, world):
    per_rank = -(-n // world)
    real = []
    for rank in range(world):
        idx, valid = shard_indices(n, world, rank, pad=True)
        assert len(idx) == per_rank
        assert (idx < n).all()
        real.extend(idx[valid].tolist())
    assert sorted(real) == list(range(n))


def test_simulated_process_metrics_match_global():
    rng = np.random.RandomState(0)
    n, world = 23, 4
    correct = rng.rand(n) < 0.37
    global_acc = correct.mean()
    v = c = 0.0
    for rank in range(world):
        idx, _ = shard_indices(n, world, rank)
        v += correct[idx].sum()
        c += len(idx)
    assert v / c == pytest.approx(global_acc)
    v = c = 0.0
    for rank in range(world):
        idx, valid = shard_indices(n, world, rank, pad=True)
        v += (correct[idx] * valid).sum()
        c += valid.sum()
    assert v / c == pytest.approx(global_acc)
    v = c = 0.0
    for rank in range(world):
        idx, _ = shard_indices(n, world, rank, pad=True)
        v += correct[idx].sum()
        c += len(idx)
    assert c == world * (-(-n // world)) != n


class _Toy:
    meta = "answer_vocab"

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": i}


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_sharded_dataset_view_matches_jax(rank):
    ds, jds = ShardedDataset(_Toy(), 3, rank), JaxSharded(_Toy(), 3, rank)
    assert len(ds) == len(jds)
    assert [ds[i] for i in range(len(ds))] == [jds[i] for i in range(len(ds))]
    assert ds.meta == "answer_vocab"


def test_sharded_dataset_pickles():
    import pickle

    ds = pickle.loads(pickle.dumps(ShardedDataset(_Toy(), 3, 2)))
    assert [ds[i]["x"] for i in range(len(ds))] == [7, 8, 9]


# ------------------------------------------------------- mesh, world of 1
def test_world_of_one_without_a_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.init_from_env("gloo")
    assert (mesh.world(), mesh.rank(), mesh.local_rank()) == (1, 0, 0)
    x = torch.randn(3, 4, requires_grad=True)
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather_rows(x) is x
    (s, g), n = mesh.global_sums((x.sum(0), x.t() @ x), 3)
    assert n == 3 and torch.equal(s, x.sum(0))
    np.testing.assert_array_equal(mesh.all_reduce_host([1.0, 2.0]),
                                  [1.0, 2.0])
    assert mesh.all_gather_objects({"a": 1}) == [{"a": 1}]
    grads = [torch.ones(2)]
    mesh.all_reduce_flat(grads)
    assert torch.equal(grads[0], torch.ones(2))
    mesh.barrier()


@pytest.mark.parametrize("batch,world,rows", [
    (8, 1, (0, 8)), (8, 2, (4, 8)), (32, 4, (24, 32)), (6, 3, (4, 6))])
def test_rank_rows_of_the_last_rank(batch, world, rows):
    s = mesh.rank_rows(batch, world, world - 1)
    assert (s.start, s.stop) == rows


def test_rank_rows_raise_when_the_batch_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rank_rows(6, 4, 0)


def test_model_parallel_axis_is_refused():
    """mp = 1 needs no process group; mp = 2 in a world of 1 raises (the
    grids over process groups are tests/test_torch_mp.py's)."""
    mesh.setup_grid(Config({"parallel": {"mp": 1}}))
    assert (mesh.mp_world(), mesh.dp_world()) == (1, 1)
    with pytest.raises(ValueError, match="process group"):
        mesh.setup_grid(Config({"parallel": {"mp": 2}}))


def test_misc_helpers_in_one_process(tmp_path):
    from types import SimpleNamespace

    from sceneverse_tpu_torch.common.misc import (gather_dict, make_dir,
                                                  rgetattr)

    d = {"acc": (3.0, 4.0)}
    assert gather_dict(d) is d
    obj = SimpleNamespace(a=SimpleNamespace(b=2))
    assert rgetattr(obj, "a.b") == 2 and rgetattr(obj, "a.c", -1) == -1
    make_dir(tmp_path / "x" / "y")
    make_dir(tmp_path / "x" / "y")
    assert (tmp_path / "x" / "y").is_dir()

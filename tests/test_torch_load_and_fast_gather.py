"""Port parity for two behaviours of the JAX package, each held against the
JAX package on the CPU:

  1. ``load_torch_pretrain`` with a checkpoint that holds a tensor of
     another shape than the model's and a key the model lacks: JAX skips
     the mismatched tensor, lists it as unexpected (with both shapes) and
     as missing, and loads every other tensor
     (``sceneverse_tpu/ckpt/convert.py:139-210``). The port does the same,
     from a flat file, a shard directory and its own ``best.pth``; a
     directory without shards raises ``FileNotFoundError`` on both sides.
  2. ``SCENEVERSE_PALLAS_FAST``, read when a ``PointnetSAModule`` is built:
     set, the trainable SA1 route gathers the points rounded to bf16
     (``pointnet.py:249-253,335-348`` there); unset, it gathers f32.

Tolerances: loaded tensors bit-equal (copies on both sides). The SA
module's features within 1e-4 * max(1, max|jax|), as the unfreeze tests
hold the losses: the same f32 MLP and train-mode BatchNorm summed in
another order. ``new_xyz`` and the grouped rows fed to the MLP bit-equal
(the same FPS, ball query and gather, with the same rounding).
"""

import numpy as np
import pytest
import torch

from test_torch_modules import flat_state, jbuild

MLPS = [[3, 16, 16, 32], [32, 32, 32, 64], [64, 64, 64, 64]]
SA_ARGS = dict(sa_n_points=[8, 4, None], sa_n_samples=[4, 4, None],
               sa_radii=[0.3, 0.6, None], sa_mlps=MLPS)


def _torch_name(jax_path: str) -> str:
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    return next(iter(from_jax_params({jax_path: np.zeros((1, 1))})))


def _split(entry: str):
    """(name, shape note or '') of a loader's unexpected entry."""
    name, _, note = entry.partition(" (shape ")
    return name, note


@pytest.mark.parametrize("layout", ["flat_file", "shard_dir", "best_pth",
                                    "no_shards"])
def test_load_torch_pretrain_skips_a_mismatch_as_jax_does(tmp_path, layout):
    from sceneverse_tpu.ckpt.convert import (apply_to_model,
                                             convert_torch_state_dict)
    from sceneverse_tpu.ckpt.convert import load_torch_pretrain as jload
    from sceneverse_tpu.modules.layers.pointnet import PointNetPP as J
    from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain as tload
    from sceneverse_tpu_torch.modules.layers.pointnet import PointNetPP as T

    if layout == "no_shards":
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError):
            tload(T(**SA_ARGS), tmp_path / "empty")
        with pytest.raises(FileNotFoundError):
            jload(jbuild(J, 0, **SA_ARGS), str(tmp_path / "empty"))
        return
    from sceneverse_tpu_torch.ckpt.convert import (from_jax_params,
                                                   load_jax_params)

    jm = jbuild(J, 0, **SA_ARGS)
    tm = T(**SA_ARGS)
    missing, unexpected = load_jax_params(tm, flat_state(jm))
    assert missing == [] and unexpected == []
    # the checkpoint: another seed's weights, fc.weight one column wider,
    # and a key neither model has
    torch.manual_seed(3)
    weights = T(**SA_ARGS).state_dict()
    out, cin = weights["fc.weight"].shape
    weights["fc.weight"] = torch.randn(out, cin + 1)
    weights["extra.weight"] = torch.randn(2, 5)
    flat = tmp_path / "ckpt.bin"
    torch.save(weights, flat)
    jpath = tpath = flat
    if layout == "shard_dir":
        keys = list(weights)
        for i, part in enumerate((keys[:10], keys[10:])):
            torch.save({k: weights[k] for k in part},
                       tmp_path / f"pytorch_model-0000{i + 1}.bin")
        jpath = tpath = tmp_path
    elif layout == "best_pth":  # the port's own checkpoint; JAX reads flat
        tpath = tmp_path / "best.pth"
        torch.save({"model": weights, "step": 1}, tpath)

    n_jax = jload(jm, str(jpath))
    n_port = tload(tm, tpath)
    # the same weights once more, for the lists: a reload changes nothing
    from sceneverse_tpu_torch.ckpt.convert import apply_state_dict

    n_j, miss_j, unexp_j = apply_to_model(jm, convert_torch_state_dict(weights))
    n_t, miss_t, unexp_t = apply_state_dict(tm, weights)
    counters = [k for k in weights if k.endswith("num_batches_tracked")]
    assert n_j == n_jax and n_t == n_port
    # JAX keeps no BatchNorm step counters; the port loads them too
    assert n_port == n_jax + len(counters) == len(weights) - 2
    assert miss_t == [_torch_name(k) for k in miss_j] == ["fc.weight"]
    assert ([_torch_name(_split(e)[0]) for e in unexp_j]
            == [_split(e)[0] for e in unexp_t]
            == ["fc.weight", "extra.weight"])
    assert _split(unexp_t[0])[1] == f"({out}, {cin + 1}) vs ({out}, {cin}))"
    # every tensor, loaded or skipped, the same on both sides
    got = tm.state_dict()
    want = from_jax_params(flat_state(jm))
    assert got.keys() == set(want) | set(counters)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        if k != "fc.weight":
            assert torch.equal(got[k], weights[k]), k
    assert not torch.equal(got["fc.weight"][:, :cin], weights["fc.weight"][:, :cin])


@pytest.mark.parametrize("fast", [True, False])
def test_pallas_fast_reaches_the_trainable_sa1_route(monkeypatch, fast):
    import jax.numpy as jnp

    from sceneverse_tpu.modules.layers.pointnet import PointnetSAModule as J
    from sceneverse_tpu_torch.ckpt.convert import load_jax_params
    from sceneverse_tpu_torch.modules.layers.pointnet import \
        PointnetSAModule as T
    from sceneverse_tpu_torch.ops.sample_group import sample_and_group_plain

    monkeypatch.setenv("SCENEVERSE_PALLAS_INTERPRET", "1")
    if fast:
        monkeypatch.setenv("SCENEVERSE_PALLAS_FAST", "1")
    else:
        monkeypatch.delenv("SCENEVERSE_PALLAS_FAST", raising=False)
    kw = dict(npoint=32, radius=0.2, nsample=32, mlp=[3, 32, 32, 64])
    jm = jbuild(J, 0, **kw)
    tm = T(**kw)
    missing, unexpected = load_jax_params(tm, flat_state(jm))
    assert missing == [] and unexpected == []
    rng = np.random.RandomState(5)
    xyz = (rng.rand(4, 256, 3).astype(np.float32) - 0.5)
    feats = rng.randn(4, 256, 3).astype(np.float32)
    fed = []
    tm.mlps[0].register_forward_pre_hook(lambda mod, a: fed.append(a[0]))
    t_xyz, t_out = tm(torch.from_numpy(xyz), torch.from_numpy(feats))
    j_xyz, j_out = jm(jnp.asarray(xyz), jnp.asarray(feats))
    np.testing.assert_array_equal(t_xyz.detach().numpy(), np.asarray(j_xyz))
    j_out = np.asarray(j_out)
    err = np.abs(t_out.detach().numpy() - j_out).max()
    assert err <= 1e-4 * max(1.0, np.abs(j_out).max()), err
    pts = torch.from_numpy(np.concatenate([xyz, feats], -1))
    want = sample_and_group_plain(pts, 32, 32, 0.2, exact=not fast)[0]
    assert torch.equal(fed[0], want)
    other = sample_and_group_plain(pts, 32, 32, 0.2, exact=fast)[0]
    assert not torch.equal(fed[0], other)
    assert jm.pallas_exact == tm.pallas_exact == (not fast)

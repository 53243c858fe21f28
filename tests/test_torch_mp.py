"""The dp x mp process grid of the port (``sceneverse_tpu_torch/parallel/mesh.py``)
and its vocabulary-parallel LM head (``parallel/vocab.py``): a gloo world of
4 processes at (dp 2, mp 2) and then (dp 1, mp 4), against the world of 1
over the same global batch and against the JAX package's (dp 2, mp 2) mesh
step on 4 of conftest's 8 virtual devices.

The module spawns its four ranks once (spawn context, ``init_method=file://``
under the test's temporary directory); each runs
``tests/_torch_mp_worker.py::run``, which imports no JAX. The world of 1
runs the same functions in this process. Setup in the worker's docstring
(``tests/test_multichip.py::_small_cfg``'s widths, global batch 8, the clip
engaged, dropout off unless a case says otherwise).

  1. The grid: rank r is dp rank r // mp and mp rank r % mp; the text head
     (V = 1024) is split over mp, rank k holding rows [k V / mp, (k + 1) V /
     mp) of its decoder and bias; the 607-way object head and a V = 1023
     head (mp = 2 does not divide it) stay whole.
  2. (dp 2, mp 2) equals JAX's (dp 2, mp 2) step at test_multichip's
     tolerances: loss within 1e-4, parameters within atol 5e-5, rtol 1e-4.
     JAX's frozen PointNet++ is replaced by the port's features on the same
     batch, as in ``tests/test_torch_ddp.py`` item 2.
  3. (dp 2, mp 2), (dp 1, mp 4) and the V = 1023 case equal the world of 1
     within ``test_torch_ddp.REL`` (f32 summed in another order): the
     logged losses, the clipped gradients (the head gathered; the global
     norm after the clip is ``CLIP``, so the clip engaged), the parameters
     after AdamW (test_torch_ddp's rule in units of lr), the val metrics.
  4. Every rank holds the same replicated parameters bit for bit, and each
     rank's head rows are its rows of the gathered head. With dropout on,
     the mp peers' summed gradients are bit-equal before the mp broadcast
     (they drew the same masks: their streams are seeded from the dp rank),
     the dp ranks' streams differ.
  5. A checkpoint written at mp = 2 holds the whole head and loads at mp = 1
     with equal tensors; one written at mp = 1 resumes at mp = 2 with each
     rank's rows of the head and of its AdamW moments, and written again
     there equals the first, tensor for tensor. One written between the
     micro-steps of gradient accumulation holds the head's running mean
     whole.
  6. ``parallel.mp=2`` in a world of 1, and mp = 3 in a world of 4, raise.
  7. K = 2 steps per dispatch at (dp 1, mp 2): after the world of 4, ranks
     0 and 1 form a world of 2 of their own and run one chunk of 2 steps
     through ``train_forward_backward_k`` (in a row: gloo has no graph),
     each micro-step with its clip, head gather and replicas' broadcast;
     both steps' losses, the last clipped gradients and the parameters after
     the two AdamW steps equal the world of 1's K = 2 run as item 3 holds
     them (parameters in units of lr times the steps), and both ranks hold
     the same replicated parameters.
"""

import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import _torch_mp_worker as W
from test_torch_ddp import REL, _Features, _flat

TIMEOUT_S = 240
HEAD = W.HEAD
SPLIT = [HEAD + "bias", HEAD + "decoder.weight"]  # named_parameters order
GRID_CASES = ["dp2_mp2", "dp1_mp4", "v1023"]
# the world of 1 each grid case is held against
ONE = {"dp2_mp2": "dp2_mp2", "dp1_mp4": "dp2_mp2", "v1023": "v1023",
       "dp1_mp2_k2": "dp1_mp2_k2"}
K2_CASE = "dp1_mp2_k2"


def _jax_mesh_step(cfg, model, batch):
    """One GPS train step on JAX's (dp 2, mp 2) mesh: (loss, port-named
    params)."""
    from jax.sharding import PartitionSpec as P

    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu.parallel.mesh import (mesh_from_cfg, shard_batch,
                                              shard_module)
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    mesh = mesh_from_cfg(cfg)
    assert mesh.shape == {"dp": 2, "mp": 2}
    for _, m in nnx.iter_modules(model):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    model.train()
    loss_mod, tx, _, _ = build_optim(cfg, model, total_steps=1)
    optimizer = nnx.Optimizer(model, tx, wrt=nnx.Param)
    shard_module(model, mesh)
    shard_module(optimizer, mesh)
    kernel = model.pretrain_head.lm_pred_head.decoder.kernel
    assert kernel[...].sharding.spec == P(None, "mp")
    batch = shard_batch(batch, mesh)

    @nnx.jit
    def train_step(model, optimizer, batch):
        def loss_fn(model):
            return loss_mod(model(batch))[0]

        total, grads = nnx.value_and_grad(loss_fn)(model)
        optimizer.update(model, grads)
        return total

    with mesh:
        total = train_step(model, optimizer, batch)
        jax.block_until_ready(total)
    return float(total), from_jax_params(_flat(nnx.state(model, nnx.Param)))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(the world of 1's results, the four ranks' results, the directory)."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data.build import get_dataset, numpy_collate
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.ckpt.convert import (apply_state_dict,
                                                   from_jax_params)
    from sceneverse_tpu_torch.data.build import build_dataloader
    from sceneverse_tpu_torch.model import build_model as tbuild

    base = tmp_path_factory.mktemp("mp")
    spec = {"out": str(base), "weights": str(base / "weights.pt"),
            "mp1_ckpt": str(base / "mp1_ckpt" / "mp1.pth")}
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=W.run,
                             args=(r, W.WORLD, str(base / "init"), spec))
                 for r in range(W.WORLD)]
        for p in procs:
            p.start()
        try:
            torch.set_num_threads(2)  # beside the four ranks
            # the JAX model's weights (written whole, then renamed) are
            # every run's pretrain checkpoint
            jcfg = jload(W.CFG, W.SMALL + ["num_gpu=2", "parallel.mp=2"])
            jm = jbuild(jcfg, rngs=nnx.Rngs(0))
            weights = from_jax_params(_flat(nnx.state(jm, nnx.Not(
                nnx.RngState))))
            torch.save(weights, base / "weights.tmp")
            os.replace(base / "weights.tmp", base / "weights.pt")
            one = {}
            one["accum"] = W.accumulated(1, base / "accum_w1",
                                         spec["weights"])
            for case in ("dp2_mp2", "v1023", K2_CASE):
                one[case], t = W.step(case, 1, base / f"{case}_w1",
                                      spec["weights"],
                                      eval_val=case != K2_CASE)
                if case == "dp2_mp2":
                    t.ckpt_path = base / "mp1_ckpt"
                    t.save("mp1.pth")  # resumed at mp 2 by the ranks
                del t
            tcfg = W._cfg(W.SMALL)
            order = next(iter(build_dataloader(tcfg, "train")))["data_idx"]
            ds = get_dataset(jcfg, "train")
            batch = {k: v for k, v in numpy_collate(
                [ds[int(i)] for i in order]).items()
                if isinstance(v, np.ndarray)}
            tm = tbuild(tcfg)
            apply_state_dict(tm, weights)
            with torch.no_grad():
                fts = torch.from_numpy(batch["obj_fts"])
                feats = tm.point_encoder.point_feature_extractor(
                    fts.reshape(-1, *fts.shape[2:])).numpy()
            jm.point_encoder.point_feature_extractor = _Features(feats)
            one["jax"] = _jax_mesh_step(jcfg, jm, batch)
        finally:
            torch.set_num_threads(threads)
            for p in procs:
                p.join(TIMEOUT_S)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    assert [p.exitcode for p in procs] == [0] * W.WORLD
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    one["from_mp2"] = W.resumed(1, base / "resume_w1", spec["weights"],
                                base / "mp2_ckpt" / "mp2.pth")
    return one, ranks, base


def test_four_ranks_ran_on_the_grid(grid):
    _, ranks, _ = grid
    assert [(r["world"], r["rank"]) for r in ranks] == [(4, i)
                                                       for i in range(4)]
    for i, r in enumerate(ranks):
        assert r["cases"]["dp2_mp2"]["grid"] == (2, 2, i // 2, i % 2)
        assert r["cases"]["dp1_mp4"]["grid"] == (1, 4, 0, i)


@pytest.mark.parametrize("case", ["dp2_mp2", "dp1_mp4", "v1023"])
def test_the_split_follows_the_vocabulary_rule(grid, case):
    one, ranks, _ = grid
    assert one[ONE[case]]["split"] == [] and one[ONE[case]]["shard"] == {}
    mp = W.CASES[case][0]
    for i, r in enumerate(ranks):
        got = r["cases"][case]
        if case == "v1023":  # 1023 % 2: the head stays whole
            assert got["split"] == [] and got["shard"] == {}
            assert got["param"][HEAD + "bias"].shape == (1023,)
            continue
        assert got["split"] == SPLIT
        rows = slice((i % mp) * W.VOCAB // mp, (i % mp + 1) * W.VOCAB // mp)
        for n in SPLIT:
            assert got["shard"][n].shape[0] == W.VOCAB // mp
            assert torch.equal(got["shard"][n], got["param"][n][rows]), n
        # the 607-way object head and the transform stay whole
        assert got["param"]["pretrain_head.obj_pred_head.bias"].shape == (
            607,)
        assert not any("obj_pred_head" in n or "transform" in n
                       for n in got["shard"])


def test_dp2_mp2_matches_jax_mesh_step(grid):
    one, ranks, _ = grid
    jloss, jparams = one["jax"]
    assert len(jparams) > 50
    for r in ranks:
        got = r["cases"]["dp2_mp2"]
        assert got["row"]["total_loss"] == pytest.approx(jloss, abs=1e-4)
        for n, want in jparams.items():
            np.testing.assert_allclose(got["param"][n].numpy(),
                                       want.numpy(), atol=5e-5, rtol=1e-4,
                                       err_msg=n)


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_losses_and_val_metrics_match_one_rank(grid, case):
    one, ranks, _ = grid
    want = one[ONE[case]]
    keys = [k for k in want["row"] if k.endswith("loss")
            or k in ("TextObjWithinBatch", "TextSceneBetweenBatch")]
    assert "lm_cls_loss" in keys
    for r in ranks:
        got = r["cases"][case]
        for k in keys:
            assert abs(got["row"][k] - want["row"][k]) <= REL * max(
                1.0, abs(want["row"][k])), k
        assert set(got["val"]) == set(want["val"])
        for k, v in want["val"].items():
            assert got["val"][k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_clipped_gradients_match_one_rank(grid, case):
    one, ranks, _ = grid
    want, lr = one[ONE[case]]["grad"], one[ONE[case]]["lr"]
    opt = [n for n in want if lr[n] is not None]  # what the clip sees

    def norm(g):  # in float64: an f32 norm of 4.7 M values is 1.5e-4 off
        return torch.cat([g[n].reshape(-1) for n in opt]).double().norm(
            ).item()

    assert norm(want) == pytest.approx(W.CLIP, rel=1e-5)  # it engaged
    gmax = max(g.abs().max().item() for g in want.values())
    for r in ranks:
        got = r["cases"][case]["grad"]
        assert set(got) == set(want)
        assert norm(got) == pytest.approx(W.CLIP, rel=1e-5)
        for n in want:
            assert (got[n] - want[n]).abs().max().item() <= \
                REL * want[n].abs().max().item() + 1e-7 * gmax, n


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_params_after_adamw_match_one_rank(grid, case):
    """Beyond REL * max|p|, in units of lr: none beyond 0.25 and at most
    0.1% of a tensor's elements beyond 0.01 (test_torch_ddp.py's rule)."""
    one, ranks, _ = grid
    want, lr = one[ONE[case]]["param"], one[ONE[case]]["lr"]
    assert sum(v is not None for v in lr.values()) > 50
    for r in ranks:
        got = r["cases"][case]["param"]
        assert set(got) == set(want)
        for n in want:
            if lr[n] is None:  # not optimised: as loaded on both sides
                assert torch.equal(got[n], want[n]), n
                continue
            units = ((got[n] - want[n]).abs()
                     - REL * want[n].abs().max()) / lr[n]
            assert units.max().item() <= 0.25, (n, units.max().item())
            assert (units > 0.01).float().mean().item() <= 1e-3, n


@pytest.mark.parametrize("case", list(W.CASES))
def test_every_rank_holds_the_same_parameters(grid, case):
    _, ranks, _ = grid
    ref = ranks[0]["cases"][case]["param"]
    for r in ranks[1:]:
        got = r["cases"][case]["param"]
        for n in ref:
            assert torch.equal(got[n], ref[n]), n


def test_dropout_streams_follow_the_dp_rank(grid):
    _, ranks, _ = grid
    handed = [r["cases"]["dropout"]["handed"] for r in ranks]
    gens = [r["cases"]["dropout"]["gens"] for r in ranks]
    assert handed[0] and all(h is not None for h in handed)
    for a, b in ((0, 1), (2, 3)):  # mp peers: the same masks
        assert all(torch.equal(x, y) for x, y in zip(handed[a], handed[b]))
        assert all(torch.equal(x, y) for x, y in zip(gens[a], gens[b]))
    assert not all(torch.equal(x, y) for x, y in zip(gens[0], gens[2]))
    # dropout was on: the losses differ from the dropout-off step's
    off = ranks[0]["cases"]["dp2_mp2"]["row"]["total_loss"]
    assert ranks[0]["cases"]["dropout"]["row"]["total_loss"] != off


def test_checkpoint_from_mp2_loads_at_mp1(grid):
    one, ranks, base = grid
    saved = W.checkpoint_state(base / "mp2_ckpt" / "mp2.pth")
    model = saved["model"]
    assert model[HEAD + "decoder.weight"].shape == (W.VOCAB, 96)
    for n, v in ranks[0]["cases"]["dp2_mp2"]["param"].items():
        assert torch.equal(model[n], v), n
    back = one["from_mp2"]
    assert back["split"] == []
    for n, v in back["param"].items():
        assert torch.equal(v, model[n]), n
    moments = back["moments"][HEAD + "decoder.weight"]
    assert moments["exp_avg"].shape == (W.VOCAB, 96)
    again = W.checkpoint_state(base / "resume_w1" / "again.pth")
    for n, v in model.items():
        assert torch.equal(again["model"][n], v), n


def test_checkpoint_from_mp1_resumes_at_mp2(grid):
    one, ranks, base = grid
    saved = W.checkpoint_state(base / "mp1_ckpt" / "mp1.pth")
    model = saved["model"]
    assert model[HEAD + "decoder.weight"].shape == (W.VOCAB, 96)
    moments = one["dp2_mp2"]["moments"]  # mp1.pth's, by parameter name
    for i, r in enumerate(ranks):
        res = r["resumed"]
        assert res["split"] == SPLIT
        rows = slice((i % 2) * W.VOCAB // 2, (i % 2 + 1) * W.VOCAB // 2)
        for n, v in res["param"].items():
            assert torch.equal(v, model[n][rows] if n in SPLIT
                               else model[n]), n
        assert set(res["moments"]) == set(moments)
        for n, m in res["moments"].items():
            for k, v in m.items():
                want = moments[n][k]
                assert torch.equal(v, want[rows] if n in SPLIT else want), \
                    (n, k)
    # written again at mp 2: the mp 1 checkpoint, tensor for tensor
    again = W.checkpoint_state(base / "resume_w4" / "again.pth")
    for n, v in model.items():
        assert torch.equal(again["model"][n], v), n
    state = saved["optimizer"]["opt"]["state"]
    assert set(again["optimizer"]["opt"]["state"]) == set(state)
    for i, s in state.items():
        for k, v in s.items():
            assert torch.equal(again["optimizer"]["opt"]["state"][i][k],
                               v), (i, k)


def test_checkpoint_mid_accumulation_holds_the_whole_mean(grid):
    """Saved between the micro-steps of gradient accumulation at (dp 1,
    mp 4): the running mean of the split head gathered whole, equal to the
    world of 1's within REL; each rank held its rows."""
    one, ranks, base = grid
    saved = W.checkpoint_state(base / "accum_w4" / "accum.pth")
    acc = saved["optimizer"]["acc"]
    assert saved["optimizer"]["mini_step"] == 1
    assert [a.shape for a in acc] == [a.shape for a in one["accum"]]
    assert any(a.shape[0] == W.VOCAB for a in acc)
    gmax = max(a.abs().max().item() for a in one["accum"])
    assert gmax > 0
    for got, want in zip(acc, one["accum"]):
        assert (got - want).abs().max().item() <= \
            REL * want.abs().max().item() + 1e-7 * gmax
    for i, r in enumerate(ranks):
        rows = [a.shape[0] for a in r["accum"]]
        assert rows.count(W.VOCAB // 4) == 2  # decoder.weight and bias
        assert sorted(rows) != sorted(a.shape[0] for a in acc)


def test_mp_without_a_process_group_raises(tmp_path):
    from sceneverse_tpu_torch.trainer.build import build_trainer

    cfg = W._cfg(W.SMALL + ["parallel.mp=2", f"exp_dir={tmp_path}"])
    with pytest.raises(ValueError, match="process group"):
        build_trainer(cfg)


def test_a_world_mp_does_not_divide_raises(grid):
    _, ranks, _ = grid
    for r in ranks:
        assert "not divisible by parallel.mp=3" in r["mp3_error"]


def test_dp1_mp2_k2_took_the_k_path_on_both_ranks(grid):
    one, ranks, _ = grid
    assert one[K2_CASE]["chunks"] == [2]
    for i, r in enumerate(ranks[:2]):
        got = r["cases"][K2_CASE]
        assert got["chunks"] == [2]
        assert got["grid"] == (1, 2, 0, i)
        assert got["split"] == SPLIT
        assert len(got["rows"]) == 2
    assert all(K2_CASE not in r["cases"] for r in ranks[2:])


def test_dp1_mp2_k2_losses_match_one_rank(grid):
    one, ranks, _ = grid
    rows = one[K2_CASE]["rows"]
    keys = [k for k in rows[0] if k.endswith("loss")
            or k in ("TextObjWithinBatch", "TextSceneBetweenBatch")]
    assert "lm_cls_loss" in keys and len(rows) == 2
    for r in ranks[:2]:
        for step, (got, want) in enumerate(zip(r["cases"][K2_CASE]["rows"],
                                               rows)):
            for k in keys:
                assert abs(got[k] - want[k]) <= REL * max(
                    1.0, abs(want[k])), (step, k)


def test_dp1_mp2_k2_clipped_gradients_match_one_rank(grid):
    """The second step's clipped gradients, the head gathered."""
    one, ranks, _ = grid
    want = one[K2_CASE]["grad"]
    gmax = max(g.abs().max().item() for g in want.values())
    for r in ranks[:2]:
        got = r["cases"][K2_CASE]["grad"]
        assert set(got) == set(want)
        for n in want:
            assert (got[n] - want[n]).abs().max().item() <= \
                REL * want[n].abs().max().item() + 1e-7 * gmax, n


def test_dp1_mp2_k2_params_after_adamw_match_one_rank(grid):
    one, ranks, _ = grid
    want, lr = one[K2_CASE]["param"], one[K2_CASE]["lr"]
    a, b = (r["cases"][K2_CASE]["param"] for r in ranks[:2])
    for n in want:
        assert torch.equal(a[n], b[n]), n  # the replicas agree
        if lr[n] is None:
            assert torch.equal(a[n], want[n]), n
            continue
        units = ((a[n] - want[n]).abs()
                 - REL * want[n].abs().max()) / (lr[n] * 2)
        assert units.max().item() <= 0.25, (n, units.max().item())
        assert (units > 0.01).float().mean().item() <= 1e-3, n

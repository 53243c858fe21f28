"""Data parallelism of the port (``sceneverse_tpu_torch/parallel/mesh.py``):
a gloo world of 2 processes against a world of 1 over the same global
batch, and against the JAX package's dp=2 mesh step.

The module spawns its two ranks once (spawn context, ``init_method=file://``
under the test's temporary directory, so xdist workers never race for a
port); each runs ``tests/_torch_ddp_worker.py::run``, which imports no JAX.
The world of 1 runs the same functions in this process, with no process
group. Setup in the worker's docstring (hidden 64, 1 layer, 4 objects x 64
points, global batch 4, dropout off, ``SCENEVERSE_FUSED_MHA=off``).

  1. Routes (frozen with the JAX model's weights; unfrozen with the literal
     train-mode BatchNorm; unfrozen with ``SCENEVERSE_BN_FOLD=on``, BatchNorm
     folded into the convs from the input's mean and Gram; unfrozen with
     ``SCENEVERSE_BN_FOLD=on`` and ``SCENEVERSE_SA_TRAIN_FUSED=on``, the
     ``sa_train`` plain twins): one ``DefaultTrainer.train_step``. Both
     ranks hold the same parameters and statistics bit for bit. The frozen,
     the literal and the folded routes equal the world of 1 within REL
     (f32 summed in another order: the rows of a moment, a loss and a
     gradient split over two ranks; measured at most 4e-7 / 1.1e-6 /
     1.7e-6 relative L2 on the gradients, 4.2e-7 on the statistics): the
     logged losses, the gradients the optimizer took (summed over the
     ranks, then clipped), the BatchNorm running statistics. Parameters
     after one AdamW step, beyond REL * max|p|, in units of lr: none beyond
     0.25 and at most 0.1% of a tensor's elements beyond 0.01, the rule of
     ``test_torch_slice.py`` (Adam normalises an element whose gradient sits
     near eps from a noisy value; measured at most 0.023, none beyond
     0.01).
     The fused route rounds each layer's activations to bf16 with (a, b)
     folded from the moments, so a change in the moments' summation order
     flips roundings and pool argmaxes downstream: in one process, the same
     rows summed in another order (a permutation) move its losses by up to
     3.6e-4 (the scene contrastive loss; the total by 3.6e-5), its
     gradients by 4.8% (relative L2), its deeper statistics by 3.9e-4 and
     parameters by up to 2 lr. Two ranks against one measured 2.9e-4,
     4.2%, 3.2e-4 in one run and 2.5e-6, 0.17%, 1.2e-5 in another (the
     thread counts differ, and so the sums' order). It is held to FUSED_TOL, and its SyncBN exactly where
     no bf16 rounding precedes the moments: the statistics of SA1's three
     layers and SA2's first within REL (measured at most 2.4e-6; per-rank
     moments would be off by the sampling error of half the rows).
     The ObjCls route (``OBJCLS`` in the worker: ``ObjPretrainTrainer``
     on ``SyntheticObjDataset``, the PointNet++ at clip width and an MLP
     head, the reference's one SyncBatchNorm model) runs the literal
     route's arithmetic, and its losses and statistics are held within
     REL. Its gradients are held to OBJCLS_TOL: one center of SA2 (a ball
     that holds only its center, so its 32 sample rows are copies) has a
     layer-0 conv output within f32 rounding of its channel's batch mean;
     with BatchNorm's shift at 0 it normalises to exactly 0 in one world
     and a rounding above it in the other, the ReLU of those 32 rows lands
     the other way, and every gradient below it moves (1.3e-3 relative L2
     over all gradients, held at REL). Parameters after one AdamW step:
     Adam normalises such an element to a different fraction of its step,
     so within Adam's bound of 2 lr (1.83 on one element, held at 0.25).
     K steps per dispatch (``solver.steps_per_dispatch``) over the two
     ranks, the frozen route: one chunk of K = 2 steps, and two chunks of K
     = 3 micro-steps at ``gradient_accumulation_steps`` 2 (chunks at phases
     0 and 1, three updates). Each chunk goes through
     ``train_forward_backward_k`` on both ranks (its K steps in a row: no
     graph over gloo), and every step's losses and metrics, the last
     gradients and the parameters after the updates are held to the world
     of 1's K-step run as the frozen route is (parameters in units of lr
     times the updates).
  2. The frozen route equals JAX's dp=2 mesh step (``tests/test_multichip.py``'s
     pattern) at test_multichip's tolerances: loss within 1e-4, parameters
     within atol 5e-5, rtol 1e-4. JAX's frozen PointNet++ is replaced by
     the port's features on the same batch (as in
     ``test_torch_finetune_slice.py``: the interpret-mode SA trace would
     double this file's time; its parity is ``test_torch_slice.py``'s).
     The K = 2 route equals JAX's K-step executable on the dp=2 mesh
     (``BaseTrainer._build_train_k``: one ``lax.scan`` over the stacked
     batches, sharded along their batch axis as the JAX trainer shards
     them) at the same tolerances, each step's losses and the parameters
     after both steps; there the PointNet++ stands in with the port's
     features of each batch, picked by comparing the input with the first
     batch's.
  3. Losses whose denominators depend on the data (``lm_cls_loss``,
     ``_masked_obj_ce``), the fixed-count means and the contrastive losses
     through ``all_gather_rows``, with rank 0's rows masking far more than
     rank 1's: the ranks' shares sum to the one-process loss and each
     rank's input gradient is its rows of the one-process gradient, within
     REL.
  4. ``record()`` of ``PretrainEval`` and ``ScanReferEval`` over uneven
     shards (4 and 3 items) equals one process updated with the same
     batches; ``eval.save`` writes every rank's rows, once, on rank 0.
  5. The train loader's and the materialized loader's batches of the two
     ranks, concatenated, are the one-process batches item for item; the
     eval loader's shards are contiguous and cover every item once.
  6. ``run_torch.main`` on both ranks for 2 steps, a checkpoint, and a
     resume for 2 more: one ``metrics.jsonl`` row per step, rank 0 the
     only checkpoint writer, the resumed state equal on both ranks.
"""

import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import _torch_ddp_worker as W

# f32 in another summation order (see the module docstring)
REL = 1e-5
# the fused route against its own sensitivity to the summation order (the
# module docstring): loss relative, gradients relative L2, statistics
# relative, parameters in units of lr (Adam's bound is 2)
FUSED_TOL = {"loss": 2e-3, "grad_l2": 0.25, "stat": 2e-3, "param_lr": 2.0}
EXACT_STATS = ("point_encoder.point_feature_extractor.encoder.0.",
               "point_encoder.point_feature_extractor.encoder.1.mlps.0."
               "layer0.")
ROUTES = list(W.ROUTES)
# per route: the logged losses and the train metrics held against the world
# of 1, and the least number of optimised tensors that must have moved
GPS_ROW = (("total_loss", "lm_cls_loss", "TextObjWithinBatch",
            "TextSceneBetweenBatch"), ("lang_cls_acc_mask", "obj_cls_raw_acc"),
           50)
ROW = {route: GPS_ROW for route in ROUTES}
ROW["objcls"] = (("total_loss", "obj_cls_loss"), ("accuracy",), 30)
# the K-step routes: chunk lengths through train_forward_backward_k and
# optimizer steps
K_ROUTES = {"frozen_k2": ([2], 2), "frozen_k3_accum": ([3, 3], 3)}
# the ObjCls route's gradients (relative L2) and parameters (in units of
# lr), against a ReLU decision that lands the other way (module docstring)
OBJCLS_TOL = {"grad_l2": 1e-2, "param_lr": 2.0}
TIMEOUT_S = 180


def _flat(state) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                 for p in path]
        if names[-1] == "value":
            names.pop()
        out[".".join(names)] = np.asarray(leaf)
    return out


class _Features(nnx.Module):
    """Stands in for the frozen JAX PointNet++ with given features."""

    def __init__(self, feats):
        self.feats = nnx.Variable(jnp.asarray(feats))

    def __call__(self, x):
        return self.feats[...]


class _TwoFeatures(nnx.Module):
    """Stands in for the frozen JAX PointNet++ over two batches: the first
    batch's features when the input is the first batch's, else the
    second's."""

    def __init__(self, x0, f0, f1):
        self.x0 = nnx.Variable(jnp.asarray(x0))
        self.f0 = nnx.Variable(jnp.asarray(f0))
        self.f1 = nnx.Variable(jnp.asarray(f1))

    def __call__(self, x):
        return jnp.where(jnp.all(x == self.x0[...]), self.f0[...],
                         self.f1[...])


def _jax_dp2_k(cfg, model, batches):
    """``len(batches)`` GPS train steps through the JAX trainer's K-step
    executable (``BaseTrainer._build_train_k``) on JAX's dp=2 mesh, the
    stacked batches sharded along axis 1 (``shard_batch(..., axis=1)``,
    as its ``train_forward_backward_k``): (per-step losses, port-named
    params)."""
    import types

    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu.parallel.mesh import (mesh_from_cfg, shard_batch,
                                              shard_module)
    from sceneverse_tpu.trainer.build import BaseTrainer, _stack_batches
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    mesh = mesh_from_cfg(cfg)
    assert mesh.shape == {"dp": 2, "mp": 1}
    for _, m in nnx.iter_modules(model):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    model.train()
    loss_mod, tx, _, _ = build_optim(cfg, model, total_steps=len(batches))
    optimizer = nnx.Optimizer(model, tx, wrt=nnx.Param)
    shard_module(model, mesh)
    shard_module(optimizer, mesh)
    host = types.SimpleNamespace(model=model, optimizer=optimizer,
                                 loss=loss_mod, _train_state=None)
    train_k = BaseTrainer._build_train_k(host, lambda d: {}, len(batches))
    stacked = shard_batch(_stack_batches(batches), mesh, axis=1)
    with mesh:
        _, losses, state = train_k(host._train_state, stacked)
        jax.block_until_ready(losses)
    model, _ = nnx.merge(host._graphdef, state)
    return ({k: np.asarray(v) for k, v in losses.items()},
            from_jax_params(_flat(nnx.state(model, nnx.Param))))


def _jax_dp2_step(cfg, model, batch):
    """One GPS train step on JAX's dp=2 mesh: (loss, port-named params)."""
    from sceneverse_tpu.optim.build import build_optim
    from sceneverse_tpu.parallel.mesh import (mesh_from_cfg, shard_batch,
                                              shard_module)
    from sceneverse_tpu_torch.ckpt.convert import from_jax_params

    mesh = mesh_from_cfg(cfg)
    assert mesh.shape == {"dp": 2, "mp": 1}
    for _, m in nnx.iter_modules(model):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    model.train()
    loss_mod, tx, _, _ = build_optim(cfg, model, total_steps=1)
    optimizer = nnx.Optimizer(model, tx, wrt=nnx.Param)
    shard_module(model, mesh)
    shard_module(optimizer, mesh)
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
def ddp(tmp_path_factory):
    """(the world of 1's results, the two ranks' results, the directory)."""
    from sceneverse_tpu.config import load_config as jload
    from sceneverse_tpu.data.build import get_dataset, numpy_collate
    from sceneverse_tpu.model import build_model as jbuild
    from sceneverse_tpu_torch.ckpt.convert import (apply_state_dict,
                                                   from_jax_params)
    from sceneverse_tpu_torch.data.build import build_dataloader
    from sceneverse_tpu_torch.data.fixture import write_synthetic_tree
    from sceneverse_tpu_torch.model import build_model as tbuild

    base = tmp_path_factory.mktemp("ddp")
    tree = write_synthetic_tree(base / "tree", n_scans=2, n_objects=10,
                                pts_per_obj=40)
    spec = {"out": str(base), "weights": str(base / "weights.pt"),
            "tree": str(tree)}
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENEVERSE_FUSED_MHA", "off")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=W.run,
                             args=(r, 2, str(base / "init"), spec))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            torch.set_num_threads(2)  # beside the two ranks
            # the JAX model; its weights (written whole, then renamed) are
            # the frozen route's on every rank
            jcfg = jload(W.CFG, W.STEP + ["num_gpu=2"])
            jm = jbuild(jcfg, rngs=nnx.Rngs(0))
            jm_k = nnx.clone(jm)  # the same weights, for the K-step run
            weights = from_jax_params(_flat(nnx.state(jm, nnx.Not(
                nnx.RngState))))
            torch.save(weights, base / "weights.tmp")
            os.replace(base / "weights.tmp", base / "weights.pt")
            one = {"routes": {name: W.route_step(
                name, base / f"one_{name}",
                spec["weights"] if name.startswith("frozen") else None)
                for name in ROUTES}}
            one["losses"] = W.loss_cases()
            one["eval"] = W.eval_record(
                W.eval_batches(2, 0) + W.eval_batches(2, 1), base / "one_eval")
            one["loaders"] = W.loader_batches()
            one["materialized"] = W.materialized_batches(tree,
                                                         base / "one_stores")
            tcfg = W._cfg(W.STEP)
            tm = tbuild(tcfg)
            apply_state_dict(tm, weights)

            def host_batches(over):
                """The JAX dataset's items in the port's train-loader
                order, with the port's PointNet++ features of each."""
                out = []
                for b in build_dataloader(W._cfg(W.STEP + over), "train"):
                    ds = get_dataset(jload(W.CFG, W.STEP + over
                                           + ["num_gpu=2"]), "train")
                    batch = {k: v for k, v in numpy_collate(
                        [ds[int(i)] for i in b["data_idx"]]).items()
                        if isinstance(v, np.ndarray)}
                    with torch.no_grad():
                        fts = torch.from_numpy(batch["obj_fts"])
                        feats = tm.point_encoder.point_feature_extractor(
                            fts.reshape(-1, *fts.shape[2:])).numpy()
                    out.append((batch, feats))
                return out

            ((batch, feats),) = host_batches([])
            jm.point_encoder.point_feature_extractor = _Features(feats)
            one["jax"] = _jax_dp2_step(jcfg, jm, batch)
            k_over = W.ROUTES["frozen_k2"][0]
            (b0, f0), (b1, f1) = host_batches(k_over)
            fts = b0["obj_fts"]
            jm_k.point_encoder.point_feature_extractor = _TwoFeatures(
                fts.reshape(-1, *fts.shape[2:]), f0, f1)
            one["jax_k2"] = _jax_dp2_k(
                jload(W.CFG, W.STEP + k_over + ["num_gpu=2"]), jm_k,
                [b0, b1])
        finally:
            torch.set_num_threads(threads)
            for p in procs:
                p.join(TIMEOUT_S)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return one, ranks, base


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_two_ranks_ran(ddp):
    _, ranks, _ = ddp
    assert [(r["world"], r["rank"]) for r in ranks] == [(2, 0), (2, 1)]


@pytest.mark.parametrize("route", ROUTES)
def test_route_losses_match_one_rank(ddp, route):
    one, ranks, _ = ddp
    rows = one["routes"][route]["rows"]
    tol = FUSED_TOL["loss"] if route == "unfrozen_fused" else REL
    for r in ranks:
        assert len(r["routes"][route]["rows"]) == len(rows)
        for step, (got, want) in enumerate(zip(r["routes"][route]["rows"],
                                               rows)):
            assert set(got) == set(want)
            for k in ROW[route][0]:
                assert abs(got[k] - want[k]) <= tol * max(
                    1.0, abs(want[k])), (step, k)
    # the train metrics: the global batch's (value, count) pairs summed
    for step, want in enumerate(rows):
        for k in ROW[route][1]:
            assert ranks[0]["routes"][route]["rows"][step][k] == \
                pytest.approx(want[k], abs=1e-6), (step, k)


@pytest.mark.parametrize("route", K_ROUTES)
def test_k_routes_dispatch_chunks_on_every_rank(ddp, route):
    """Each chunk of the K-step routes took ``train_forward_backward_k``
    in both worlds, with the updates of single steps."""
    one, ranks, _ = ddp
    chunks, updates = K_ROUTES[route]
    for res in [one] + ranks:
        got = res["routes"][route]
        assert got["chunks"] == chunks
        assert got["updates"] == updates
        assert len(got["rows"]) == sum(chunks)


@pytest.mark.parametrize("route", ROUTES)
def test_route_summed_gradients_match_one_rank(ddp, route):
    one, ranks, _ = ddp
    want = one["routes"][route]["grad"]
    gmax = max(g.abs().max().item() for g in want.values())
    assert gmax > 0
    fused = route == "unfrozen_fused"
    chaotic = fused or route == "objcls"
    for r in ranks:
        got = r["routes"][route]["grad"]
        assert set(got) == set(want)
        diff = torch.cat([(got[n] - want[n]).reshape(-1) for n in want])
        norm = torch.cat([want[n].reshape(-1) for n in want]).norm()
        assert (diff.norm() / norm).item() <= (
            FUSED_TOL["grad_l2"] if fused else
            OBJCLS_TOL["grad_l2"] if chaotic else REL)
        for n in want if not chaotic else ():
            # REL per tensor; the floor covers the tensors whose exact
            # gradient is zero (the key projections' biases)
            assert (got[n] - want[n]).abs().max().item() <= \
                REL * want[n].abs().max().item() + 1e-7 * gmax, n
    if not route.startswith("frozen"):  # the PointNet++ trains
        assert any("point_feature_extractor." in n for n in want)


@pytest.mark.parametrize("route", ROUTES)
def test_route_params_after_adamw_match_one_rank(ddp, route):
    one, ranks, _ = ddp
    want = one["routes"][route]["param"]
    lr = one["routes"][route]["lr"]
    updates = one["routes"][route]["updates"]
    a, b = (r["routes"][route]["param"] for r in ranks)
    fused = route == "unfrozen_fused"
    chaotic = fused or route == "objcls"
    moved = 0
    for n in want:
        assert torch.equal(a[n], b[n]), n  # the ranks agree bit for bit
        if lr.get(n) is None:  # not optimised: as loaded on both sides
            assert torch.equal(a[n], want[n]), n
            continue
        units = ((a[n] - want[n]).abs()
                 - REL * want[n].abs().max()) / (lr[n] * updates)
        assert units.max().item() <= (
            FUSED_TOL["param_lr"] if fused else OBJCLS_TOL["param_lr"]
            if chaotic else 0.25), (n, units.max().item())
        if not chaotic:
            assert (units > 0.01).float().mean().item() <= 1e-3, n
        moved += 1
    assert moved > ROW[route][2]


@pytest.mark.parametrize("route", ROUTES)
def test_route_batchnorm_statistics_match_one_rank(ddp, route):
    one, ranks, _ = ddp
    want = one["routes"][route]["buffer"]
    a, b = (r["routes"][route]["buffer"] for r in ranks)
    stats = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 18
    for n in want:
        assert torch.equal(a[n], b[n]), n
    for n in stats:
        exact = route != "unfrozen_fused" or n.startswith(EXACT_STATS)
        assert _rel(a[n], want[n]) <= (REL if exact else FUSED_TOL["stat"]), n
    if not route.startswith("frozen"):  # train-mode BatchNorm moved them
        assert all(want[n].abs().max() > 0 for n in stats
                   if n.endswith("running_mean"))


def test_frozen_route_matches_jax_dp2_step(ddp):
    one, ranks, _ = ddp
    jloss, jparams = one["jax"]
    for r in ranks:
        route = r["routes"]["frozen"]
        assert route["row"]["total_loss"] == pytest.approx(jloss, abs=1e-4)
        for n, want in jparams.items():
            np.testing.assert_allclose(route["param"][n].numpy(),
                                       want.numpy(), atol=5e-5, rtol=1e-4,
                                       err_msg=n)
        assert len(jparams) > 50


def test_frozen_k2_route_matches_jax_dp2_k_steps(ddp):
    """Both ranks' K = 2 chunk against JAX's K-step executable on its dp=2
    mesh: each step's logged losses within 1e-4, the parameters after the
    two AdamW steps within atol 5e-5, rtol 1e-4 (item 2)."""
    one, ranks, _ = ddp
    jlosses, jparams = one["jax_k2"]
    assert len(jparams) > 50
    for r in ranks:
        route = r["routes"]["frozen_k2"]
        assert route["chunks"] == [2]
        for k in ROW["frozen_k2"][0]:
            got = [row[k] for row in route["rows"]]
            np.testing.assert_allclose(got, jlosses[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        for n, want in jparams.items():
            np.testing.assert_allclose(route["param"][n].numpy(),
                                       want.numpy(), atol=5e-5, rtol=1e-4,
                                       err_msg=n)


@pytest.mark.parametrize("name", W.LOSSES)
def test_loss_shares_sum_to_the_global_loss(ddp, name):
    one, ranks, _ = ddp
    want, want_grads = one["losses"][name]
    assert want > 0
    for r in ranks:
        got, _ = r["losses"][name]
        assert abs(got - want) <= REL * max(1.0, abs(want)), (got, want)
    keys = set(want_grads)
    assert keys and all(set(r["losses"][name][1]) == keys for r in ranks)
    for k in keys:
        got = torch.cat([r["losses"][name][1][k] for r in ranks])
        assert _rel(got, want_grads[k]) <= REL, k


def test_masked_counts_differ_between_ranks():
    """The loss case's point: a per-rank ratio averaged over the ranks is
    not the global ratio here."""
    d = W._loss_inputs()
    per_rank = [(d["masked_lm_labels"][s] != -1).sum() for s in
                (slice(0, 2), slice(2, 4))]
    assert per_rank[0] >= 4 * per_rank[1] > 0


@pytest.mark.parametrize("name", ["PretrainEval", "ScanReferEval"])
def test_evaluator_record_over_uneven_shards(ddp, name):
    one, ranks, _ = ddp
    want = one["eval"][name]
    for r in ranks:
        got = r["eval"][name]
        assert set(got) == set(want)
        for k in want:
            # f32 sums of the batches on each rank, added in float64
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k
    assert [len(W.eval_batches(2, r)) for r in range(2)] == [2, 2]


def test_eval_save_writes_every_rank_rows_once(ddp):
    one, ranks, _ = ddp
    assert len(one["eval"]["rows"]) == W.N_EVAL
    assert ranks[0]["eval"]["rows"] == one["eval"]["rows"]


def test_train_loader_rows_concatenate_to_the_one_process_batch(ddp):
    one, ranks, _ = ddp
    want = one["loaders"]["train"]
    assert len(want) == 2
    for i, (idx, fts) in enumerate(want):
        got = [r["loaders"]["train"][i] for r in ranks]
        assert [len(g[0]) for g in got] == [2, 2]
        np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                      idx)
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                      fts)


def test_eval_loader_shards_cover_every_item_once(ddp):
    one, ranks, _ = ddp
    want = np.concatenate(one["loaders"]["val"])
    got = [np.concatenate(r["loaders"]["val"]) for r in ranks]
    assert [len(g) for g in got] == [4, 3]
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_materialized_rows_concatenate_to_the_one_process_batch(ddp):
    one, ranks, _ = ddp
    assert len(one["materialized"]) == 2
    for i, want in enumerate(one["materialized"]):
        for k, v in want.items():
            got = np.concatenate([r["materialized"][i][k] for r in ranks])
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_entry_point_logs_one_row_per_step(ddp):
    _, ranks, base = ddp
    assert all(r["entry"]["steps"] == [2, 2] for r in ranks)
    with open(base / "entry" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r["_step"] for r in rows if "train/total_loss" in r]
    assert steps == [1, 2, 3, 4]


def test_entry_point_has_one_checkpoint_writer(ddp):
    _, ranks, base = ddp
    writes = [r["entry"]["writes"] for r in ranks]
    assert writes[1] == []
    assert {"ckpt_1.pth", "ckpt_2.pth"} <= set(writes[0])
    names = sorted(os.listdir(base / "entry" / "ckpt"))
    assert "ckpt_1.pth" in names and not any(
        n.endswith(".tmp") for n in names)


def test_entry_point_resumes_the_same_state_on_both_ranks(ddp):
    _, ranks, _ = ddp
    a, b = (r["entry"] for r in ranks)
    assert a["resumed_from"] == b["resumed_from"]
    assert a["resumed_from"].endswith(".pth")
    assert a["step_count"] == b["step_count"] == 4
    assert set(a["state"]) == set(b["state"])
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k

"""Training cells: the trainer's own train loop
(``DefaultTrainer.train_step``, K = ``solver.steps_per_dispatch`` steps a
dispatch through ``train_forward_backward_k``) fed from the pool.

Set-up runs three dispatches on rows that all differ (pool batches 0 to 3K
- 1): the first runs eagerly (the program's warm-up of a graph key), the
second captures the CUDA graph and replays it, the third is a replay on
newly staged rows, as every dispatch of the window is. The check reads
the state after those 3K steps: every step's losses, AdamW's first moment
and the parameters' change, against the reference's 3K steps from the same
weights, batches and dropout streams (``harness/check.py``). Over a
data-parallel world each rank is fed its block of every batch."""

from __future__ import annotations

import math

import torch

from benchmark.harness import check, program, traffic

RATE = ("train_scenes_per_s", "scenes/s")
ENTRY = "train_forward_backward_k"
TRAIN = True
SETUP_DISPATCHES = 3


def _k(cell):
    return int(cell.config["run"]["solver"]["steps_per_dispatch"])


def _loss_names(cell):
    return list(cell.config["run"]["model"]["loss_list"]) + ["total_loss"]


class Mode:
    def __init__(self, ctx):
        self.ctx, self.cell = ctx, ctx.cell
        self.K = _k(self.cell)
        self.epoch = 0

    def setup(self, mark):
        ctx, cell = self.ctx, self.cell
        self.trainer = program.build(cell.config, ctx.seed, ctx.device,
                                     str(ctx.build / "runs" / cell.name))
        if ctx.fault:
            ctx.fault(self.trainer)
        mark("model_build")
        ref = cell.reference
        W = ref.weights(cell.config, ctx.seed, ctx.device)
        self.init = {n: W[n].cpu() for n in ref.optimised(cell.config)}
        program.load_weights(self.trainer, W)
        del W
        self.pool = traffic.draw_pool(cell.traffic, ctx.seed + 1, ctx.device)
        ctx.sync()
        mark("input_draw")
        n = SETUP_DISPATCHES * self.K
        for d in range(SETUP_DISPATCHES):
            self._train(program.Feed(self.pool, self.K, d * self.K,
                                     count=self.K, rows=ctx.rows))
        ctx.sync()
        self.snap = self._snapshot(n)
        del self.init
        self.next = n
        mark("warm_up")

    def _train(self, feed):
        self.trainer.data_loaders["train"] = feed
        self.trainer.train_step(self.epoch)
        self.epoch += 1

    @torch.no_grad()
    def _snapshot(self, n):
        t = self.trainer
        rows = t.history["train"][-n:]
        names = _loss_names(self.cell)
        opt = t.optimizer
        state, ids = opt.opt.state, {id(p) for p in opt.params}
        named = {k: p for k, p in t.model.named_parameters() if id(p) in ids}
        moments = {k: state[p]["exp_avg"] for k, p in named.items()
                   if p in state and "exp_avg" in state[p]}
        snap = check.train_state(named, self.init, moments)
        snap["losses"] = [{k: r.get(k, math.nan) for k in names}
                          for r in rows]
        return snap

    def window(self, seconds, t0):
        ctx = self.ctx
        rows0 = len(self.trainer.history["train"])
        feed = program.Feed(self.pool, self.K, self.next, rows=ctx.rows,
                            deadline=t0 + seconds, stop=ctx.stop)
        with program.HostTimer(self.trainer, ENTRY) as timer:
            self._train(feed)
            ctx.sync()
        self.next += len(feed.served)
        failed = sum(not math.isfinite(r.get("total_loss", math.nan))
                     for r in self.trainer.history["train"][rows0:])
        return feed.served, failed, timer.s

    def traced(self, n_dispatches):
        feed = program.Feed(self.pool, self.K, self.next,
                            count=n_dispatches * self.K, rows=self.ctx.rows)
        self._train(feed)
        self.ctx.sync()
        self.next += len(feed.served)
        return feed.served

    def snapshot(self):
        return self.snap

    def close(self):
        del self.trainer


def reference(cell, seed, device, world=1, tf32=False, rows=None):
    """The reference's snapshot of set-up's 3K steps (``rows`` keeps each
    batch's first rows only: a fault)."""
    ref = cell.reference
    K = _k(cell)
    pool = traffic.draw_pool(dict(cell.traffic, pool=SETUP_DISPATCHES * K),
                             seed + 1, device)
    W = ref.weights(cell.config, seed, device)
    names = ref.optimised(cell.config)
    init = {n: W[n].clone() for n in names}
    batches = (traffic.to_device(b if rows is None else
                                 {k: v[:rows] for k, v in b.items()}, device)
               for b in pool)
    losses, moments = ref.train(W, batches, cell.config, seed, device,
                                tf32=tf32, world=world)
    snap = check.train_state({n: W[n] for n in names}, init, moments)
    keep = _loss_names(cell)
    snap["losses"] = [{k: r[k] for k in keep} for r in losses]
    return snap


def check_run(cell, seed, device, snaps, world):
    """The readings of a run: rank 0's snapshot (every rank holds the same
    parameters and the logged losses are the world's) against the
    reference's."""
    return check.train_readings(snaps[0], reference(cell, seed, device,
                                                    world=world))


def control(cell, seed, device):
    """The control and a fault, each against the sound reference: the
    reference in TF32 (``tf32``), and over half of each batch
    (``half_batch``). A step that leaves the state unchanged reads 1 on
    ``grad`` and ``change`` by their definition."""
    sound = reference(cell, seed, device)
    out = {}
    for name, kw in (("tf32", {"tf32": True}),
                     ("half_batch", {"rows": int(cell.traffic["batch"]) // 2})):
        out[name] = check.train_readings(reference(cell, seed, device, **kw),
                                         sound)
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()
    return out

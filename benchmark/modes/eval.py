"""Evaluation cells: the trainer's fused evaluation (``eval_fused`` ->
``eval_metrics_k``, ``solver.eval_steps_per_dispatch`` = K batches a
dispatch, the model's forward and the evaluator's (value, count) sums)
fed from the pool, the sums accumulated into the configuration's
evaluator and fetched once (``record``) at the window's end.

The program's metrics function is wrapped (``Capture``): it returns the
evaluator's sums unchanged and copies each batch's answer output (the
configuration reference's ``ANSWER``, the og3d logits) into a buffer that
the CUDA graph writes again on every replay; after each dispatch the copy
is kept. Set-up runs two dispatches (eager, then captured and replayed);
the window's are replays on newly staged rows. Every dispatch's answers and
sums are checked once the window has closed, against the reference's
evaluation forward of each pool batch (``harness/check.py``)."""

from __future__ import annotations

import torch

from benchmark.harness import check, program, traffic

RATE = ("eval_scenes_per_s", "scenes/s")
ENTRY = "eval_metrics_k"
TRAIN = False
SETUP_DISPATCHES = 2


def _k(cell):
    s = cell.config["run"]["solver"]
    return int(s.get("eval_steps_per_dispatch", s["steps_per_dispatch"]))


class Capture:
    """The evaluator's metrics function, and a copy of each batch's
    ``key`` output into slot j of a (K, ...) buffer."""

    def __init__(self, inner, key, k):
        self.inner, self.key, self.k = inner, key, k
        self.buf, self.calls = None, 0

    def __call__(self, d, include_count=False):
        x = d[self.key]
        if self.buf is None:
            self.buf = torch.empty((self.k, *x.shape), dtype=x.dtype,
                                   device=x.device)
        self.buf[self.calls % self.k].copy_(x)
        self.calls += 1
        return self.inner(d, include_count=include_count)


class Recorder:
    """Stands where the evaluator stands in ``eval_fused``: passes each
    dispatch's sums to it and keeps them with the dispatch's answers."""

    def __init__(self, evaluator, capture):
        self.evaluator, self.capture = evaluator, capture
        self.dispatches = []

    def update_sums(self, sums):
        self.evaluator.update_sums(sums)
        self.dispatches.append((sums, self.capture.buf.clone()))


class Mode:
    def __init__(self, ctx):
        self.ctx, self.cell = ctx, ctx.cell
        self.K = _k(self.cell)
        self.served = []

    def setup(self, mark):
        ctx, cell = self.ctx, self.cell
        t = self.trainer = program.build(cell.config, ctx.seed, ctx.device,
                                         str(ctx.build / "runs" / cell.name))
        if ctx.fault:
            ctx.fault(t)
        ev = t._val_evaluator()
        ev = ev[0] if isinstance(ev, list) else ev
        fused = t._fusable_metrics(ev)
        if fused is None:
            raise SystemExit(f"{cell.name}: the evaluator's metrics do not "
                             "fuse into the eval dispatch")
        self.capture = Capture(fused, cell.reference.ANSWER, self.K)
        self.recorder = Recorder(ev, self.capture)
        mark("model_build")
        program.load_weights(t, cell.reference.weights(cell.config, ctx.seed,
                                                       ctx.device))
        self.pool = traffic.draw_pool(cell.traffic, ctx.seed + 1, ctx.device)
        ctx.sync()
        mark("input_draw")
        self.next = 0
        for _ in range(SETUP_DISPATCHES):
            self._eval(program.Feed(self.pool, self.K, self.next,
                                    count=self.K, rows=ctx.rows))
        ctx.sync()
        mark("warm_up")

    def _eval(self, feed):
        t = self.trainer
        t.eval_fused(self.recorder, feed, self.capture)
        self.recorder.evaluator.record()
        self.recorder.evaluator.reset()
        self.next += len(feed.served)
        self.served += feed.served

    def window(self, seconds, t0):
        ctx = self.ctx
        feed = program.Feed(self.pool, self.K, self.next, rows=ctx.rows,
                            deadline=t0 + seconds, stop=ctx.stop)
        n0 = len(self.recorder.dispatches)
        with program.HostTimer(self.trainer, ENTRY) as timer:
            self._eval(feed)
            ctx.sync()
        # a dispatch whose answers hold a NaN (pads are -inf by design)
        failed = sum(int(torch.isnan(out).any())
                     for _, out in self.recorder.dispatches[n0:])
        return feed.served, failed, timer.s

    def traced(self, n_dispatches):
        feed = program.Feed(self.pool, self.K, self.next,
                            count=n_dispatches * self.K, rows=self.ctx.rows)
        self._eval(feed)
        self.ctx.sync()
        return feed.served

    def snapshot(self):
        """[(pool indices, answers (K, ...) on the host, {metric: (value,
        count)})] of every dispatch."""
        out, K = [], self.K
        for d, (sums, ans) in enumerate(self.recorder.dispatches):
            idx = self.served[d * K:(d + 1) * K]
            out.append((idx, ans.cpu(), {n: (float(v), float(c))
                                         for n, (v, c) in sums.items()}))
        return out

    def close(self):
        del self.trainer, self.recorder, self.capture


def reference(cell, seed, device, indices, tf32=False, rows=None):
    """{pool index: (batch on the device, answer output)} of
    the reference's evaluation forward over the pool batches ``indices``
    (``rows`` keeps each batch's first rows only: a fault)."""
    ref = cell.reference
    pool = traffic.draw_pool(cell.traffic, seed + 1, device)
    W = ref.weights(cell.config, seed, device)
    out = {}
    for i in sorted(set(indices)):
        b = pool[i] if rows is None else {k: v[:rows]
                                          for k, v in pool[i].items()}
        batch = traffic.to_device(b, device)
        out[i] = (batch, ref.evaluate(W, batch, cell.config, tf32=tf32))
    return out


def _readings(cell, prog, ref):
    r = cell.reference
    return check.eval_readings(prog, ref, r.answer_sums, r.answer_valid)


def check_run(cell, seed, device, snaps, world):
    """Every dispatch's answers and sums (each rank's rows joined) against
    the reference's forward of its pool batches."""
    prog = [(idx, torch.cat([s[d][1] for s in snaps], 1),
             {n: tuple(sum(s[d][2][n][i] for s in snaps) for i in (0, 1))
              for n in snaps[0][d][2]})
            for d, (idx, _, _) in enumerate(snaps[0])]
    ref = reference(cell, seed, device, [i for idx, _, _ in prog
                                         for i in idx])
    return _readings(cell, prog, ref)


def control(cell, seed, device):
    """The control and a fault, each in the program's place against the
    sound reference over a chunk of K pool batches: the reference in TF32
    (``tf32``), and over half of each batch (``half_batch``)."""
    K = _k(cell)
    idx = list(range(K))
    sound = reference(cell, seed, device, idx)
    out = {}
    for name, kw in (("tf32", {"tf32": True}),
                     ("half_batch", {"rows": int(cell.traffic["batch"]) // 2})):
        got = reference(cell, seed, device, idx, **kw)
        prog = [(idx, torch.stack([got[i][1] for i in idx]),
                 _program_sums(cell, got, idx))]
        out[name] = _readings(cell, prog, sound)
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()
    return out


def _program_sums(cell, got, idx):
    """The sums a program in the reference's place would return."""
    acc = {}
    for i in idx:
        batch, ans = got[i]
        for n, (v, c) in cell.reference.answer_sums(ans, batch).items():
            a = acc.setdefault(n, [0, 0])
            a[0], a[1] = a[0] + v, a[1] + c
    return {n: tuple(a) for n, a in acc.items()}

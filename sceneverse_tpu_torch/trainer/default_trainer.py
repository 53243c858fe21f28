"""Epoch-loop trainer (port of sceneverse_tpu/trainer/default_trainer.py;
reference trainer/default_trainer.py:10-104).

Each train step's losses and metrics stay device scalars; every
``solver.log_every`` steps (default 10) ``flush_train_logs`` fetches them in
one copy and writes one row per step. With ``profile.enabled`` the first
``profile.steps`` steps of epoch 0 run under ``utils/profiling.py::trace``
and end that epoch, as in the JAX package; a window whose trace holds fewer
of the port's kernels than it launched (``TraceWindow.complete`` false) is
traced again over the next ``profile.steps`` steps, up to PROFILE_WINDOWS
windows, and the epoch ends after the first complete one (a window of
steps cannot run twice); ``profile_windows`` keeps every window traced. Every epoch saves
``latest.pth``, ``best.pth`` when the val metric improved and
``ckpt_N.pth`` every ``solver.epochs_per_save`` epochs; ``run`` drains the
asynchronous saves before it returns.

The loops are the JAX package's (``default_trainer.py:44-129``): the
train loop takes ``solver.steps_per_dispatch`` = K batches a chunk and
runs a whole chunk through ``train_forward_backward_k`` (one CUDA graph
replay on the card in a world of 1, the K steps in a row over a dp x mp
world) when the train evaluator's metrics fuse into the step;
a tail chunk of fewer than K batches, and every chunk when they do not
fuse, takes the single-step path. The eval loop sends a split through
``eval_fused`` when its evaluator's metrics fuse, else through the eager
forward and ``update`` per batch.
"""

from __future__ import annotations

import time

from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints
from sceneverse_tpu_torch.parallel import mesh
from sceneverse_tpu_torch.trainer.build import TRAINER_REGISTRY, BaseTrainer
from sceneverse_tpu_torch.utils.profiling import trace

PROFILE_WINDOWS = 3  # profile windows tried before an incomplete trace raises


@TRAINER_REGISTRY.register()
class DefaultTrainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self.best_metric = -1
        self.profile_windows = []  # the TraceWindows of profile.enabled

    def _train_evaluator(self):
        return self.evaluator

    def _val_evaluator(self):
        return self.evaluator

    def _annotate_batch(self, batch: dict, cur_step: int) -> dict:
        # schedules that read the step (reference default_trainer.py:32-33)
        batch["cur_step"] = cur_step
        batch["total_steps"] = self.total_steps
        return batch

    def train_step(self, epoch: int):
        loader = self.data_loaders["train"]
        n = len(loader)
        evaluator = self._train_evaluator()
        profiling = self.profile_enabled and epoch == 0
        log_every = max(1, int(self.cfg.solver.get("log_every", 10)))
        exp_dir = self.cfg.get("exp_dir") or "."
        spd = self.steps_per_dispatch
        fused = self._fusable_metrics(evaluator)
        pending = []

        def single(host, i):
            t0 = time.perf_counter()
            batch = self._annotate_batch(self.device_batch(host), epoch * n + i)
            if fused is not None:
                metrics, losses = self.train_forward_backward(batch, fused)
            else:
                out, losses = self.train_forward_backward(batch)
                # over a data-parallel world the (value, count) pairs, which
                # flush_train_logs sums over the ranks
                metrics = evaluator.batch_metrics(
                    {**batch, **out}, include_count=mesh.dp_world() > 1)
            self.global_step += 1
            pending.append((self.global_step, {**losses, **metrics}, t0))

        it = iter(loader)

        def steps(i, end):
            """Chunks of ``spd`` batches from step ``i`` until the loader
            ends or, with ``end``, the chunk that reaches step ``end``; the
            pending rows flushed at the end. Returns the steps done."""
            while True:
                chunk = [b for _, b in zip(range(spd), it)]
                if not chunk:
                    break
                if len(chunk) == spd > 1 and fused is not None:
                    t0 = time.perf_counter()
                    hosts = [self._annotate_batch(dict(b), epoch * n + i + j)
                             for j, b in enumerate(chunk)]
                    metrics, losses = self.train_forward_backward_k(hosts,
                                                                    fused)
                    pending.append((self.global_step + 1,
                                    {**losses, **metrics}, t0, spd))
                    self.global_step += spd
                else:
                    for j, b in enumerate(chunk):
                        single(b, i + j)
                i += len(chunk)
                if sum(e[3] if len(e) == 4 else 1
                       for e in pending) >= log_every:
                    self.flush_train_logs(pending)
                    pending.clear()
                if end is not None and i >= end:
                    break
            self.flush_train_logs(pending)
            pending.clear()
            return i

        if not (profiling and n > 0):
            steps(0, None)
            return
        i, self.profile_windows = 0, []
        for window_no in range(1, PROFILE_WINDOWS + 1):
            with trace(f"{exp_dir}/profile") as window:
                i = steps(i, i + self.profile_steps)
            self.profile_windows.append(window)
            if window.complete or i >= n:
                return
            print(f"[profile] window {window_no} traced fewer kernels than "
                  f"the port launched ({window.missing}); tracing the next "
                  f"{self.profile_steps} steps", flush=True)
        raise RuntimeError(f"profile.enabled: {PROFILE_WINDOWS} "
                           "torch.profiler windows in a row traced fewer "
                           f"kernels than the port launched ({window.path}: "
                           f"{window.missing})")

    def _eval_loop(self, split: str, mode: str):
        """Every loader of the split through its evaluator (one evaluator
        serves a list of loaders): each is recorded, logged and reset on its
        own, ``is_best`` is their OR and the results are merged (JAX
        ``default_trainer.py:98-129``). An evaluator whose metrics fuse
        takes ``eval_fused``; ``record`` is the split's one fetch."""
        evaluators = self._val_evaluator()
        loaders = self.data_loaders[split]
        ev_list = evaluators if isinstance(evaluators, list) else [evaluators]
        ld_list = loaders if isinstance(loaders, list) else [loaders]
        if len(ev_list) == 1 and len(ld_list) > 1:
            ev_list = ev_list * len(ld_list)
        is_best, results = False, {}
        for ev, loader in zip(ev_list, ld_list):
            fused = self._fusable_metrics(ev)
            if fused is not None:
                self.eval_fused(ev, loader, fused)
            else:
                for host in loader:
                    batch = self.device_batch(host)
                    # the host batch's lists (string item ids, sentences)
                    # stay beside the tensors, as the JAX evaluators get them
                    ev.update({**host, **batch, **self.forward(batch)})
            best_i, res_i = ev.record()
            is_best = is_best or best_i
            results.update(res_i)
            self.history[split].append(res_i)
            self.log(res_i, mode=mode)
            ev.reset()
        return is_best, results

    def eval_step(self, epoch: int) -> bool:
        is_best, results = self._eval_loop("val", "val")
        if is_best:
            self.best_metric = results["target_metric"]
        return is_best

    def test_step(self) -> dict:
        return self._eval_loop("test", "test")[1]

    def save_epoch(self, epoch: int, is_best: bool):
        self.save("latest.pth")
        if is_best:
            self.save("best.pth")
        if self.epochs_per_save and (epoch + 1) % self.epochs_per_save == 0:
            self.save(f"ckpt_{epoch + 1}.pth")

    def run(self) -> dict:
        if self.mode == "train":
            start_epoch = self.exp_tracker.epoch
            self.global_step = start_epoch * len(self.data_loaders["train"])
            for epoch in range(start_epoch, self.epochs):
                self.exp_tracker.step()
                self.train_step(epoch)
                is_best = False
                if self.epochs_per_eval and (epoch + 1) % self.epochs_per_eval == 0:
                    is_best = self.eval_step(epoch)
                    print(f"[Epoch {epoch + 1}/{self.epochs}] finished eval, "
                          f"is_best: {is_best}", flush=True)
                self.save_epoch(epoch, is_best)
        results = self.test_step()
        self.logger.finish()
        wait_for_checkpoints()  # the epoch saves are on disk at return
        return results

"""Epoch-loop trainer (port of sceneverse_tpu/trainer/default_trainer.py;
reference trainer/default_trainer.py:10-104).

Each train step's losses and metrics stay device scalars; every
``solver.log_every`` steps (default 10) ``flush_train_logs`` fetches them in
one copy and writes one row per step. With ``profile.enabled`` the first
``profile.steps`` steps of epoch 0 run under ``utils/profiling.py::trace``
and end that epoch, as in the JAX package. Every epoch saves
``latest.pth``, ``best.pth`` when the val metric improved and
``ckpt_N.pth`` every ``solver.epochs_per_save`` epochs; ``run`` drains the
asynchronous saves before it returns.

``solver.steps_per_dispatch`` and the JAX package's fused eval are
dispatch mechanisms of XLA with the same math as one step (one eval batch)
at a time: the keys are accepted and this trainer runs one step at a time.
Their analog on the card is CUDA graphs (ROADMAP A2).
"""

from __future__ import annotations

import time

from sceneverse_tpu_torch.ckpt.checkpoint import wait_for_checkpoints
from sceneverse_tpu_torch.parallel import mesh
from sceneverse_tpu_torch.trainer.build import (TRAINER_REGISTRY, BaseTrainer,
                                                to_device)
from sceneverse_tpu_torch.utils.profiling import trace


@TRAINER_REGISTRY.register()
class DefaultTrainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self.best_metric = -1

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
        pending = []
        with trace(f"{exp_dir}/profile", enabled=profiling and n > 0):
            for i, batch in enumerate(loader):
                t0 = time.perf_counter()
                batch = self._annotate_batch(to_device(batch, self.device),
                                             epoch * n + i)
                out, losses = self.train_forward_backward(batch)
                # over a data-parallel world the (value, count) pairs, which
                # flush_train_logs sums over the ranks
                metrics = evaluator.batch_metrics(
                    {**batch, **out}, include_count=mesh.dp_world() > 1)
                self.global_step += 1
                pending.append((self.global_step, {**losses, **metrics}, t0))
                if len(pending) >= log_every:
                    self.flush_train_logs(pending)
                    pending = []
                if profiling and i + 1 >= self.profile_steps:
                    break
            self.flush_train_logs(pending)

    def _eval_loop(self, split: str, mode: str):
        """Every loader of the split through its evaluator (one evaluator
        serves a list of loaders): each is recorded, logged and reset on its
        own, ``is_best`` is their OR and the results are merged (JAX
        ``default_trainer.py:102-129``)."""
        evaluators = self._val_evaluator()
        loaders = self.data_loaders[split]
        ev_list = evaluators if isinstance(evaluators, list) else [evaluators]
        ld_list = loaders if isinstance(loaders, list) else [loaders]
        if len(ev_list) == 1 and len(ld_list) > 1:
            ev_list = ev_list * len(ld_list)
        is_best, results = False, {}
        for ev, loader in zip(ev_list, ld_list):
            for host in loader:
                batch = to_device(host, self.device)
                # the host batch's lists (string item ids, sentences) stay
                # beside the tensors, as the JAX evaluators get them
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

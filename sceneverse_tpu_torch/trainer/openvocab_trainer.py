"""GPS pretraining trainer (port of sceneverse_tpu/trainer/default_trainer.py
and openvocab_trainer.py; reference trainer/openvocab_trainer.py:10-113):
PretrainEval metrics during training, ScanReferEval at val and test,
checkpoints best + every-N only."""

from __future__ import annotations

import time

from sceneverse_tpu_torch.trainer.build import (TRAINER_REGISTRY, BaseTrainer,
                                                to_device)


@TRAINER_REGISTRY.register()
class OpenVocabTrainer(BaseTrainer):
    def train_step(self, epoch: int):
        ev = self.evaluator["train"]
        for batch in self.data_loaders["train"]:
            t0 = time.perf_counter()
            batch = to_device(batch, self.device)
            out, losses = self.train_forward_backward(batch)
            metrics = ev.batch_metrics({**batch, **out})
            row = {k: float(v.detach()) for k, v in {**losses, **metrics}.items()}
            self._sync()
            self.global_step += 1
            row["step_s"] = time.perf_counter() - t0
            row["step"] = self.global_step
            self.history["train"].append(row)
            self.log({k: v for k, v in row.items() if k != "step"})

    def _eval_loop(self, split: str):
        """One evaluator serves every loader of the split; each loader is
        recorded, logged and reset on its own, ``is_best`` is their OR and
        the results are merged (JAX ``default_trainer.py:105-129``)."""
        ev = self.evaluator["val"]
        loaders = self.data_loaders[split]
        is_best, results = False, {}
        for loader in (loaders if isinstance(loaders, list) else [loaders]):
            for batch in loader:
                batch = to_device(batch, self.device)
                ev.update({**batch, **self.forward(batch)})
            best_i, res_i = ev.record()
            ev.reset()
            is_best = is_best or best_i
            results.update(res_i)
            self.history[split].append(res_i)
            self.log(res_i, mode=split)
        return is_best, results

    def eval_step(self, epoch: int) -> bool:
        return self._eval_loop("val")[0]

    def test_step(self) -> dict:
        return self._eval_loop("test")[1]

    def run(self) -> dict:
        if self.mode == "train":
            for epoch in range(self.exp_tracker.epoch, self.epochs):
                self.exp_tracker.step()
                self.train_step(epoch)
                is_best = False
                if self.epochs_per_eval and (epoch + 1) % self.epochs_per_eval == 0:
                    is_best = self.eval_step(epoch)
                    print(f"[Epoch {epoch + 1}/{self.epochs}] finished eval, "
                          f"is_best: {is_best}", flush=True)
                if is_best:
                    self.save("best.pth")
                if self.epochs_per_save and (epoch + 1) % self.epochs_per_save == 0:
                    self.save(f"ckpt_{epoch + 1}.pth")
        results = self.test_step()
        self.logger.finish()
        return results

"""GPS pretraining trainer (port of sceneverse_tpu/trainer/openvocab_trainer.py;
reference trainer/openvocab_trainer.py:10-113): ``DefaultTrainer``'s loop
with a {"train", "val"} evaluator dict (PretrainEval during training,
ScanReferEval at val and test) and checkpoints best + every-N only, never
``latest.pth``, so a resume takes the newest ``ckpt_N.pth`` or
``best.pth``."""

from __future__ import annotations

from sceneverse_tpu_torch.trainer.build import TRAINER_REGISTRY
from sceneverse_tpu_torch.trainer.default_trainer import DefaultTrainer


@TRAINER_REGISTRY.register()
class OpenVocabTrainer(DefaultTrainer):
    def _train_evaluator(self):
        return self.evaluator["train"]

    def _val_evaluator(self):
        return self.evaluator["val"]

    def save_epoch(self, epoch: int, is_best: bool):
        # reference :104-109: best + every-N only
        if is_best:
            self.save("best.pth")
        if self.epochs_per_save and (epoch + 1) % self.epochs_per_save == 0:
            self.save(f"ckpt_{epoch + 1}.pth")

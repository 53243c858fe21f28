"""Object-classification pretraining trainer (port of
sceneverse_tpu/trainer/objpretrain_trainer.py; reference
trainer/objpretrain_trainer.py:9-110): ``DefaultTrainer``'s loop, whose
batches carry no ``cur_step`` / ``total_steps`` (the reference's loop body
sets neither)."""

from __future__ import annotations

from sceneverse_tpu_torch.trainer.build import TRAINER_REGISTRY
from sceneverse_tpu_torch.trainer.default_trainer import DefaultTrainer


@TRAINER_REGISTRY.register()
class ObjPretrainTrainer(DefaultTrainer):
    def _annotate_batch(self, batch: dict, cur_step: int) -> dict:
        return batch

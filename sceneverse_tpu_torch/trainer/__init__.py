"""Trainers; importing populates TRAINER_REGISTRY."""

from sceneverse_tpu_torch.trainer.build import (  # noqa: F401
    TRAINER_REGISTRY, build_trainer)
from sceneverse_tpu_torch.trainer import (  # noqa: F401
    debug_trainer, default_trainer, objpretrain_trainer, openvocab_trainer)

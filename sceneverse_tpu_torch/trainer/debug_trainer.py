"""Data-pipeline debug trainer (port of sceneverse_tpu/trainer/debug_trainer.py;
reference trainer/debug_trainer.py:9-70): iterates every loader without
running the model."""

from __future__ import annotations

from sceneverse_tpu_torch.trainer.build import TRAINER_REGISTRY, BaseTrainer


@TRAINER_REGISTRY.register()
class DebugTrainer(BaseTrainer):
    def run(self) -> dict:
        """Returns the number of batches of each loader, keyed
        ``<split>[<index>]``."""
        counts = {}
        for split, loader in self.data_loaders.items():
            loaders = loader if isinstance(loader, list) else [loader]
            for li, sub in enumerate(loaders):
                counts[f"{split}[{li}]"] = sum(1 for _ in sub)
                print(f"debug iterate {split}[{li}]: "
                      f"{counts[f'{split}[{li}]']} batches", flush=True)
        print("DebugTrainer: all dataloaders iterated", flush=True)
        return counts

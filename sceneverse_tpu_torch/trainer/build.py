"""Trainer base (port of sceneverse_tpu/trainer/build.py), eager PyTorch.

Model, loss, optimizer and loaders live on one explicit device. A train
step is forward, loss, backward, global-norm clip, AdamW and the LR
schedule, with ``torch.autocast(bfloat16)`` when ``mixed_precision`` asks
for it. The device is CUDA unless the caller asks for the CPU (the
``device`` argument or ``device=cpu`` in the config); with no CUDA card the
trainer raises instead of falling back. Data comes from the port's datasets
(``data/build.py::get_dataset``) through a ``torch.utils.data.DataLoader``
with an explicit seeded generator. ``mode=test`` builds only the test
loader and runs the test pass; ``pretrain_ckpt_path`` loads a checkpoint
(``ckpt/convert.py::load_torch_pretrain``) before anything runs.

Not ported yet (JAX-only mechanisms or later work): resume, packed host
transfer, K steps per dispatch, fused eval, gradient accumulation, DDP.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain
from sceneverse_tpu_torch.data.build import get_dataset, numpy_collate
from sceneverse_tpu_torch.evaluator import build_eval
from sceneverse_tpu_torch.model import build_model
from sceneverse_tpu_torch.modules.utils import set_generators
from sceneverse_tpu_torch.optim.build import GPSOptimizer
from sceneverse_tpu_torch.optim.loss.loss import Loss
from sceneverse_tpu_torch.registry import Registry
from sceneverse_tpu_torch.utils.logger import MetricsLogger

TRAINER_REGISTRY = Registry("trainer")

# the JAX package's map (trainer/build.py:181-186): these values train
# under a bf16 autocast, every other value in f32
_BF16_VALUES = ("bf16", "bfloat16", "fp16", "16")


def build_dataloader(cfg, split: str):
    """Train: shuffled drop-last loader; eval: one loader per dataset (the
    loader itself when there is one), in order."""
    from torch.utils.data import DataLoader

    workers = int(cfg.dataloader.get("num_workers", 0))
    gen = torch.Generator().manual_seed(int(cfg.get("rng_seed", 42)))

    def make(ds, shuffle, drop_last):
        return DataLoader(ds, batch_size=int(cfg.dataloader.batchsize),
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=workers, collate_fn=numpy_collate,
                          generator=gen, persistent_workers=workers > 0)

    dataset = get_dataset(cfg, split)
    if split == "train":
        return make(dataset, True, True)
    loaders = [make(ds, False, False) for ds in dataset]
    return loaders[0] if len(loaders) == 1 else loaders


def to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = torch.from_numpy(v).to(device, non_blocking=True)
        elif torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
    return out


class Tracker:
    def __init__(self, cfg):
        self.exp_name = str(cfg.get("name", "exp"))
        self.epoch = 0

    def step(self):
        self.epoch += 1


@TRAINER_REGISTRY.register()
class BaseTrainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device or cfg.get("device") or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the trainer runs on CUDA unless asked for the CPU "
                "(device=cpu), and torch.cuda.is_available() is False")
        self.mode = cfg.get("mode", "train")
        self.epochs = int(cfg.solver.epochs)
        self.epochs_per_eval = cfg.solver.get("epochs_per_eval")
        self.epochs_per_save = cfg.solver.get("epochs_per_save")
        if int(cfg.solver.get("gradient_accumulation_steps", 1)) != 1:
            raise NotImplementedError("gradient accumulation is not ported yet")
        if cfg.get("resume", False):
            raise NotImplementedError("resume is not ported yet")
        amp = str(cfg.get("mixed_precision", "no")).lower()
        self.amp_dtype = torch.bfloat16 if amp in _BF16_VALUES else None
        self.global_step = 0
        self.exp_tracker = Tracker(cfg)
        self.logger = MetricsLogger(cfg, self.exp_tracker.exp_name)
        keys = ["train", "val", "test"] if self.mode == "train" else ["test"]
        self.data_loaders = {k: build_dataloader(cfg, k) for k in keys}

        seed = int(cfg.get("rng_seed", 42))
        self.model = build_model(
            cfg, generator=torch.Generator().manual_seed(seed)).to(self.device)
        set_generators(self.model, seed, self.device)
        self.loss = Loss(cfg).to(self.device)
        self.total_steps = (len(self.data_loaders["train"]) * self.epochs
                            if "train" in keys else 1)
        self.optimizer = GPSOptimizer(cfg, self.model, self.total_steps)
        self.evaluator = build_eval(cfg)
        self.pretrain_loaded = None
        if cfg.get("pretrain_ckpt_path"):
            self.pretrain_ckpt_path = Path(cfg.pretrain_ckpt_path)
            self.load_pretrain()
        exp_dir = cfg.get("exp_dir") or "."
        self.ckpt_path = (Path(cfg.ckpt_path) if cfg.get("ckpt_path")
                          else Path(exp_dir) / "ckpt")
        self.history = {"train": [], "val": [], "test": []}

    def autocast(self):
        return torch.autocast(self.device.type, dtype=self.amp_dtype or
                              torch.bfloat16, enabled=self.amp_dtype is not None)

    def train_forward_backward(self, batch: dict):
        """One eager step: forward, loss, backward, clip, AdamW, schedule."""
        self.model.train()
        self.optimizer.zero_grad()
        with self.autocast():
            out = self.model(batch)
            total, losses = self.loss(out)
        total.backward()
        self.optimizer.step()
        return out, losses

    @torch.no_grad()
    def forward(self, batch: dict):
        self.model.eval()
        with self.autocast():
            return self.model(batch)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, results: dict, mode="train", step=None):
        step = self.global_step if step is None else step
        row = {f"{mode}/{k}": float(v) for k, v in results.items()}
        if mode == "train":
            ratio = self.optimizer.schedule(step)
            for i, (_, base_lr) in enumerate(self.optimizer.group_info):
                row[f"{mode}/lr/group_{i}"] = base_lr * ratio
        self.logger.log(row, step=step)

    def load_pretrain(self):
        """Warm start from ``pretrain_ckpt_path`` (``pytorch_model*.bin``
        shards or a ``best.pth``), after the model is on its device (JAX
        ``trainer/build.py:213-215, 674-681``)."""
        n = load_torch_pretrain(self.model, self.pretrain_ckpt_path)
        self.pretrain_loaded = n
        print(f"Loaded {n} tensors from {self.pretrain_ckpt_path}")

    def save(self, name: str):
        self.ckpt_path.mkdir(parents=True, exist_ok=True)
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "global_step": self.global_step,
                    "epoch": self.exp_tracker.epoch},
                   self.ckpt_path / name)


def build_trainer(cfg, device=None):
    from sceneverse_tpu_torch.trainer import openvocab_trainer  # noqa: F401

    return TRAINER_REGISTRY.get(cfg.trainer)(cfg, device=device)

"""Trainer base (port of sceneverse_tpu/trainer/build.py), eager PyTorch.

Model, loss, optimizer and loaders live on one explicit device. A train
step is forward, loss, backward, global-norm clip, AdamW and the LR
schedule, with ``torch.autocast(bfloat16)`` when ``mixed_precision`` asks
for it. The device is CUDA unless the caller asks for the CPU (the
``device`` argument or ``device=cpu`` in the config); with no CUDA card the
trainer raises instead of falling back. Data comes from the port's data
pipeline (``data/build.py::build_dataloader``: the datasets and wrappers of
the config through ``torch.utils.data.DataLoader``s, each with its own
generator seeded from ``rng_seed``, or the materialized batch loader). ``mode=test`` builds
only the test loader and runs the test pass; ``pretrain_ckpt_path`` loads a
checkpoint (``ckpt/convert.py::load_torch_pretrain``) before anything runs.

As in the JAX package:
  * ``resume`` restores model, optimizer, tracker and step from
    ``latest.pth``, ``ckpt_path`` itself or the newest finished checkpoint
    under it (``resume``), after ``pretrain_ckpt_path``. Random state is
    not checkpointed: the dropout and attention-seed streams and the train
    loader's generator start again from ``rng_seed``;
  * ``solver.gradient_accumulation_steps`` = k is ``optax.MultiSteps``
    (``optim/build.py``): the schedule runs over ``total_steps // k``
    optimizer steps while ``total_steps`` counts micro-steps;
  * ``debug.hard_debug`` writes no log; ``debug.nans`` and
    ``profile.enabled`` / ``profile.steps`` go through
    ``utils/profiling.py``; ``eval.pass_kwargs`` hands the loaders to the
    evaluators;
  * train metrics stay device scalars and ``flush_train_logs`` fetches a
    buffer of them in one copy (``DefaultTrainer``: every
    ``solver.log_every`` steps).

Data parallelism (``parallel/mesh.py``; ``run_torch.py`` under torchrun):
one trainer per process, on ``cuda:LOCAL_RANK`` unless ``device`` says
otherwise. The global batch is ``dataloader.batchsize``, each rank loads
its rows (``data/build.py``); rank 0's parameters and buffers are
broadcast at start; each rank's losses are its shares of the global-batch
losses and ``GPSOptimizer`` sums the gradients once per optimizer step,
before the clip; the logged losses and train metrics are summed over the
ranks inside the buffer ``flush_train_logs`` fetches, so a step adds no
host sync. Rank 0 writes the log, the checkpoints and ``eval.save``; the
ranks meet at a barrier after each checkpoint write (rank 0 then writes
synchronously), and every rank resumes from the same file.

Not ported (dispatch mechanisms of the JAX package with identical math):
packed host transfer, K steps per dispatch, fused eval.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from sceneverse_tpu_torch.ckpt.checkpoint import (is_checkpoint,
                                                  latest_checkpoint,
                                                  load_checkpoint,
                                                  save_checkpoint,
                                                  wait_for_checkpoints)
from sceneverse_tpu_torch.ckpt.convert import load_torch_pretrain
from sceneverse_tpu_torch.data.build import build_dataloader
from sceneverse_tpu_torch.evaluator import build_eval
from sceneverse_tpu_torch.model import build_model
from sceneverse_tpu_torch.modules.utils import set_generators
from sceneverse_tpu_torch.optim.build import GPSOptimizer
from sceneverse_tpu_torch.optim.loss.loss import Loss
from sceneverse_tpu_torch.parallel import mesh
from sceneverse_tpu_torch.registry import Registry
from sceneverse_tpu_torch.utils.logger import MetricsLogger
from sceneverse_tpu_torch.utils.profiling import (install_nan_checks,
                                                  setup_from_config)

TRAINER_REGISTRY = Registry("trainer")

# the JAX package's map (trainer/build.py:181-186): these values train
# under a bf16 autocast, every other value in f32
_BF16_VALUES = ("bf16", "bfloat16", "fp16", "16")


def to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = torch.from_numpy(v).to(device, non_blocking=True)
        elif torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
    return out


class Tracker:
    """Checkpointable experiment progress (JAX ``trainer/build.py:127-143``)."""

    def __init__(self, cfg):
        self.exp_name = str(cfg.get("name", "exp"))
        self.epoch = 0
        self.best_result = -math.inf

    def step(self):
        self.epoch += 1

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("__")}

    def load_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


def _scalar(v, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device`` without a host-to-device copy."""
    if torch.is_tensor(v):
        return v.detach().float().reshape(())
    return torch.full((), float(v), device=device)


@TRAINER_REGISTRY.register()
class BaseTrainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        mesh.check_cfg(cfg)
        self.device = torch.device(
            device or cfg.get("device")
            or (f"cuda:{mesh.local_rank()}" if mesh.world() > 1 else "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the trainer runs on CUDA unless asked for the CPU "
                "(device=cpu), and torch.cuda.is_available() is False")
        self.debug = bool(cfg.select("debug.flag", False))
        self.hard_debug = bool(cfg.select("debug.hard_debug", False))
        self.mode = cfg.get("mode", "train")
        self.epochs = int(cfg.solver.epochs)
        self.epochs_per_eval = cfg.solver.get("epochs_per_eval")
        self.epochs_per_save = cfg.solver.get("epochs_per_save")
        amp = str(cfg.get("mixed_precision", "no")).lower()
        self.amp_dtype = torch.bfloat16 if amp in _BF16_VALUES else None
        self.global_step = 0
        self.exp_tracker = Tracker(cfg)
        self.logger = MetricsLogger(cfg, self.exp_tracker.exp_name)
        self.profile_enabled, self.profile_steps = setup_from_config(cfg)
        keys = ["train", "val", "test"] if self.mode == "train" else ["test"]
        self.data_loaders = {k: build_dataloader(cfg, k) for k in keys}

        self.seed = int(cfg.get("rng_seed", 42))
        self.model = build_model(
            cfg, generator=torch.Generator().manual_seed(self.seed)
        ).to(self.device)
        set_generators(self.model, self.seed, self.device, mesh.rank())
        if cfg.select("debug.nans", False):
            install_nan_checks(self.model)
        self.loss = Loss(cfg).to(self.device)
        accum = int(cfg.solver.get("gradient_accumulation_steps", 1))
        # total_steps counts micro-steps, the schedule optimizer steps
        self.total_steps = (len(self.data_loaders["train"]) * self.epochs
                            if "train" in keys else 1)
        self.optimizer = GPSOptimizer(
            cfg, self.model,
            self.total_steps // accum if "train" in keys else 1, accum=accum)
        eval_kwargs = ({"dataloaders": self.data_loaders}
                       if cfg.select("eval.pass_kwargs", False) else {})
        self.evaluator = build_eval(cfg, **eval_kwargs)
        self.pretrain_loaded = None
        if cfg.get("pretrain_ckpt_path"):
            self.pretrain_ckpt_path = Path(cfg.pretrain_ckpt_path)
            self.load_pretrain()
        mesh.broadcast_state(self.model)
        exp_dir = cfg.get("exp_dir") or "."
        self.ckpt_path = (Path(cfg.ckpt_path) if cfg.get("ckpt_path")
                          else Path(exp_dir) / "ckpt")
        self.history = {"train": [], "val": [], "test": []}
        self.resumed_from = None
        if cfg.get("resume", False):
            self.resume()

    def autocast(self):
        return torch.autocast(self.device.type, dtype=self.amp_dtype or
                              torch.bfloat16, enabled=self.amp_dtype is not None)

    def train_forward_backward(self, batch: dict):
        """One eager micro-step: forward, loss, backward, then the
        optimizer, which moves the parameters on every
        ``gradient_accumulation_steps``-th call (clip, AdamW, schedule)."""
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

    # ---------------------------------------------------------------- logging
    def log(self, results: dict, mode="train", step=None):
        if self.hard_debug:
            return
        step = self.global_step if step is None else step
        row = {}
        for k, v in results.items():
            try:
                row[f"{mode}/{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        if mode == "train":
            ratio = self.optimizer.schedule(step)
            for i, (_, base_lr) in enumerate(self.optimizer.group_info):
                row[f"{mode}/lr/group_{i}"] = base_lr * ratio
        self.logger.log(row, step=step)

    def flush_train_logs(self, pending: list) -> None:
        """Fetch a buffer of ``(step, {key: device scalar}, t_start)``
        entries in ONE device-to-host copy and write each as its own log
        row and ``history["train"]`` row (JAX ``trainer/build.py:572-610``).
        A row's ``step_s`` is the host time from its step's start to the
        next step's start, the last one's to the end of this copy.

        Over a data-parallel world a value is this rank's share of a loss
        or a metric's ``(value, count)`` pair; the buffer is summed over
        the ranks before the copy and a pair's ratio taken on the host."""
        if not pending:
            return
        keys = list(dict.fromkeys(k for _, vals, _ in pending for k in vals))
        nan = float("nan")

        def cell(v, part):  # a pair's value or count; a share, counted 1
            if isinstance(v, tuple):
                return v[part]
            return v if part == 0 else 1.0

        def column(part):
            return torch.stack([torch.stack([
                _scalar(cell(vals.get(k, nan), part), self.device)
                for k in keys]) for _, vals, _ in pending])

        if mesh.world() == 1:
            host = column(0).cpu().numpy()
        else:
            both = torch.stack([column(0), column(1)])
            mesh.all_reduce_flat([both])
            value, count = both.cpu().numpy()
            pair = np.array([any(isinstance(vals.get(k), tuple)
                                 for _, vals, _ in pending) for k in keys])
            host = np.where(pair, value / np.maximum(count, np.float32(1)),
                            value)
        t_end = time.perf_counter()
        starts = [t for _, _, t in pending] + [t_end]
        for i, ((step, _, _), vals) in enumerate(zip(pending, host)):
            row = {k: float(v) for k, v in zip(keys, vals)}
            self.log(row, mode="train", step=step)
            row.update(step=step, step_s=starts[i + 1] - starts[i])
            self.history["train"].append(row)

    # ----------------------------------------------------------- checkpoints
    def load_pretrain(self):
        """Warm start from ``pretrain_ckpt_path`` (``pytorch_model*.bin``
        shards or a ``best.pth``), after the model is on its device (JAX
        ``trainer/build.py:213-215, 674-681``)."""
        n = load_torch_pretrain(self.model, self.pretrain_ckpt_path)
        self.pretrain_loaded = n
        print(f"Loaded {n} tensors from {self.pretrain_ckpt_path}")

    def _ckpt_state(self) -> dict:
        """No random state (JAX ``trainer/build.py:621-634``): the streams
        start again from ``rng_seed`` on restore."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "tracker": self.exp_tracker.state_dict(),
                "global_step": self.global_step}

    def save(self, name: str):
        """An asynchronous save to ``ckpt_path / name``
        (``ckpt/checkpoint.py``); over a data-parallel world rank 0 writes
        it before the ranks meet at a barrier."""
        save_checkpoint(self.ckpt_path / name, self._ckpt_state(),
                        block=mesh.world() > 1)
        mesh.barrier()

    def resume(self):
        """JAX ``trainer/build.py:642-672``: ``latest.pth``, else
        ``ckpt_path`` itself when it is one checkpoint, else the newest
        finished checkpoint under it (trainers that save no ``latest.pth``);
        otherwise training starts from scratch."""
        wait_for_checkpoints()
        target = self.ckpt_path / "latest.pth"
        if not target.exists():
            if is_checkpoint(self.ckpt_path):
                target = self.ckpt_path
            else:
                target = latest_checkpoint(self.ckpt_path) or self.ckpt_path
        if not (target.exists() and is_checkpoint(target)):
            print("training from scratch")
            return
        state = load_checkpoint(target)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.exp_tracker.load_state_dict(state["tracker"])
        self.global_step = int(state["global_step"])
        set_generators(self.model, self.seed, self.device, mesh.rank())
        gen = getattr(self.data_loaders.get("train"), "generator", None)
        if gen is not None:  # the materialized loader seeds each epoch
            gen.manual_seed(self.seed)
        self.resumed_from = target
        print(f"Successfully resumed from {target}")


def build_trainer(cfg, device=None):
    """The trainer ``cfg.trainer`` names (the package's ``__init__``
    registers every trainer)."""
    return TRAINER_REGISTRY.get(cfg.trainer)(cfg, device=device)

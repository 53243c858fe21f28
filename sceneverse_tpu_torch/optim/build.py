"""Optimizer (port of sceneverse_tpu/optim/build.py).

torch AdamW, Adam or SGD (``solver.optim.name``) over per-tower parameter
groups (longest-prefix match against ``model.get_opt_params()``). Under
AdamW a group is split into decay (its ``weight_decay``, default 0.01)
and no-decay (biases and norm scales) halves unless its spec says
``no_decay_split: False``, which keeps it whole at its decay; Adam and SGD
apply no weight decay, whatever the group says (optax's ``adam`` and
``sgd`` take none). Frozen prefixes and parameters outside every group are
not optimised. Matches the JAX package's optax chain:

  * ``clip_by_global_norm``: g <- g / ||g|| * max_norm when ||g|| >= max_norm;
  * ``betas`` are optax's ``b1`` / ``b2``; ``optax.sgd(momentum=m)`` is
    torch SGD with ``momentum=m`` and no dampening (both start the trace at
    the first gradient);
  * optax moves the moments and applies weight decay for a parameter whose
    gradient is zero, torch skips one whose ``.grad`` is None, so every
    optimised parameter gets a materialised zero gradient before the step
    (the unused ``sem_cls_embed_layer`` / ``sem_mask_embeddings`` of the
    vision tower);
  * the LR of step ``t`` (0-based) is ``base_lr * schedule(t)``: the warmup
    makes it exactly 0 at step 0;
  * ``accum`` > 1 is ``optax.MultiSteps(chain(clip, adamw), accum)``: each
    ``step`` folds the gradients into a running mean (``acc += (g - acc) /
    (n + 1)``, MultiSteps' own update) and leaves the parameters as they
    are; every ``accum``-th call clips that mean, takes the AdamW step at
    ``schedule(step_count)`` and clears it. ``step_count`` counts optimizer
    steps, and the state dict carries the mean and the micro-step, so a
    resume inside a group continues exactly. Over a dp group each rank's
    mean is that of its share of the loss: the state dict holds their sum
    over the group (the global batch's mean, as MultiSteps' state and a
    world of 1 hold it), and a rank that loads it takes its 1 / dp share;
  * over a data-parallel world (``parallel/mesh.py``) each rank's gradient
    is that of its share of the global-batch loss, so the ranks' gradients
    are summed over the dp group, once per optimizer step (after the
    group's last micro-step under ``accum``) and before the clip, as one
    flat all-reduce. With an mp group (``parallel.mp`` > 1) the replicated
    gradients are then broadcast from the group's first rank, so the
    replicas stay bit-equal, and the clip's squared norm counts them once
    and sums the split LM head's rows over the group
    (``parallel/vocab.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from sceneverse_tpu_torch.optim.scheduler import get_schedule_fn
from sceneverse_tpu_torch.parallel import mesh, vocab


def _no_decay(model: nn.Module, name: str) -> bool:
    """The JAX package's rule: leaves named ``bias`` or ``scale``
    (LayerNorm / BatchNorm scales) get no weight decay."""
    if name.endswith("bias"):
        return True
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else model
    return isinstance(owner, (nn.LayerNorm, nn.BatchNorm1d))


def _torch_optimizer(name: str, param_groups: list, args: dict):
    """The torch optimizer of optax's ``adamw`` / ``adam`` / ``sgd`` with
    the config's ``solver.optim.args``."""
    if name == "SGD":
        momentum = args.pop("momentum", None)
        return torch.optim.SGD(param_groups, lr=0.0,
                               momentum=float(momentum or 0.0), dampening=0.0,
                               nesterov=bool(args.pop("nesterov", False)),
                               **args)
    opt = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam}[name]
    return opt(param_groups, betas=tuple(args.pop("betas", (0.9, 0.999))),
               eps=float(args.pop("eps", 1e-8)), **args)


class GPSOptimizer:
    def __init__(self, cfg, model: nn.Module, total_steps: int,
                 accum: int = 1):
        opt_name = cfg.solver.optim.name
        self.schedule = get_schedule_fn(cfg, total_steps)
        self.grad_norm = cfg.solver.get("grad_norm")
        groups = model.get_opt_params()
        frozen = [tuple(p) for p in model.frozen_prefixes()]
        buckets: dict = {}
        for name, p in model.named_parameters():
            path = tuple(name.split("."))
            if not p.requires_grad or any(path[:len(f)] == f for f in frozen):
                continue
            best, best_len = None, -1
            for i, g in enumerate(groups):
                pref = tuple(g["prefix"])
                if path[:len(pref)] == pref and len(pref) > best_len:
                    best, best_len = i, len(pref)
            if best is None:
                continue
            nd = (groups[best].get("no_decay_split", True)
                  and _no_decay(model, name))
            buckets.setdefault((best, nd), []).append(p)
        self.group_info = [(f"g{i}", float(g["lr"])) for i, g in enumerate(groups)]
        param_groups = []
        for (i, nd), ps in sorted(buckets.items()):
            wd = (float(groups[i].get("weight_decay", 0.01))
                  if opt_name == "AdamW" and not nd else 0.0)
            param_groups.append({"params": ps, "lr": 0.0, "weight_decay": wd,
                                 "base_lr": float(groups[i]["lr"])})
        self.params = [p for g in param_groups for p in g["params"]]
        self.opt = _torch_optimizer(
            opt_name, param_groups,
            dict(cfg.solver.optim.get("args", {}) or {}))
        self.step_count = 0
        self.accum = int(accum)
        self.mini_step = 0
        self.acc = None  # the running mean of a group's gradients

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        """One micro-step; returns whether the parameters moved."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.accum > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            torch._foreach_copy_(grads, self.acc)
        mesh.all_reduce_flat(grads)
        if mesh.mp_world() > 1:
            split = [vocab.is_split(p) for p in self.params]
            # the replicas take the mp group's first rank's gradient: mp
            # peers compute it from the same rows and masks, but a CUDA
            # backward with atomics may round it differently
            mesh.broadcast_flat_mp(
                [g for g, s in zip(grads, split) if not s])
        if self.grad_norm is not None:
            # optax clip_by_global_norm: g / ||g|| * max_norm when ||g|| >=
            # max_norm, else g unchanged (divide and multiply by 1); two
            # multi-tensor launches instead of a few per parameter
            if mesh.mp_world() > 1:
                gnorm = self._split_norm(grads, split)
            else:
                gnorm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
            keep = gnorm < float(self.grad_norm)
            one = torch.ones_like(gnorm)
            torch._foreach_div_(grads, torch.where(keep, one, gnorm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(gnorm, float(self.grad_norm))))
        ratio = self.schedule(self.step_count)
        for g in self.opt.param_groups:
            g["lr"] = g["base_lr"] * ratio
        self.opt.step()
        self.step_count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        return True

    @staticmethod
    def _split_norm(grads, split) -> torch.Tensor:
        """The global norm over an mp group: the replicated gradients'
        squares counted once, plus the split gradients' squares summed over
        the mp group (each rank holds its rows)."""
        def sq(gs):
            if not gs:
                return grads[0].new_zeros((), dtype=torch.float32)
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs))).square()

        rows = sq([g for g, s in zip(grads, split) if s])
        if any(split):
            rows = mesh.all_reduce_sum(rows, "mp")
        return (sq([g for g, s in zip(grads, split) if not s])
                + rows).sqrt()

    def state_dict(self):
        """Every rank calls it: inside a group the running mean is summed
        over the dp group (a collective), into copies."""
        acc = self.acc
        if acc is not None and self.mini_step and mesh.dp_world() > 1:
            acc = [a.clone() for a in acc]
            mesh.all_reduce_flat(acc)
        return {"opt": self.opt.state_dict(), "step_count": self.step_count,
                "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.step_count = int(state["step_count"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = (None if acc is None else
                    [a.to(p.device, p.dtype) for a, p in zip(acc, self.params)])
        if self.acc is not None and mesh.dp_world() > 1:
            # this rank's share of the global mean: the group's last
            # micro-step sums the shares back over dp
            torch._foreach_div_(self.acc, float(mesh.dp_world()))

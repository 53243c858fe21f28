"""The system under test, driven as its users drive it: the
configuration's trainer (``build_trainer``), the benchmark's weights
loaded by name, and the trainer's own loops fed from the traffic pool by
``Feed``, which stands where the data loader stands."""

from __future__ import annotations

import copy
import time

import torch


class Feed:
    """A loader of host batches from the pool in turn, from ``start``:
    ``count`` of them, or, with a ``deadline`` (host clock), whole chunks
    of ``k`` until the first chunk boundary at which ``stop(passed)`` says
    so (over several ranks it agrees their answers). ``rows`` keeps this
    rank's block of each batch. ``served`` lists the pool indices given
    out."""

    def __init__(self, pool, k, start=0, count=None, deadline=None,
                 rows=None, stop=bool):
        self.pool, self.k, self.start = pool, k, start
        self.count, self.deadline = count, deadline
        self.rows, self.stop = rows, stop
        self.served = []

    def __len__(self):
        return self.count if self.count is not None else 10 ** 6

    def __iter__(self):
        i = 0
        while True:
            if self.count is not None and i >= self.count:
                return
            if (self.deadline is not None and i % self.k == 0 and
                    self.stop(time.perf_counter() >= self.deadline)):
                return
            j = (self.start + i) % len(self.pool)
            self.served.append(j)
            b = self.pool[j]
            yield (dict(b) if self.rows is None else
                   {k: v[self.rows] for k, v in b.items()})
            i += 1


def build(config: dict, seed: int, device: str, exp_dir: str):
    """The trainer of the configuration's ``run`` block, its dropout
    streams seeded from ``seed``."""
    from sceneverse_tpu_torch.config import Config
    from sceneverse_tpu_torch.trainer.build import build_trainer

    run = copy.deepcopy(config["run"])
    run.update(rng_seed=int(seed), exp_dir=exp_dir, device=device)
    return build_trainer(Config(run))


def load_weights(trainer, weights: dict) -> None:
    """Every weight and buffer of the model, by name (strict)."""
    with torch.no_grad():
        trainer.model.load_state_dict(weights, strict=True)


class HostTimer:
    """Host-clock seconds of each call of ``obj.<name>`` while active."""

    def __init__(self, obj, name):
        self.obj, self.name, self.s = obj, name, []

    def __enter__(self):
        inner = getattr(self.obj, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            self.s.append(time.perf_counter() - t0)
            return out

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)

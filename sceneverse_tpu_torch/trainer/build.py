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

Data and vocabulary parallelism (``parallel/mesh.py``'s dp x mp grid,
``parallel/vocab.py``; ``launch_torch.py`` / ``run_torch.py`` under
torchrun): one trainer per process, on ``cuda:LOCAL_RANK`` unless
``device`` says otherwise. The global batch is ``dataloader.batchsize``,
each dp rank loads its rows (``data/build.py``; mp peers load the same
rows); rank 0's parameters and buffers are broadcast at start; the
dropout streams are seeded from the dp rank, so mp peers draw the same
masks; each rank's losses are its dp shard's shares of the global-batch
losses and ``GPSOptimizer`` sums the gradients over the dp group once per
optimizer step, before the clip; the logged losses and train metrics are
summed over the dp group inside the buffer ``flush_train_logs`` fetches,
so a step adds no host sync. With mp > 1 the LM head is split over the mp
group last, after the pretrain load and the resume, and checkpoints hold
it whole. Rank 0 writes the log, the checkpoints and ``eval.save``; the
ranks meet at a barrier after each checkpoint write (rank 0 then writes
synchronously), and every rank resumes from the same file.

The JAX package's dispatch paths (its ``trainer/build.py:44-124,
300-481, 532-547``) with the same math:
  * in-step train metrics: an evaluator whose ``batch_metrics`` is tensor
    math (``JIT_METRICS``, no ``eval.save``) is computed inside the train
    step (``_fusable_metrics``);
  * packed transfer (``solver.packed_transfer``, default ``auto``; a world
    of 1 only, as JAX's single-device mesh): a batch's arrays go to the
    device as ONE int32 buffer (``_pack_host``; ints narrow to int32 with
    JAX's overflow check, bools ride as int32, f64 keeps both words) from a
    pinned, double-buffered host buffer per batch signature, and arrive as
    views of one device buffer (``_unpack_device``);
  * K steps per dispatch (``solver.steps_per_dispatch`` = K > 1):
    ``train_forward_backward_k`` runs K micro-steps of stacked batches. On
    the card they are one ``torch.cuda.CUDAGraph`` per (batch signature, K,
    metrics, accumulation phase): the first chunk of a key runs eagerly
    (the warm-up, which also allocates the optimizer state), the second
    captures, and every chunk from then on is one ``replay()`` of the graph
    (all on one stream of the trainer's own), whose dropout and
    attention-seed generators are registered with it so that each replay
    draws new masks. A capture that
    fails raises; nothing falls back to eager steps. On the CPU the same
    step function runs K times in a row (the math of JAX's scan);
  * fused eval (``eval_fused``): the forward and the (value, count) sums of
    ``solver.eval_steps_per_dispatch`` same-signature eval batches in one
    replay, the tail batch of a ``drop_last=False`` loader in its own graph,
    the sums handed to ``BaseEvaluator.update_sums``.
A replay does not run the kernel wrappers, so it adds the launches the
capture recorded to ``ops/_build.LAUNCHES`` itself. ``model.remat`` runs
inside a graph (``modules/utils.py::remat`` replays the forward's draws from
a tape, no generator state is read or set). In a world of more than one
rank (dp x mp) the K micro-steps of a chunk, and a fused eval group, run in
a row without a graph, the same kernels as one rank's replay: each rank
stacks its own rows of the K batches (its loader's share, JAX's
``shard_batch(..., axis=1)``), each micro-step sums the gradients over the
dp group and broadcasts the mp replicas' as a single step does, and the
stacked (value, count) pairs reach ``flush_train_logs`` as K rows. gloo
cannot be captured, and a graph of NCCL collectives over several cards
waits for a machine that has them.
"""

from __future__ import annotations

import contextlib
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
from sceneverse_tpu_torch.modules.utils import _streams, set_generators
from sceneverse_tpu_torch.ops import _build
from sceneverse_tpu_torch.optim.build import GPSOptimizer
from sceneverse_tpu_torch.optim.loss.loss import Loss
from sceneverse_tpu_torch.parallel import mesh, vocab
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


def _arrays(batch: dict) -> dict:
    """The leaves of a host batch that ride to the device: arrays (numpy or
    torch) and numbers; strings and lists stay on the host."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v.detach().cpu().numpy()
        elif isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            out[k] = v
        elif isinstance(v, (bool, int, float, np.number)):
            out[k] = np.asarray(v)
    return out


def _stack_batches(data_dicts: list) -> dict:
    """K same-shape host batches stacked on a new leading axis (JAX
    ``trainer/build.py:102-114``); numbers become (K,) arrays, strings and
    lists are dropped."""
    rows = [_arrays(d) for d in data_dicts]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _batch_signature(data_dict: dict) -> tuple:
    """(key, shape, dtype) of every array leaf: batches of one signature
    share a staging buffer and a graph (JAX ``trainer/build.py:117-124``);
    the smaller tail batch of a ``drop_last=False`` loader gets its own."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in _arrays(data_dict).items()))


def _layout(arrays: dict, k=None) -> tuple:
    """Static layout of ``_pack_host``: (key, shape, kind, dtype, offset,
    int32 words) per leaf, in key order; an f64 leaf starts at an even
    word. With ``k`` the layout of the arrays stacked k times."""
    metas, off = [], 0
    lead, times = ((k,), k) if k else ((), 1)
    for key in sorted(arrays):
        a = arrays[key]
        size = a.size * times
        if a.dtype == np.bool_:
            kind, n = "bool", size
        elif a.dtype == np.float64:
            kind, n = "f64", 2 * size
            off += off % 2
        elif np.issubdtype(a.dtype, np.floating):
            kind, n = "f32", size
        else:
            kind, n = "int", size
        metas.append((key, lead + tuple(a.shape), kind, str(a.dtype), off, n))
        off += n
    return tuple(metas), off + off % 2


def _pack_into(out: np.ndarray, rows: list, metas: tuple) -> None:
    """Write the batches ``rows`` (one, or the K of a stacked layout, each
    into its share of every leaf's words) into the int32 buffer ``out``."""
    for k, shape, kind, _, off, n in metas:
        m = n // len(rows)
        for j, row in enumerate(rows):
            a, seg = np.asarray(row[k]), out[off + j * m:off + (j + 1) * m]
            if kind == "int":
                if a.dtype != np.int32 and a.size and (
                        a.max() >= 2 ** 31 or a.min() < -2 ** 31):
                    raise OverflowError(
                        f"batch key {k!r} has values outside int32 range; "
                        "packed transfer would wrap silently")
                seg[:] = a.reshape(-1)
            elif kind == "bool":
                seg[:] = a.reshape(-1)
            else:
                t = np.float64 if kind == "f64" else np.float32
                seg[:] = np.ascontiguousarray(a, t).reshape(-1).view(np.int32)


def _pack_host(arrays: dict):
    """A dict of host arrays as ONE int32 buffer and its static layout (JAX
    ``trainer/build.py:44-81``): one host-to-device copy for the batch in
    place of one per leaf. f32 rides bit for bit, ints narrow to int32 and
    raise ``OverflowError`` outside its range (as JAX), bools ride as int32,
    f64 as its two words (JAX runs with x64 off and narrows it; the port's
    float64 models keep it). JAX's swap of tiny minor dimensions exists for
    the TPU's lane padding and is not ported."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    metas, n = _layout(arrays)
    buf = np.zeros(n, np.int32)
    _pack_into(buf, [arrays], metas)
    return buf, metas


def _unpack_device(buf: torch.Tensor, metas: tuple) -> dict:
    """Inverse of ``_pack_host`` on the device: f32 and f64 leaves are views
    of ``buf``, ints and bools one cast each, back to their dtypes."""
    out = {}
    for k, shape, kind, dtype, off, n in metas:
        seg = buf[off:off + n]
        if kind == "f32":
            arr = seg.view(torch.float32)
        elif kind == "f64":
            arr = seg.view(torch.float64)
        elif kind == "bool":
            arr = seg != 0
        else:
            arr = seg.to(getattr(torch, dtype))
        out[k] = arr.view(shape)
    return out


class _Staging:
    """The device buffer of one batch signature, which a graph reads as its
    static input, fed by one ``copy_(non_blocking=True)`` from one of two
    pinned host buffers; a host buffer is written again only after its last
    copy has finished (an event), so no copy in flight is overwritten."""

    def __init__(self, metas, n, device):
        self.metas = metas
        self.host = [torch.empty(n, dtype=torch.int32, pin_memory=True)
                     for _ in range(2)]
        self.done = [None, None]
        self.dev = torch.empty(n, dtype=torch.int32, device=device)
        self.turn = 0

    def put(self, rows: list):
        """Copy the batches ``rows`` in (one, or the K of a stacked layout);
        returns the unpack, which a graph runs inside itself (its casts then
        write the graph's own memory)."""
        i, self.turn = self.turn, 1 - self.turn
        if self.done[i] is not None:
            self.done[i].synchronize()
        _pack_into(self.host[i].numpy(), rows, self.metas)
        self.dev.copy_(self.host[i], non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return lambda: _unpack_device(self.dev, self.metas)


class _LeafStaging:
    """Static device tensors of one batch signature, one copy per leaf
    (``packed_transfer=off``)."""

    def __init__(self, arrays, device):
        self.dev = {k: torch.empty(v.shape, dtype=torch.from_numpy(
            np.asarray(v)).dtype, device=device) for k, v in arrays.items()}

    def put(self, arrays: dict):
        for k, v in arrays.items():
            self.dev[k].copy_(torch.from_numpy(np.ascontiguousarray(v)),
                              non_blocking=True)
        return lambda: dict(self.dev)


class _Graph:
    """A captured CUDA graph, its static outputs, the launches its capture
    recorded and the host counters (optimizer step, accumulation phase) it
    moves per replay."""

    def __init__(self, graph, outputs, launches, counters):
        self.graph, self.outputs = graph, outputs
        self.launches, self.counters = launches, counters

    def replay(self, trainer):
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        opt = trainer.optimizer
        opt.step_count += self.counters[0]
        opt.mini_step = self.counters[1]
        return _tree_clone(self.outputs)


def _tree_clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree


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


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _scalar(v, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device`` without a host-to-device copy (a
    fill, which a CUDA graph capture allows)."""
    if torch.is_tensor(v):
        return v.detach().float().reshape(())
    return torch.full((), float(v), device=device)


@TRAINER_REGISTRY.register()
class BaseTrainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        mesh.setup_grid(cfg)
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
        set_generators(self.model, self.seed, self.device, mesh.dp_rank())
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
        # the vocabulary split LAST, as JAX places its state last: the
        # pretrain load and the resume read whole heads
        self.vocab_split = vocab.split_heads(self.model, self.optimizer)
        solver = cfg.solver
        self.steps_per_dispatch = max(1, int(
            solver.get("steps_per_dispatch", 1) or 1))
        self.eval_steps_per_dispatch = max(1, int(solver.get(
            "eval_steps_per_dispatch", self.steps_per_dispatch) or 1))
        # JAX build.py:249-252: one device, and the key not "off"
        self._packed = (mesh.world() == 1 and str(solver.get(
            "packed_transfer", "auto")).lower() != "off")
        self._staging = {}  # batch signature -> _Staging
        self._graphs = {}  # graph key -> _Graph, or None once seen eagerly
        # the card's steps, eager and graphed, run on one stream of their
        # own, where the graphs are captured too: autograd joins a leaf's
        # gradient on the stream its accumulator was made on, and a join
        # with the legacy default stream would break a capture
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def autocast(self, cache=True):
        """The bf16 autocast of ``mixed_precision`` (off otherwise); a CUDA
        graph captures with its weight cache off."""
        return torch.autocast(self.device.type, dtype=self.amp_dtype or
                              torch.bfloat16, enabled=self.amp_dtype is not None,
                              cache_enabled=cache)

    def train_forward_backward(self, batch: dict, metrics_fn=None):
        """One micro-step: forward, loss, backward, then the optimizer, which
        moves the parameters on every ``gradient_accumulation_steps``-th
        call (clip, AdamW, schedule). With ``metrics_fn`` (an evaluator's
        ``batch_metrics``) the train metrics are computed in the step and
        returned in place of the model outputs (JAX
        ``trainer/build.py:263-296``); over a data-parallel world they are
        (value, count) pairs, which ``flush_train_logs`` sums."""
        with self.on_stream():
            self.model.train()
            self.optimizer.zero_grad()
            with self.autocast(cache=not _capturing()):
                out = self.model(batch)
                total, losses = self.loss(out)
            total.backward()
            self.optimizer.step()
            losses = {k: v.detach() for k, v in losses.items()}
            if metrics_fn is None:
                return out, losses
            return metrics_fn({**batch, **out},
                              include_count=mesh.dp_world() > 1), losses

    @torch.no_grad()
    def forward(self, batch: dict):
        with self.on_stream():
            self.model.eval()
            with self.autocast(cache=not _capturing()):
                return self.model(batch)

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block on the trainer's stream (the card), ordered after
        the caller's stream's work and before its later work."""
        if self._stream is None or _capturing():
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        if cur == self._stream:
            yield
            return
        self._stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            cur.wait_stream(self._stream)

    # ---------------------------------------------------- dispatch paths
    def _fusable_metrics(self, evaluator):
        """The evaluator's ``batch_metrics``, one bound method per evaluator
        (a graph key), when it is tensor math: ``JIT_METRICS``, no
        ``eval.save`` and no ``debug.nans`` hooks (host checks); None
        otherwise, and the loops call it after the step (JAX
        ``trainer/build.py:532-547``)."""
        if (getattr(evaluator, "save", False)
                or not getattr(evaluator, "JIT_METRICS", False)
                or self.cfg.select("debug.nans", False)):
            return None
        fn = evaluator.__dict__.get("_bound_batch_metrics")
        if fn is None:
            fn = evaluator.__dict__["_bound_batch_metrics"] = \
                evaluator.batch_metrics
        return fn

    def device_batch(self, host: dict) -> dict:
        """A host batch's arrays on the device: packed (one copy, views of
        one buffer) in a world of 1 unless ``packed_transfer`` is off, else
        one copy per leaf (``to_device``). On the card the packed float
        leaves are views of the signature's staging buffer, which the next
        batch of that signature overwrites: use them before sending it."""
        if not self._packed:
            return to_device(host, self.device)
        return self._stage([_arrays(host)], stacked=False)()

    def _stage(self, rows: list, stacked=True):
        """Send the host batches ``rows`` to the device, stacked on a new
        leading axis (else the one batch as it is); returns the function
        that makes the batch dict there, run inside a graph so that every
        tensor the graph reads lives in its signature's static buffers or
        its pool. The packed stack is written batch by batch into the
        pinned buffer (no host-side stack)."""
        if self.device.type == "cuda" and self._packed:
            sig = (stacked, len(rows), tuple(
                (k, v.shape, str(v.dtype)) for k, v in sorted(rows[0].items())))
            st = self._staging.get(sig)
            if st is None:
                metas, n = _layout(rows[0], len(rows) if stacked else None)
                st = self._staging[sig] = _Staging(metas, n, self.device)
            return st.put(rows)
        arrays = _stack_batches(rows) if stacked else rows[0]
        if self.device.type != "cuda":
            if not self._packed:
                batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in arrays.items()}
                return lambda: batch
            buf, metas = _pack_host(arrays)
            return lambda: _unpack_device(torch.from_numpy(buf), metas)
        sig = tuple((k, v.shape, str(v.dtype)) for k, v in
                    sorted(arrays.items()))
        st = self._staging.get(sig)
        if st is None:
            st = self._staging[sig] = _LeafStaging(arrays, self.device)
        return st.put(arrays)

    def _graphed(self, key, fn, capture_counters=False):
        """``fn()`` through the graph of ``key`` on the card: eagerly the
        first time (the warm-up: lazy state, cuBLAS workspaces), captured
        the second time on the trainer's stream, replayed from then on. A
        failed capture raises. On the CPU, and in a world of more than one
        rank (whose collectives no graph here captures), ``fn()`` itself."""
        if self.device.type != "cuda" or mesh.world() > 1:
            return fn()
        with self.on_stream():
            if key not in self._graphs:
                out = fn()
                self._graphs[key] = None
                return out
            g = self._graphs[key]
            if g is None:
                g = self._graphs[key] = self._capture(fn, key)
            return g.replay(self)

    def _capture(self, fn, key) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        gens = [g for g in _streams(self.model) if g.device.type == "cuda"]
        if gens and register is None:
            raise RuntimeError("this torch cannot register a generator with "
                               "a CUDA graph (CUDAGraph.register_generator_"
                               "state): dropout would replay one mask")
        for g in gens:
            register(g)
        opt = self.optimizer
        launches = _build.LAUNCHES.copy()
        host = (opt.step_count, opt.mini_step)
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                outputs = fn()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {key[0]} "
                               f"(K={key[2]}) failed: {e}") from e
        finally:
            recorded = _build.LAUNCHES - launches
            _build.LAUNCHES.subtract(recorded)  # a capture launches nothing
        counters = (opt.step_count - host[0], opt.mini_step)
        opt.step_count, opt.mini_step = host
        return _Graph(graph, outputs, recorded, counters)

    def train_forward_backward_k(self, data_dicts: list, metrics_fn):
        """``len(data_dicts)`` micro-steps of stacked host batches in one
        dispatch (JAX ``trainer/build.py:300-378``): on the card one replay
        of a CUDA graph keyed by (signature, K, metrics, accumulation
        phase), on the CPU and in a world of more than one rank the same
        step function K times. Returns (metrics, losses) of stacked (K,)
        device tensors (a metric's (value, count) pair as a pair of them
        over a dp world), which ``flush_train_logs`` takes as K rows."""
        k = len(data_dicts)
        unpack = self._stage([_arrays(d) for d in data_dicts])

        def stack(vals):
            if isinstance(vals[0], tuple):  # (value, count) pairs
                return tuple(stack([v[i] for v in vals])
                             for i in range(len(vals[0])))
            return torch.stack([_scalar(v, self.device) for v in vals])

        def steps():
            batches = unpack()
            rows = [self.train_forward_backward(
                {n: v[j] for n, v in batches.items()}, metrics_fn)
                for j in range(k)]
            return tuple({n: stack([r[i][n] for r in rows])
                          for n in rows[0][i]} for i in (0, 1))

        key = ("train", _batch_signature(data_dicts[0]), k, id(metrics_fn),
               self.optimizer.mini_step)
        return self._graphed(key, steps)

    @torch.no_grad()
    def eval_metrics_k(self, data_dicts: list, metrics_fn) -> dict:
        """The forward and the (value, count) sums of K same-signature eval
        batches in one dispatch (JAX ``trainer/build.py:395-440``):
        {name: (value_sum, count_sum)} f32 device scalars."""
        k = len(data_dicts)
        unpack = self._stage([_arrays(d) for d in data_dicts])

        def sums():
            batches = unpack()
            total = {}
            for j in range(k):
                b = {n: v[j] for n, v in batches.items()}
                for name, (v, c) in metrics_fn(
                        {**b, **self.forward(b)}, include_count=True).items():
                    v, c = _scalar(v, self.device), _scalar(c, self.device)
                    if name in total:
                        v, c = total[name][0] + v, total[name][1] + c
                    total[name] = (v, c)
            return total

        return self._graphed(("eval", _batch_signature(data_dicts[0]), k,
                              id(metrics_fn)), sums)

    def eval_fused(self, evaluator, loader, metrics_fn) -> None:
        """One eval split through ``eval_metrics_k``: batches grouped into
        runs of one signature, ``eval_steps_per_dispatch`` at a time, each
        group's sums into ``evaluator.update_sums`` (JAX
        ``trainer/build.py:443-481``)."""
        chunk, sig = [], None

        def flush():
            if chunk:
                evaluator.update_sums(self.eval_metrics_k(chunk, metrics_fn))
                chunk.clear()

        for host in loader:
            s = _batch_signature(host)
            if sig is not None and s != sig:
                flush()
            sig = s
            chunk.append(host)
            if len(chunk) == self.eval_steps_per_dispatch:
                flush()
        flush()

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
        entries, and ``(first_step, {key: (K,) tensor}, t_start, K)`` ones
        from ``train_forward_backward_k``, in ONE device-to-host copy and
        write each step as its own log row and ``history["train"]`` row
        (JAX ``trainer/build.py:572-610``). A row's ``step_s`` is the host
        time from its step's start to the next step's start, the last
        one's to the end of this copy; the K rows of a chunk share its time
        evenly.

        Over a data-parallel world a value is this rank's share of a loss
        or a metric's ``(value, count)`` pair; the buffer is summed over
        the ranks before the copy and a pair's ratio taken on the host."""
        if not pending:
            return
        rows = []  # (step, {key: scalar}, t_start), one a step
        for entry in pending:
            step, vals, t0 = entry[:3]
            k = entry[3] if len(entry) == 4 else 0
            if not k:
                rows.append(entry)
                continue
            for j in range(k):
                rows.append((step + j, {n: (tuple(x[j] for x in v)
                                            if isinstance(v, tuple) else v[j])
                                        for n, v in vals.items()},
                             (t0, j, k)))
        pending = rows
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

        if mesh.dp_world() == 1:
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
        starts = [t if not isinstance(t, tuple) else None
                  for _, _, t in pending] + [t_end]
        for i, (_, _, t) in enumerate(pending):
            if isinstance(t, tuple):  # row j of a K-step chunk started at t0
                t0, j, k = t
                t_next = next(x for x in starts[i - j + k:] if x is not None)
                starts[i] = t0 + (t_next - t0) * j / k
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
        self._graphs = {}
        n = load_torch_pretrain(self.model, self.pretrain_ckpt_path)
        self.pretrain_loaded = n
        print(f"Loaded {n} tensors from {self.pretrain_ckpt_path}")

    def _ckpt_state(self) -> dict:
        """No random state (JAX ``trainer/build.py:621-634``): the streams
        start again from ``rng_seed`` on restore. A head split over the mp
        group is gathered whole, with its optimizer state."""
        return vocab.full_checkpoint(
            {"model": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(),
             "tracker": self.exp_tracker.state_dict(),
             "global_step": self.global_step}, self.model, self.optimizer)

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
        self._graphs = {}  # the optimizer's state tensors are replaced
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.exp_tracker.load_state_dict(state["tracker"])
        self.global_step = int(state["global_step"])
        set_generators(self.model, self.seed, self.device, mesh.dp_rank())
        gen = getattr(self.data_loaders.get("train"), "generator", None)
        if gen is not None:  # the materialized loader seeds each epoch
            gen.manual_seed(self.seed)
        self.resumed_from = target
        print(f"Successfully resumed from {target}")


def build_trainer(cfg, device=None):
    """The trainer ``cfg.trainer`` names (the package's ``__init__``
    registers every trainer)."""
    return TRAINER_REGISTRY.get(cfg.trainer)(cfg, device=device)

"""The data-parallel axis over ``torch.distributed`` (the port's counterpart
of ``sceneverse_tpu/parallel/mesh.py``'s ``dp`` axis).

One process per card, as the reference runs (DDP). ``dataloader.batchsize``
stays the global batch: rank r takes rows ``[r b, (r + 1) b)`` of every
global batch, b = batch / world (``rank_rows``; the loaders in
``data/build.py`` and ``data/materialized.py``). Every cross-row quantity is
global-batch math, as XLA makes it over the JAX mesh:
  * a rank's loss is its own rows' share of the global-batch loss (the
    numerator summed over its rows, the denominator global, a
    data-dependent count through ``all_reduce_sum``); the trainer sums the
    ranks' gradients (``GPSOptimizer``), so the sum is the gradient of the
    global loss;
  * the between-batch contrastive losses build their B x B logits over the
    batch ``all_gather_rows`` gathers;
  * BatchNorm moments (the literal, the folded and the fused ``sa_train``
    route) are ``global_sums`` of the ranks' sums, so the running
    statistics move identically on every rank;
  * the evaluators sum (value, count) over the ranks
    (``common/misc.py::gather_dict``).

``all_reduce_sum`` and ``all_gather_rows`` are autograd functions whose
backward is an all-reduce sum: every rank's share of the loss reaches every
rank's rows. ``all_gather_rows`` is an all-reduce of a zero-filled buffer
that holds this rank's rows at its offset, on every backend: exact (adding
zeros changes no bit) and one collective that gloo and NCCL both take on
CUDA tensors.

With no process group (a plain ``python run_torch.py``) the world is 1 and
every function here is the identity. ``init_from_env`` reads torchrun's
variables; ``parallel.mp`` > 1, the JAX package's vocab-sharded LM head, is
not ported. Neither are ``dp_shard_map``, ``active_mesh``,
``ambient_dp_mesh`` and ``global_put``: GSPMD workarounds with no meaning
for one process per card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init_from_env(backend: str, init_method: str | None = None) -> bool:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``init_method``
    replaces the address, e.g. ``file://`` in tests). Without ``RANK`` and
    ``WORLD_SIZE`` the world is 1 and no group is made. Returns whether
    this call made the group. Under ``nccl`` the process's card is
    ``cuda:LOCAL_RANK``; a failed init raises, never falls back."""
    if dist.is_initialized():
        return False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def check_cfg(cfg) -> None:
    """Only the ``dp`` axis is ported."""
    if int(cfg.select("parallel.mp", 1) or 1) > 1:
        raise NotImplementedError(
            "parallel.mp > 1 (the vocab-sharded LM head of the JAX "
            "package's parallel/mesh.py) is not ported: ROADMAP A4")


def rank_rows(batch: int, n_world: int, r: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows (JAX
    ``shard_batch``). The JAX package shrinks ``dp`` until it divides the
    batch; a launched world cannot shrink, so a batch that does not divide
    raises."""
    if batch % n_world:
        raise ValueError(f"global batch {batch} does not divide over "
                         f"{n_world} ranks")
    b = batch // n_world
    return slice(r * b, (r + 1) * b)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks; the gradient is summed back."""
    return x if world() == 1 else _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (b, ...) stacked in rank order (world b, ...); the
    gradient of this rank's rows is the sum of every rank's."""
    n = world()
    if n == 1:
        return x
    r = rank()
    zeros = lambda k: x.new_zeros((k * x.shape[0], *x.shape[1:]))
    return _AllReduceSum.apply(torch.cat([zeros(r), x, zeros(n - r - 1)]))


def global_sums(sums, rows: int):
    """``(sums, n)``: each tensor of ``sums`` summed over the ranks and the
    ranks' row count ``n``, in one collective (gradients flow back to
    every rank). In a world of 1 the tensors come back as they are and
    ``n`` is ``rows``."""
    if world() == 1:
        return tuple(sums), rows
    flat = [s.reshape(-1) for s in sums]
    count = torch.full((1,), float(rows), device=flat[0].device,
                       dtype=flat[0].dtype)
    buf = _AllReduceSum.apply(torch.cat(flat + [count]))
    out, off = [], 0
    for s in sums:
        out.append(buf[off:off + s.numel()].view_as(s))
        off += s.numel()
    return tuple(out), buf[-1]


def _host_device():
    """Where a host value rides a collective: the card under NCCL, the CPU
    otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(values) -> np.ndarray:
    """float64 sum over the ranks of a host array (the evaluators'
    (value, count) pairs)."""
    arr = np.asarray(values, np.float64)
    if world() == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_host_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    if world() == 1:
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


@torch.no_grad()
def all_reduce_flat(tensors) -> None:
    """Sum ``tensors`` (one dtype) over the ranks in place, as one flat
    buffer."""
    if world() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, in place."""
    if world() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def barrier() -> None:
    if world() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()

"""The process grid over ``torch.distributed`` (the port's counterpart of
``sceneverse_tpu/parallel/mesh.py``'s ('dp', 'mp') mesh).

One process per card, as the reference runs (DDP). The world of W
processes is a dp x mp grid, mp = ``parallel.mp`` (default 1), laid out as
the JAX mesh lays out its devices (``devices.reshape(n // mp, mp)``): rank r
has ``dp_rank = r // mp`` and ``mp_rank = r % mp``, so mp peers are
adjacent ranks and share a node. ``setup_grid`` builds two families of
subgroups: the dp groups (equal ``mp_rank``) and the mp groups (equal
``dp_rank``). With mp = 1 the dp group is the world.

``dataloader.batchsize`` stays the global batch: dp rank d takes rows
``[d b, (d + 1) b)`` of every global batch, b = batch / dp (``rank_rows``;
the loaders in ``data/build.py`` and ``data/materialized.py``), and every
rank of an mp group holds the same rows. Every cross-row quantity is
global-batch math over the dp group, as XLA makes it over the JAX mesh's
'dp' axis (summing over the world would count each row mp times):
  * a rank's loss is its dp shard's share of the global-batch loss (the
    numerator summed over its rows, the denominator global, a
    data-dependent count through ``all_reduce_sum``); the trainer sums the
    gradients over the dp group (``GPSOptimizer``), so the sum is the
    gradient of the global loss;
  * the between-batch contrastive losses build their B x B logits over the
    batch ``all_gather_rows`` gathers;
  * BatchNorm moments (the literal, the folded and the fused ``sa_train``
    route) are ``global_sums`` of the dp shards' sums, so the running
    statistics move identically on every rank;
  * the evaluators sum (value, count) over the dp group
    (``common/misc.py::gather_dict``).
The mp group carries the vocabulary-parallel LM head
(``parallel/vocab.py``): its logits' all-gather, its input's gradient sum,
its share of the global-norm clip, and the replicas' gradient broadcast.

``all_reduce_sum`` and ``all_gather_rows`` are autograd functions whose
backward is an all-reduce sum: every rank's share of the loss reaches every
rank's rows. ``all_gather_rows`` is an all-reduce of a zero-filled buffer
that holds this rank's rows at its offset, on every backend: exact (adding
zeros changes no bit) and one collective that gloo and NCCL both take on
CUDA tensors.

With no process group (a plain ``python run_torch.py``) the world is 1 and
every function here is the identity; ``parallel.mp`` > 1 then raises, as
does a world that mp does not divide (JAX ``make_mesh``), with no fallback
to mp = 1. ``init_from_env`` reads torchrun's variables. Not ported:
``dp_shard_map``, ``active_mesh``, ``ambient_dp_mesh`` and ``global_put``,
GSPMD workarounds with no meaning for one process per card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# the grid setup_grid built: (the world group it was built on, mp, this
# rank's dp group, this rank's mp group); None for mp = 1
_GRID = None


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def mp_world() -> int:
    return _GRID[1] if _GRID is not None else 1


def mp_rank() -> int:
    return rank() % mp_world()


def dp_world() -> int:
    return world() // mp_world()


def dp_rank() -> int:
    return rank() // mp_world()


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
    global _GRID
    _GRID = None
    if dist.is_initialized():
        dist.destroy_process_group()


def setup_grid(cfg) -> None:
    """The dp x mp grid of ``parallel.mp`` over the world. Every rank calls
    it at the same point (the subgroups are made collectively); a grid
    already built for this world and mp is kept. Raises for mp > 1 with no
    process group and for a world that mp does not divide."""
    global _GRID
    mp = int(cfg.select("parallel.mp", 1) or 1)
    if mp < 1:
        raise ValueError(f"parallel.mp={mp} must be at least 1")
    if mp > 1 and not dist.is_initialized():
        raise ValueError(
            f"parallel.mp={mp} splits the LM head over mp processes and "
            "needs a process group: launch with launch_torch.py --mode spmd "
            "(or torchrun)")
    n = world()
    if n % mp:
        raise ValueError(f"a world of {n} processes is not divisible by "
                         f"parallel.mp={mp}")
    if mp == 1:
        _GRID = None
        return
    if _GRID is not None and _GRID[0] is dist.group.WORLD and _GRID[1] == mp:
        return
    dp, r = n // mp, rank()
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)])
                 for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)])
                 for d in range(dp)]
    _GRID = (dist.group.WORLD, mp, dp_groups[r % mp], mp_groups[r // mp])


def group(axis: str = "dp"):
    """The process group of ``axis`` ("dp", "mp" or "world") for this rank;
    None stands for the world."""
    if _GRID is not None and axis != "world":
        return {"dp": _GRID[2], "mp": _GRID[3]}[axis]
    if axis == "mp":
        raise ValueError("no mp group: parallel.mp is 1")
    return None


def _size(axis: str) -> int:
    return {"dp": dp_world, "mp": mp_world, "world": world}[axis]()


def rank_rows(batch: int, n_world: int, r: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows (JAX
    ``shard_batch``) for dp rank ``r`` of ``n_world``. The JAX package
    shrinks ``dp`` until it divides the batch; a launched world cannot
    shrink, so a batch that does not divide raises."""
    if batch % n_world:
        raise ValueError(f"global batch {batch} does not divide over "
                         f"{n_world} ranks")
    b = batch // n_world
    return slice(r * b, (r + 1) * b)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = x.clone()
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_sum(x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``; the gradient is summed
    back."""
    return x if _size(axis) == 1 else _AllReduceSum.apply(x, group(axis))


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The dp shards' ``x`` (b, ...) stacked in dp order (dp b, ...); the
    gradient of this rank's rows is the sum of every dp rank's."""
    n = dp_world()
    if n == 1:
        return x
    r = dp_rank()
    zeros = lambda k: x.new_zeros((k * x.shape[0], *x.shape[1:]))
    return _AllReduceSum.apply(torch.cat([zeros(r), x, zeros(n - r - 1)]),
                               group("dp"))


def global_sums(sums, rows: int):
    """``(sums, n)``: each tensor of ``sums`` summed over the dp group and
    the dp shards' row count ``n``, in one collective (gradients flow back
    to every rank). Over one dp shard the tensors come back as they are and
    ``n`` is ``rows``."""
    if dp_world() == 1:
        return tuple(sums), rows
    flat = [s.reshape(-1) for s in sums]
    count = torch.full((1,), float(rows), device=flat[0].device,
                       dtype=flat[0].dtype)
    buf = _AllReduceSum.apply(torch.cat(flat + [count]), group("dp"))
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


def all_reduce_host(values, axis: str = "dp") -> np.ndarray:
    """float64 sum over the ranks of ``axis`` of a host array (the
    evaluators' (value, count) pairs)."""
    arr = np.asarray(values, np.float64)
    if _size(axis) == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_host_device())
    dist.all_reduce(t, group=group(axis))
    return t.cpu().numpy()


def all_gather_objects(obj, axis: str = "dp") -> list:
    """Every ``axis`` rank's ``obj``, in rank order."""
    n = _size(axis)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group(axis))
    return out


def _flat_apply(tensors, op) -> None:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def all_reduce_flat(tensors, axis: str = "dp") -> None:
    """Sum ``tensors`` (one dtype) over the ranks of ``axis`` in place, as
    one flat buffer."""
    if _size(axis) == 1 or not tensors:
        return
    _flat_apply(tensors, lambda f: dist.all_reduce(f, group=group(axis)))


@torch.no_grad()
def broadcast_flat_mp(tensors) -> None:
    """The mp group's first rank's ``tensors`` (one dtype) to its peers, in
    place, as one flat buffer."""
    if mp_world() == 1 or not tensors:
        return
    src = dp_rank() * mp_world()
    _flat_apply(tensors, lambda f: dist.broadcast(f, src, group=group("mp")))


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

"""Launcher of the PyTorch/CUDA port (sceneverse_tpu_torch), with launch.py's
flags.

    python launch_torch.py --config configs/final/all_pretrain.yaml [k=v ...]
    python launch_torch.py --mode spmd --config ... \\
        --coordinator host0:29500 --num-processes 2 --process-id 0 [k=v ...]
    python launch_torch.py --mode submitit --config ... --nodes 2 [k=v ...]

Modes:
  * ``python``   runs ``run_torch.main`` in this process: a world of 1.
  * ``spmd``     one command per node, as launch.py's: ``--process-id`` is
                 the node rank, ``--num-processes`` the node count (default
                 ``--nodes``), ``--coordinator`` the rendezvous host:port
                 (default ``localhost:--port``). It starts one process per
                 local card (``--nproc-per-node``, default
                 ``torch.cuda.device_count()``; required with
                 ``device=cpu``) through PyTorch's own launcher,
                 ``torch.distributed.run``, each running ``run_torch.py``.
                 ``dist_backend=gloo`` passes through as an override, so
                 several gloo ranks can share one card.
  * ``submitit`` submits the spmd mode to SLURM (one task a node, the
                 node's cards as ``slurm_gpus_per_node``) and re-queues on
                 preemption; each node's payload derives the coordinator
                 from the job's first hostname and ``--port``, the node
                 count from its tasks and the node rank from its global
                 rank (launch.py:70-117).

``--mixed_precision`` adds the ``mixed_precision=`` override. Imports
nothing of JAX or of the JAX package; ``submitit`` is imported only by
its mode.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    parser = argparse.ArgumentParser("sceneverse_tpu_torch launcher")
    parser.add_argument("--mode", default="python",
                        choices=["python", "spmd", "submitit"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--name", default="sceneverse")
    parser.add_argument("--time", default=24 * 60, type=int,
                        help="SLURM minutes")
    parser.add_argument("--partition", default="gpu")
    parser.add_argument("--nodes", default=1, type=int)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the rendezvous (spmd)")
    parser.add_argument("--port", default=8476, type=int,
                        help="rendezvous port when the coordinator is "
                             "derived (localhost, or SLURM's first host)")
    parser.add_argument("--num-processes", default=None, type=int,
                        help="node commands of the spmd world (default "
                             "--nodes)")
    parser.add_argument("--process-id", default=None, type=int,
                        help="this node's rank (spmd)")
    parser.add_argument("--nproc-per-node", default=None, type=int,
                        help="processes (cards) a node (default "
                             "torch.cuda.device_count())")
    parser.add_argument("--mixed_precision", default=None,
                        choices=["no", "fp16", "bf16"])
    parser.add_argument("opts", nargs="*", help="config overrides key=val")
    args = parser.parse_args(argv)
    if args.mixed_precision:
        args.opts = [*args.opts, f"mixed_precision={args.mixed_precision}"]
    return args


def run_args(config: str, opts) -> list:
    """``run_torch.py``'s arguments for ``--config`` and the overrides."""
    cfg_path = "/".join(config.split("/")[:-1]) or "configs"
    cfg_name = config.split("/")[-1]
    return ["--config-path", cfg_path, "--config-name", cfg_name, *opts]


def python_launch(args):
    import run_torch

    return run_torch.main(run_args(args.config, args.opts))


def _on_cpu(opts) -> bool:
    return any(o.startswith("device=") and o.split("=", 1)[1].startswith(
        "cpu") for o in opts)


def cards_per_node(args) -> int:
    """``--nproc-per-node``, else this host's CUDA cards; a run on the CPU
    must say how many processes it wants."""
    if args.nproc_per_node is not None:
        return args.nproc_per_node
    if _on_cpu(args.opts):
        raise SystemExit("device=cpu: give --nproc-per-node")
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("no CUDA card here: give --nproc-per-node (and "
                         "device=cpu to train on the CPU)")
    return n


def spmd_argv(args) -> list:
    """``torch.distributed.run``'s arguments for this node."""
    host, port = (args.coordinator or f"localhost:{args.port}").rsplit(":", 1)
    nodes = args.num_processes or args.nodes
    node_rank = args.process_id or 0
    if not 0 <= node_rank < nodes:
        raise SystemExit(f"--process-id {node_rank} is outside a world of "
                         f"{nodes} nodes")
    return ["--nnodes", str(nodes), "--node_rank", str(node_rank),
            "--nproc_per_node", str(cards_per_node(args)),
            "--master_addr", host, "--master_port", port,
            os.path.join(REPO, "run_torch.py"),
            *run_args(args.config, args.opts)]


def spmd_launch(args):
    """This node's processes, through ``torch.distributed.run`` (which
    raises when a process fails)."""
    from torch.distributed import run as torchrun

    return torchrun.main(spmd_argv(args))


class SubmititLauncher:
    """The payload submitit runs on every node (one SLURM task a node):
    the coordinator is the job's first hostname at ``--port`` unless the
    user pinned one, the node count is the job's task count and the node
    rank its global rank (launch.py's ``SubmititLauncher``)."""

    def __init__(self, args):
        self.args = args
        # a pinned coordinator is kept as it is; a derived one is derived
        # again on every call: a re-queued job may land on other nodes, and
        # the first allocation's host would point the rendezvous at a dead
        # one
        self._user_coordinator = args.coordinator

    def __call__(self):
        import submitit

        env = submitit.JobEnvironment()
        args = self.args
        args.coordinator = (self._user_coordinator
                            if self._user_coordinator is not None
                            else f"{env.hostnames[0]}:{args.port}")
        args.nodes = args.num_processes = env.num_tasks
        args.process_id = env.global_rank
        return spmd_launch(args)

    def checkpoint(self):
        """Re-queue on a timeout or a preemption (the run resumes from its
        snapshotted config and checkpoints, ``resume=True``); the new
        payload drops a derived coordinator, so the new allocation derives
        its own."""
        import submitit

        args = self.args
        args.coordinator = self._user_coordinator
        return submitit.helpers.DelayedSubmission(SubmititLauncher(args))


def submitit_launch(args):
    try:
        import submitit
    except ImportError as e:
        raise SystemExit("submitit is not installed") from e
    executor = submitit.AutoExecutor(folder=f"slurm/{args.name}")
    executor.update_parameters(
        name=args.name, timeout_min=args.time, nodes=args.nodes,
        slurm_partition=args.partition, tasks_per_node=1,
        slurm_gpus_per_node=cards_per_node(args),
        slurm_max_num_timeout=30, slurm_signal_delay_s=120,
    )
    job = executor.submit(SubmititLauncher(args))
    print(f"submitted {job.job_id}")
    return job


def main(argv=None):
    args = parse_args(argv)
    return {"python": python_launch, "spmd": spmd_launch,
            "submitit": submitit_launch}[args.mode](args)


if __name__ == "__main__":
    main()

"""The port's launcher (``launch_torch.py``), the counterpart of
``tests/test_launch_logger.py::test_submitit_launch_with_stub``: the
submitit mode with a stub module (no submitit in this image), the spmd
mode's ``torch.distributed.run`` arguments, and one real spmd run of two
processes on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest

import launch_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/final/synthetic_pretrain.yaml"


def test_submitit_launch_with_stub(monkeypatch):
    calls = {}

    class _Job:
        job_id = "4242"

    class _AutoExecutor:
        def __init__(self, folder):
            calls["folder"] = folder

        def update_parameters(self, **kw):
            calls["params"] = kw

        def submit(self, fn, *args):
            calls["submit"] = (fn, args)
            return _Job()

    stub = types.ModuleType("submitit")
    stub.AutoExecutor = _AutoExecutor
    monkeypatch.setitem(sys.modules, "submitit", stub)

    args = launch_torch.parse_args([
        "--mode", "submitit", "--config", CONFIG, "--name", "testjob",
        "--time", "60", "--nodes", "2", "--partition", "h100",
        "--nproc-per-node", "8", "--mixed_precision", "bf16",
    ])
    job = launch_torch.submitit_launch(args)

    assert job.job_id == "4242"
    assert calls["folder"] == "slurm/testjob"
    params = calls["params"]
    assert params["nodes"] == 2 and params["timeout_min"] == 60
    assert params["slurm_partition"] == "h100"
    assert params["tasks_per_node"] == 1  # one launcher a node
    assert params["slurm_gpus_per_node"] == 8  # the node's cards
    assert params["slurm_max_num_timeout"] == 30
    assert params["slurm_signal_delay_s"] == 120
    fn, fnargs = calls["submit"]
    assert isinstance(fn, launch_torch.SubmititLauncher) and fnargs == ()
    assert "mixed_precision=bf16" in args.opts

    # the payload on each of 2 nodes, under a fake SLURM JobEnvironment
    class _JobEnv:
        hostnames = ["node-a", "node-b"]
        num_tasks = 2

        def __init__(self, rank):
            self.global_rank = rank

    spmd_calls = []
    monkeypatch.setattr(launch_torch, "spmd_launch",
                        lambda a: spmd_calls.append(
                            (a.coordinator, a.num_processes, a.process_id,
                             a.nodes)))
    for rank in range(2):
        stub.JobEnvironment = lambda r=rank: _JobEnv(r)
        node_args = launch_torch.parse_args([
            "--mode", "submitit", "--config", CONFIG, "--nodes", "2"])
        launch_torch.SubmititLauncher(node_args)()
    assert spmd_calls == [("node-a:8476", 2, 0, 2), ("node-a:8476", 2, 1, 2)]

    # re-queue on preemption
    resubs = []
    helpers = types.ModuleType("submitit.helpers")

    class _Delayed:
        def __init__(self, fn):
            resubs.append(fn)

    helpers.DelayedSubmission = _Delayed
    stub.helpers = helpers
    monkeypatch.setitem(sys.modules, "submitit.helpers", helpers)
    launch_torch.SubmititLauncher(args).checkpoint()
    assert len(resubs) == 1 and isinstance(resubs[0],
                                           launch_torch.SubmititLauncher)

    # a derived coordinator is derived again after a re-queue that lands
    # on other nodes
    node_args = launch_torch.parse_args([
        "--mode", "submitit", "--config", CONFIG, "--nodes", "2"])
    payload = launch_torch.SubmititLauncher(node_args)
    stub.JobEnvironment = lambda: _JobEnv(0)
    spmd_calls.clear()
    payload()
    payload.checkpoint()
    requeued = resubs[-1]
    assert requeued.args.coordinator is None

    class _JobEnv2(_JobEnv):
        hostnames = ["node-x", "node-y"]

    stub.JobEnvironment = lambda: _JobEnv2(1)
    requeued()
    assert spmd_calls[-1] == ("node-x:8476", 2, 1, 2)

    # a pinned coordinator survives the re-queue as it is
    pinned = launch_torch.parse_args([
        "--mode", "submitit", "--config", CONFIG,
        "--coordinator", "pinned-host:1234"])
    p2 = launch_torch.SubmititLauncher(pinned)
    p2()
    assert spmd_calls[-1][0] == "pinned-host:1234"
    p2.checkpoint()
    assert resubs[-1].args.coordinator == "pinned-host:1234"


def test_submitit_without_the_package_exits(monkeypatch):
    monkeypatch.setitem(sys.modules, "submitit", None)
    args = launch_torch.parse_args(["--mode", "submitit", "--config", CONFIG,
                                    "--nproc-per-node", "1"])
    with pytest.raises(SystemExit, match="submitit"):
        launch_torch.submitit_launch(args)


@pytest.mark.parametrize("node", [0, 1])
def test_spmd_arguments_for_two_nodes_of_two(monkeypatch, node):
    seen = []
    import torch.distributed.run as torchrun

    monkeypatch.setattr(torchrun, "main", seen.append)
    launch_torch.main([
        "--mode", "spmd", "--config", CONFIG, "--coordinator",
        "host0:29500", "--num-processes", "2", "--process-id", str(node),
        "--nproc-per-node", "2", "parallel.mp=2", "dist_backend=gloo"])
    assert seen == [[
        "--nnodes", "2", "--node_rank", str(node), "--nproc_per_node", "2",
        "--master_addr", "host0", "--master_port", "29500",
        os.path.join(REPO, "run_torch.py"), "--config-path", "configs/final",
        "--config-name", "synthetic_pretrain.yaml", "parallel.mp=2",
        "dist_backend=gloo"]]


def test_spmd_refuses_what_it_cannot_place():
    on_cpu = launch_torch.parse_args(["--mode", "spmd", "--config", CONFIG,
                                      "device=cpu"])
    with pytest.raises(SystemExit, match="nproc-per-node"):
        launch_torch.spmd_argv(on_cpu)
    outside = launch_torch.parse_args([
        "--mode", "spmd", "--config", CONFIG, "--nodes", "2",
        "--process-id", "2", "--nproc-per-node", "1"])
    with pytest.raises(SystemExit, match="outside"):
        launch_torch.spmd_argv(outside)


TINY = [
    "model.language.args.hidden_size=32",
    "model.language.args.num_hidden_layers=1",
    "model.language.args.num_attention_heads=2",
    "model.vision.args.hidden_size=32", "model.vision.args.num_layers=1",
    "model.vision.args.num_attention_heads=2",
    "model.vision.args.dim_feedforward=64",
    "model.grounding.args.hidden_size=32", "model.grounding.args.num_layers=1",
    "model.grounding.args.num_attention_heads=2",
    "model.grounding.args.dim_feedforward=64",
    "model.heads.pretrain_head.args.hidden_size=32",
    "model.heads.pretrain_head.args.vocab_size=128",
    "data.args.max_obj_len=4", "data.args.num_points=32",
    "data.args.max_seq_len=8", "data.args.max_scene_cap_len=8",
    "model.lm_max_predictions=4", "dataloader.batchsize=2",
    "data.synthetic_size=2", "solver.epochs=1", "device=cpu",
]


def test_spmd_runs_two_processes_on_the_cpu(tmp_path):
    """One step of a tiny config over (dp 1, mp 2), two processes that
    ``torch.distributed.run`` starts on this host."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "launch_torch.py"), "--mode",
         "spmd", "--nproc-per-node", "2", "--port", str(_free_port()),
         "--config", os.path.join(REPO, CONFIG), *TINY, "parallel.mp=2",
         f"base_dir={tmp_path}"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    for r in range(2):
        assert f"rank {r} of 2" in out.stdout
    assert out.stdout.count("'target_metric'") == 2


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_python_mode_runs_in_this_process(tmp_path):
    out = launch_torch.main(["--config", os.path.join(REPO, CONFIG), *TINY,
                             f"base_dir={tmp_path}"])
    assert out["trainer"].global_step == 1
    assert "target_metric" in out["results"]

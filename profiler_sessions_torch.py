"""torch.profiler windows late in a process that has traced train steps:
how many of a known kernel's launches each window still traces.

    python3 profiler_sessions_torch.py

Two processes, one a mode, each on the frozen slice at full width
(``chip_smoke._trainer``: 768 wide, 80 objects x 1024 points, batch 32,
f32) for 6 rounds of: what the mode does, a trace of 3 train steps through
``utils/profiling.py::trace`` (as ``profile.enabled`` does), then 4
CUDA-only windows of 5 ``fps`` launches each (``chip_smoke._traced``).
``fixed`` keeps one trainer, nothing between the rounds; ``fresh_trainer``
builds a new trainer each round, the last one dropped and the cached
memory handed back, as the smoke's phases do. Prints one JSON line per
round: the trace's kernel events, the port's launches and the kernels of
them it traced, and the ``fps`` launches each later window traced (5 when
nothing is lost). No CUDA graph is made. Needs one CUDA card; imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MODES = ("fixed", "fresh_trainer")
ROUNDS, WINDOWS = 6, 4


def rounds(mode, card):
    import chip_smoke as cs
    import torch

    from sceneverse_tpu_torch.ops import sa_forward as sa
    from sceneverse_tpu_torch.trainer.build import to_device
    from sceneverse_tpu_torch.utils.profiling import trace

    g = torch.Generator(device="cpu").manual_seed(0)
    xyz = (torch.rand((32 * 80, 1024, 3), generator=g) - 0.5).cuda()
    sa.fps(xyz, 32)
    t = None
    for k in range(1, ROUNDS + 1):
        if t is None or mode == "fresh_trainer":
            t = None
            cs._free()
            t = cs._trainer(f"profiler_sessions_{mode}", [])
            fused = t._fusable_metrics(t._train_evaluator())
            hosts = [to_device(b, t.device) for _, b in
                     zip(range(3), t.data_loaders["train"])]
        with trace(os.path.join(cs.REPO, "build", "profiler_sessions")) as w:
            for b in hosts:
                t.train_forward_backward(b, fused)
        counts = [sum("sv_fps_kernel" in e.name
                      for e in cs._traced(lambda: sa.fps(xyz, 32), 5))
                  for _ in range(WINDOWS)]
        print(json.dumps({"mode": mode, "round": k,
                          "trace_kernels": w.kernels,
                          "trace_launches": dict(w.launches),
                          "trace_port_kernels": w.traced,
                          "window_fps_launches": counts, "card": card}),
              flush=True)


def main():
    import chip_smoke as cs

    if len(sys.argv) > 1:  # one mode, in the process main() started
        rounds(sys.argv[1], cs.phase_env())
        return
    cs.phase_env()
    cs.phase_build()
    for mode in MODES:
        subprocess.run([sys.executable, os.path.abspath(__file__), mode],
                       check=True)


if __name__ == "__main__":
    main()

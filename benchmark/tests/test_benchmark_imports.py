"""What the benchmark loads: no module of a cell's run has the top-level
name jax, jaxlib, flax or sceneverse_tpu (compared whole, so the port,
sceneverse_tpu_torch, passes), and the reference and the yardstick load
nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "OMP_NUM_THREADS": "2"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = (
        "import json, sys\n"
        "from benchmark import run\n"
        "from benchmark.tests.tiny import shrink\n"
        f"a = run.parse(['--workload', '{cell}', '--seed', '5', "
        "'--seconds', '0.3', '--trace', '0'])\n"
        "run.run(a, device='cpu', overrides=shrink)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules(code)
    assert "sceneverse_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sceneverse_tpu"}


def test_reference_and_yardstick_load_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from benchmark.harness import spec\n"
        "import benchmark.reference.gps, benchmark.harness.traffic\n"
        "import benchmark.harness.check, benchmark.harness.gps_work\n"
        "import benchmark.harness.trace, benchmark.harness.peaks\n"
        "import benchmark.harness.readers, benchmark.control\n"
        "for p in sorted(Path('benchmark').glob('*/*_reference.py')):\n"
        "    spec.load_module(p, p.stem)\n"
        "for p in sorted(Path('benchmark/metrics').glob('*.py')):\n"
        "    spec.load_module(p, p.stem.replace('.', '_'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules(code)
    assert not tops & {"sceneverse_tpu_torch", "jax", "jaxlib", "flax",
                       "sceneverse_tpu"}

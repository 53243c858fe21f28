"""The output check's control on the card: the plain reference computed
one precision lower (TF32 products where the configuration states float32)
fails a cell's limits, and half of each batch left out fails them too,
here at the configured widths over a smaller batch. The full-size readings
are ``benchmark/control.py``'s (PERF.md gives them)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import control
from benchmark.harness import check, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_and_half_batch_fail_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.Cell(BENCH, cell)
    c.traffic.update(batch=16)
    got = control.readings(c, 2 ** 31 + 5, "cuda")
    for name in ("tf32", "half_batch"):
        ok, _ = check.judge(got[name], c.limits)
        assert not ok, (name, got[name])

"""A whole run of each cell on the CPU at a size it holds, the look for a
card skipped: the program against the plain reference comes out correct,
and with the timed path broken underneath it does not (``faults.py``: a
step that leaves its state unchanged, half of each batch left out, an
answer altered where it is produced). A cell of two chips, run as two
ranks over gloo, is correct in each mode, and a training cell with the
exchange between the ranks left out is not."""

import json
from pathlib import Path

import pytest

from benchmark import run
from benchmark.harness import spec
from benchmark.tests import faults
from benchmark.tests.tiny import shrink

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _mode(cell):
    return spec.Cell(BENCH, cell).traffic["mode"]


def _run(cell, seed, fault=None, trace=0, bench=None, argv=()):
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", "0.5", "--trace", str(trace), *argv])
    return run.run(args, device="cpu", overrides=shrink, fault=fault,
                   bench_path=bench)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell, 2 ** 31 + 17, trace=1)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(spec.Cell(BENCH, cell).limits)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.FAULTS[_mode(c)]],
    ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(cell, fault):
    res = _run(cell, 23, fault=fault)
    assert not res["correct"], res["check"]


@pytest.fixture(scope="module")
def two_chips(tmp_path_factory):
    """BENCHMARK.json with every cell on two chips."""
    bench = json.loads(json.dumps(BENCH))
    for w in bench["workloads"]:
        w["chips"] = 2
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.mark.parametrize("mode,fault", [("train", None),
                                        ("train", "no_exchange"),
                                        ("eval", None)])
def test_two_ranks(two_chips, mode, fault):
    cell = next(c for c in CELLS if _mode(c) == mode)
    argv = ["--overrides", "benchmark.tests.tiny:shrink"]
    if fault:
        argv += ["--fault", f"benchmark.tests.faults:{fault}"]
    res = _run(cell, 31, bench=two_chips, argv=argv)
    assert res["device"]["count"] == 2
    assert res["correct"] is (fault is None), res["check"]

"""BENCHMARK.json and what it names: every configuration, traffic mix,
work counter and per-layer reader is found by name, and the file keeps
the contract's shape."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.Cell(BENCH, cell)
    assert c.config["name"] == c.entry["config"]
    assert callable(c.work.work)
    assert callable(c.mode.Mode) and callable(c.mode.check_run)
    assert callable(c.reference.weights)
    assert c.mode.RATE[0] in {e["name"] for e in c.end_to_end}
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.traffic["batch"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_without_a_trace(metric):
    ctx = {"trace": None, "traced_steps": 0, "traced_work": [],
           "window_steps": 0, "window_s": 0.0, "window_work": [],
           "dispatch_s": [], "K": 4}
    assert spec.Cell(BENCH, CELLS[0]).reader(metric)(ctx) is None

"""What ``BENCHMARK.json`` names, found by name: a cell, its configuration
(``benchmark/configs/<config>.json``, with its work counter
``<config>_work.py`` and its plain reference ``<config>_reference.py``
beside it), its traffic mix (``benchmark/traffic/<traffic>.json``), the
mode that mix names (``benchmark/modes/<mode>.py``: how the program is
driven and checked), the limits of its check
(``benchmark/limits/<cell>.json``) and the readers of its per-layer metrics
(``benchmark/metrics/<metric>.py``). A later cell, configuration, mode or
metric is a new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark folder


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, root: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((root.parent / conf["file"]).read_text())
        self.config_name = c = conf["name"]
        self.work = load_module(root / "configs" / f"{c}_work.py", f"work_{c}")
        self.reference = load_module(root / "configs" / f"{c}_reference.py",
                                     f"reference_{c}")
        self.traffic = json.loads(
            (root / "traffic" / f"{self.entry['traffic']}.json").read_text())
        m = self.traffic["mode"]
        self.mode = load_module(root / "modes" / f"{m}.py", f"mode_{m}")
        self.limits = json.loads(
            (root / "limits" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of a per-layer metric's own file."""
        mod = load_module(HERE / "metrics" / f"{metric}.py",
                          f"metric_{metric.replace('.', '_')}")
        return mod.read


def load_bench(path: Path) -> dict:
    return json.loads(Path(path).read_text())

#!/usr/bin/env python3
"""The output check's control and faults, read on the chip at a cell's own
size: for each seed the cell's mode (``modes/<mode>.py``, ``control``)
puts the plain reference in the program's place

  * one precision lower (``tf32``: the float32 products in TF32), the
    control that the check has to fail;
  * over half of each batch (``half_batch``), a fault that a cell can have;

and reads the check's numbers against the sound reference. Prints one JSON
line a seed: {"seed", "<variant>": {number: [value, where]}}.

    python3 benchmark/control.py --workload gps_pretrain.train \
        --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, device):
    return {"seed": seed, **cell.mode.control(cell, seed, device)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    cell = spec.Cell(spec.load_bench(ROOT / "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda")), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Read a cell's control: the plain reference put in the program's place
and broken as the configuration's guarantee would tempt, judged by the
cell's own check (the driver's `check`, through its `control`).

    python3 phbench/tools/control.py --workload group_1m_sparse \
        --seeds 5,6,7

Library cells: the reference's grouping from the identity variants alone
(the 8-fold cheaper search that skips the dihedral variants the tool
promises to match).  Service cells: the golden PDQ in bfloat16 (the
precision below the float32 that PDQ states) and the reference's answers
from those hashes, over a seeded sample of the pool's bodies as large as
a run's sample; with --fault radius the float32 golden instead, answering
with the radius one short (a gate off by one, the fault the answers'
check has to catch).  No program runs, so no window is needed; the
cell's inputs are its own.  A cell may be one of pending/*.json.  For each seed it prints the checks beside
their limits on standard error and one JSON line on standard output: the
seed, `correct` and `checks`, as a run's result line has them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("radius",), default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (tests, at a small size)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from phbench import harness

    cell = harness.Cell(args.workload, harness.with_pending())
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    report(cell, [int(s) for s in args.seeds.split(",")], dev, args.fault)
    return 0


def report(cell, seeds, dev, fault=None) -> list[dict]:
    """One control line a seed, each also printed as a JSON line."""
    drv = cell.driver()
    lines = []
    for seed in seeds:
        checks, _ = drv.control(cell, seed, dev, fault)
        print(f"control {cell.name} seed {seed} fault {fault}:",
              file=sys.stderr)
        checks.report()
        line = {"workload": cell.name, "seed": seed, "fault": fault,
                "correct": checks.correct, "checks": checks.as_dict()}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    sys.exit(main())

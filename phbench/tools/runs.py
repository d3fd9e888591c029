#!/usr/bin/env python3
"""Run one cell several times, each run a process of its own, and sum up.

    python3 phbench/tools/runs.py --workload NAME --seeds 11,12,13 \
        --seconds 30 [--trace 1] [--out FILE.jsonl]

Each run is `phbench/run.py` with one seed, in turn.  Every result line,
with the run's wall time and exit code, goes to --out (JSON lines); the
summary gives, for each metric, the values, the median and the spread
(Q3 - Q1 over the median, Python's statistics.quantiles), and `setup_s`
of the first run apart, since it builds the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tail", type=int, default=1500,
                    help="characters of each run's stderr to print")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from phbench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for seed in seeds:
        cmd = [sys.executable, "phbench/run.py", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = None
        row = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": wall, "trace": args.trace, "result": res}
        rows.append(row)
        print(f"--- seed {seed} rc {p.returncode} wall {wall:.1f} s",
              flush=True)
        print(p.stderr[-args.tail:], flush=True)
        print(last[:3000], flush=True)
        if args.out:
            out = ROOT / args.out
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    good = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in good for k in r["metrics"]})
    print(f"=== {args.workload}: {len(good)} of {len(rows)} runs gave a "
          f"result, correct in "
          f"{sum(1 for r in good if r['correct'])}", flush=True)
    for name in names:
        vals = [r["metrics"][name]["value"] for r in good
                if name in r["metrics"]]
        later = vals[1:] if name == "setup_s" and len(vals) > 2 else vals
        s = harness.quartile_spread(later) if len(later) > 1 else None
        print(f"{name}: median {statistics.median(later)!r} spread "
              f"{s if s is None else round(s, 5)} values {vals}", flush=True)
    return 0 if good and len(good) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())

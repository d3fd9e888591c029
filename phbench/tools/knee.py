#!/usr/bin/env python3
"""Sweep the offered rate of an open-loop service cell, to find its knee.

    python3 phbench/tools/knee.py --workload serve_1m_open --seed 7 \
        --rates 20,40,60 --seconds 20

One process: the cell's set-up once, then one window of --seconds at each
rate in turn (a fresh load generator each), with the answers of every
window checked as a run checks them.  For each rate it prints the
requests, p50 and p99 from when each was due, how late the sends ran,
and whether a backlog grew: the median latency of the window's last
third over its first third.  The knee is the highest rate whose backlog
does not grow.  A cell may be one of pending/*.json.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from phbench import harness
    from rupphash_tpu_torch import device as port_device

    cell = harness.Cell(args.workload, harness.with_pending())
    harness.require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    port_device.pin("cuda")
    drv = cell.driver()
    st = drv.setup(cell, args.seed, dev)
    print(f"card: {harness.power_limit()}", flush=True)
    first = True
    for rate in [float(r) for r in args.rates.split(",")]:
        if not first:
            drv.start_loadgen(st, dict(cell.traffic, rate=rate))
        elif rate != float(cell.traffic["rate"]):
            st.loadgen.kill()
            st.loadgen.wait()
            drv.start_loadgen(st, dict(cell.traffic, rate=rate))
        first = False
        drv.window(st, args.seconds)
        e2e = drv.end_to_end(st)
        ok = sorted(st.records, key=lambda r: r[1])
        third = max(1, len(ok) // 3)
        lat = [r[3] - r[1] for r in ok]
        grow = (statistics.median(lat[-third:])
                / statistics.median(lat[:third]))
        late = sorted(r[2] - r[1] for r in ok)
        failed = sum(1 for r in ok if r[4] != 200)
        done = sum(1 for r in ok if r[4] == 200 and r[3] <= args.seconds)
        print(f"rate {rate:g}/s: {len(ok)} requests, {failed} failed, "
              f"p50 {e2e['query_p50_ms']:.2f} ms, p99 "
              f"{e2e['query_p99_ms']:.2f} ms, answered in window "
              f"{done / args.seconds:.1f}/s, sends late median "
              f"{late[len(late) // 2] * 1e3:.2f} ms max "
              f"{late[-1] * 1e3:.2f} ms, last/first third latency "
              f"{grow:.2f}", flush=True)
    drv.close(st)
    return 0


if __name__ == "__main__":
    sys.exit(main())

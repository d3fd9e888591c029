#!/usr/bin/env python3
"""Run one cell of the benchmark of rupphash_tpu_torch once.

    python3 phbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's driver (drivers/<driver>.py,
named by its traffic mix) sets up from the seed, warms up every shape it
uses, runs the measured window for S seconds, and the plain reference
then judges what the window produced.  The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
ones, read by metrics/<name>.py from the benchmark's spans and the
profiler's timeline), `device`, optionally `breakdown`, and last `checks`:
each number compared with its limit, also printed on standard error.

The run needs a CUDA card and exits non-zero without a result when there
is none, when a file of the cell is missing, or when the JAX package or
JAX was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fixed_caches(root: Path):
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run there builds; no library loads JAX."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, on_cpu: bool = False, cell=None) -> int:
    """One run.  on_cpu (tests only) skips the look for a card and runs
    the port's plain versions on the CPU; cell replaces the manifest's."""
    args = parse(argv)
    _fixed_caches(ROOT)
    # run as a script, the benchmark's own folder leads sys.path: put the
    # checkout's root there instead, so that its files shadow nothing
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    sys.path.insert(0, str(ROOT))
    from phbench import harness

    try:
        return _run(args, harness, on_cpu, cell)
    except harness.CellError as e:
        print(f"phbench: {e}", file=sys.stderr)
        return 2


def _run(args, harness, on_cpu, cell) -> int:
    cell = cell or harness.Cell(args.workload)
    import torch

    if on_cpu:
        dev = torch.device("cpu")
    else:
        harness.require_cards(cell.chips)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    from rupphash_tpu_torch import device as port_device

    port_device.pin(dev.type)
    from phbench import tracing

    driver = cell.driver()
    readers = cell.readers() if args.trace else {}

    st = driver.setup(cell, args.seed, dev)
    try:
        return _measure(args, harness, tracing, cell, driver, readers, st,
                        dev)
    finally:
        driver.close(st)


def _measure(args, harness, tracing, cell, driver, readers, st, dev) -> int:
    import torch

    cuda = dev.type == "cuda"
    spans = tracing.Spans()
    for reader in readers.values():
        for name, target in getattr(reader, "SPANS", {}).items():
            if name not in spans.records:
                spans.install(name, target)
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts, **tracing.all_threads())
        prof.start()
    with torch.profiler.record_function(tracing.WINDOW):
        driver.window(st, args.seconds)
        if cuda:
            torch.cuda.synchronize(dev)
    if prof is not None:
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    spans.remove()

    device = harness.card_info(dev)
    device["memory_peak_bytes"] = max(setup_peak, window_peak) if cuda else 0
    e2e = driver.end_to_end(st)
    attempted, failed = driver.attempted(st)
    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, counters = driver.check(st, dev)

    bad = harness.forbidden_loaded()
    if bad:
        raise harness.CellError(
            "modules that a run may not load were loaded: " + ", ".join(bad))

    breakdown = None
    if args.trace:
        timeline = tracing.Timeline(prof) if cuda else None
        trace = tracing.Trace(spans, timeline, counters)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if timeline is not None:
            device["busy_s"] = timeline.busy_s
            device["window_s"] = timeline.window_s
            breakdown = {"device_ops": timeline.top_ops(),
                         "idle_gaps": timeline.idle_gaps()}
    else:
        values = dict(e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    if cuda:
        print(f"card: {harness.power_limit()}; peaks "
              f"{harness_peaks()}", file=sys.stderr)
    checks.report()
    print(harness.result_line(
        correct=checks.correct, attempted=attempted, failed=failed,
        metrics=metrics, device=device, checks=checks.as_dict(),
        breakdown=breakdown), flush=True)
    return 0


def harness_peaks() -> str:
    from phbench import roofline

    return ", ".join(f"{k} {v:g}" for k, v in roofline.PEAKS.items())


if __name__ == "__main__":
    sys.exit(main())

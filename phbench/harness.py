"""What every cell shares: the manifest, the files found by name, the card
check, the import guard, the checks' report and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix.  The
configuration's file is the one BENCHMARK.json gives; the traffic mix is
traffic/<traffic>.json, which names its driver (drivers/<driver>.py);
each per-layer metric is metrics/<name>.py, all in the benchmark's
folder under the checkout's root.  A new cell, mix, driver or metric is
therefore new files and new entries, never an edit.

A driver is a module with the hooks run.py and the tests call (DRIVER_HOOKS),
and FAULTS: {name: callable(monkeypatch)} that each break the program
under the driver's timed path, for the tests to see `correct` go false.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = HERE.relative_to(ROOT)      # the benchmark's folder in a checkout

# what every driver defines: set-up, the window, its end-to-end metrics,
# its counts, the release of the program's state, the check and the
# control, the tests' tiny size and the end of the run
DRIVER_HOOKS = ("setup", "window", "end_to_end", "attempted", "release",
                "close", "check", "control", "tiny")

# top-level module names that may not be loaded in a run's process: the
# JAX package and JAX itself (compared whole: rupphash_tpu_torch passes)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rupphash_tpu")


class CellError(RuntimeError):
    """The run cannot produce a result (no card, a missing file, a
    forbidden import); the run exits non-zero and prints no result."""


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"{path} is missing")
    return json.loads(path.read_text())


def with_pending(root: Path = ROOT) -> dict:
    """The manifest with the entries of pending/*.json added: cells that
    were measured and left out of BENCHMARK.json (PERF.md says why), whose
    files stay tested so that a later PR adds them with entries alone."""
    man = manifest(root)
    for path in sorted((root / BENCH / "pending").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            man[key] = man[key] + entries
    return man


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (names may hold dots)."""
    if not path.is_file():
        raise CellError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with everything found by its names
    in the benchmark's folder under `root`."""

    def __init__(self, name: str, man: dict | None = None,
                 root: Path = ROOT):
        man = manifest(root) if man is None else man
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        self.chips = int(self.spec["chips"])
        cfg = {c["name"]: c for c in man["configs"]}[self.spec["config"]]
        self.config = json.loads((root / cfg["file"]).read_text())
        bench = root / BENCH
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.driver_path = bench / "drivers" / f"{self.traffic['driver']}.py"
        self.metrics_dir = bench / "metrics"
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self):
        return load_module(self.driver_path,
                           f"phbench_driver_{self.traffic['driver']}")

    def readers(self) -> dict:
        """{metric name: reader module} for the cell's per-layer metrics."""
        return {m["name"]: load_module(self.metrics_dir / f"{m['name']}.py",
                                       "phbench_metric_" + m["name"]
                                       .replace(".", "_"))
                for m in self.per_layer}


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that a run may not load."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA device visible: the benchmark runs on the "
                        "card only")
    if torch.cuda.device_count() < count:
        raise CellError(f"the cell needs {count} cards, "
                        f"{torch.cuda.device_count()} visible")


def card_info(dev) -> dict:
    """The device block of the result line (peak memory filled later)."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi printed nothing"


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with Python's statistics.quantiles."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def percentile(values, p: float) -> float:
    """The p-th percentile (0-100) by the nearest-rank rule: the smallest
    value with at least p% of the values at or below it.  Values may be
    inf (a failed request)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, -(-len(xs) * p // 100))
    return xs[int(k) - 1]


class Checks:
    """The numbers that decide `correct`, each with its limit: a number
    passes at or under its limit."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float):
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(v <= lim for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def report(self, stream=sys.stderr):
        for n, v, lim in self.items:
            print(f"check {n} = {v!r} limit {lim!r} "
                  f"{'ok' if v <= lim else 'FAILED'}", file=stream)
        stream.flush()


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks    # last: each number compared, with its limit
    return json.dumps(out)

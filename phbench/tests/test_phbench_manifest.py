"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name; the pending cells' entries (pending/*.json) are
held to the same rules, as BENCHMARK.json will hold them, and so is the
stand-in checkout (conftest.build_standin), whose cell of a new driver
is new files and entries alone."""

import json
import re
from pathlib import Path

import pytest

from phbench import harness

MAN = harness.manifest()
PENDING = harness.with_pending()
STANDIN_CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parent / "standin_cell" / "entries.json")
    .read_text())["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(params=["benchmark", "with_pending", "standin"])
def bench(request):
    """(manifest, root of its checkout)."""
    if request.param == "standin":
        return request.getfixturevalue("standin")
    return {"benchmark": MAN, "with_pending": PENDING}[request.param], \
        harness.ROOT


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(bench):
    man, root = bench
    assert set(man) == KEYS["top"]
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= man["run_seconds"] <= 51
    assert man["paths"] == ["phbench"]
    assert all(_line(w) for w in man["command"])
    for c in man["configs"]:
        assert set(c) == KEYS["config"]
        assert c["file"].startswith("phbench/") and _line(c["source"])
        assert len(c["reduced"]) <= 16
    assert {c["name"] for c in man["configs"]} == {
        w["config"] for w in man["workloads"]}
    for w in man["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert _line(w["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in man[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
            assert m["better"] in ("lower", "higher")


def test_names_and_units(bench):
    man, _ = bench
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]


def test_bounds(bench):
    man, _ = bench
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_check_fits_its_time():
    """A full check of 24 cells, 14 runs each and 2 more, fits 12 hours."""
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("where,cell", [
    ("repo", w["name"]) for w in PENDING["workloads"]] + [
    ("standin", name) for name in STANDIN_CELLS],
    ids=[w["name"] for w in PENDING["workloads"]] + STANDIN_CELLS)
def test_cell_files_found_by_name(where, cell, cell_at):
    c = cell_at(where, cell)
    assert c.driver_path.is_file()
    assert c.driver()
    readers = c.readers()
    assert set(readers) == {m["name"] for m in c.per_layer}
    for r in readers.values():
        assert callable(r.read)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer


def test_metric_workloads_report_their_target(bench):
    man, _ = bench
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"] + man["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in cells
    for m in man["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in target.get("workloads", cells), (m["name"], w)


def test_configs_hold_what_they_state(bench):
    """A configuration's file states its cut as its entry does: each key
    it names is one of the file's, and the published value stands under
    `published`, beside `deployment`."""
    man, root = bench
    for c in man["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["deployment"] and cfg["guarantee"] and cfg["assumed"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg, key
            assert key in cfg.get("published", {}), key


LAYER = re.compile(r"^[a-z0-9]+( [a-z0-9]+)*$")


def test_layers_are_named_once(bench):
    """Layer names are lower-case words on one line, and no two differ
    only by case, spaces or _ - . (one layer under two spellings)."""
    man, _ = bench
    layers = {m["layer"] for m in man["per_layer"]}
    for layer in layers:
        assert _line(layer) and LAYER.match(layer), layer
    folded = {re.sub(r"[\s_.-]", "", layer.lower()) for layer in layers}
    assert len(folded) == len(layers)


def test_standin_is_new_files_and_entries_alone(standin):
    """The stand-in checkout holds the benchmark's folder byte for byte,
    files of its own beside it, and BENCHMARK.json with entries added
    only: what a later PR that adds a cell of a new driver brings."""
    man, root = standin
    bench = root / harness.BENCH
    for src in harness.HERE.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            assert (bench / src.relative_to(harness.HERE)).read_bytes() \
                == src.read_bytes(), src
    added = {p.relative_to(bench) for p in bench.rglob("*") if p.is_file()
             and not (harness.HERE / p.relative_to(bench)).exists()}
    assert added and all(p.parts[0] in ("configs", "traffic", "drivers",
                                        "metrics") for p in added)
    ours = {w["name"] for w in MAN["workloads"]}
    man = json.loads(json.dumps(man))      # the session's stays whole
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in ours]
    for key, entries in MAN.items():
        got = man[key][:len(entries)] if isinstance(entries, list) \
            else man[key]
        assert got == entries, key

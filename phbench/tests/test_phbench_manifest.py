"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name; the pending cells' entries (pending/*.json) are
held to the same rules, as BENCHMARK.json will hold them."""

import json
import re

import pytest

from phbench import harness

MAN = harness.manifest()
PENDING = harness.with_pending()
BOTH = pytest.mark.parametrize("man", [MAN, PENDING],
                               ids=["benchmark", "with_pending"])
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


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@BOTH
def test_keys_and_sizes(man):
    assert set(man) == KEYS["top"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
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


@BOTH
def test_names_and_units(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]


@BOTH
def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_check_fits_its_time():
    """A full check of 24 cells, 14 runs each and 2 more, fits 12 hours."""
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in PENDING["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell, PENDING)
    assert c.driver_path.is_file()
    assert c.driver()
    readers = c.readers()
    assert set(readers) == {m["name"] for m in c.per_layer}
    for r in readers.values():
        assert callable(r.read)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer


@BOTH
def test_metric_workloads_report_their_target(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"] + man["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in cells
    for m in man["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in target.get("workloads", cells), (m["name"], w)


@BOTH
def test_configs_hold_what_they_state(man):
    for c in man["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["guarantee"] and cfg["assumed"]


@BOTH
def test_layers_are_named_once(man):
    layers = {m["layer"] for m in man["per_layer"]}
    assert layers <= {"kernels", "edge search", "clustering",
                      "grouping entry", "device", "service request",
                      "corpus query"}

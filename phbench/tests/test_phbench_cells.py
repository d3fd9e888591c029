"""Every cell driven end to end at a tiny size, with the port pinned to
the CPU: correct against the reference as it stands, and not correct
with the timed path broken underneath (each of its driver's FAULTS) or
with the control in the program's place.  The cells are BENCHMARK.json's,
the pending ones' and the stand-in's (conftest.build_standin), whose
driver the benchmark lacks."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from phbench import harness, run
from phbench.tools import control

SEED = 2**31 + 12345

# the pending cells too: their drivers, references and faults stay tested
MAN = harness.with_pending()
STANDIN = Path(__file__).resolve().parent / "standin_cell"
STANDIN_MAN = json.loads((STANDIN / "entries.json").read_text())


def _traffic_driver(folder: Path, traffic: str) -> str:
    return json.loads((folder / "traffic" / f"{traffic}.json")
                      .read_text())["driver"]


def _driver_of(where, name):
    """(driver name, module) of a cell, read where its files lie (the
    stand-in's in its own folder of this checkout, for collection)."""
    if where == "repo":
        c = harness.Cell(name, MAN)
        return c.traffic["driver"], c.driver()
    spec = {w["name"]: w for w in STANDIN_MAN["workloads"]}[name]
    driver = _traffic_driver(STANDIN, spec["traffic"])
    return driver, harness.load_module(
        STANDIN / "drivers" / f"{driver}.py",
        f"phbench_standin_driver_{driver}")


# (where, name): "repo" this checkout, "standin" the stand-in's
CELLS = [("repo", w["name"]) for w in MAN["workloads"]] + [
    ("standin", w["name"]) for w in STANDIN_MAN["workloads"]]
DRIVERS = {c: _driver_of(*c) for c in CELLS}
_FIRSTS = {}
for _c, (_d, _) in DRIVERS.items():
    _FIRSTS.setdefault(_d, _c)
FIRST_OF_EACH_DRIVER = list(_FIRSTS.values())
# every driver a traffic file names, where it lies
TRAFFIC_DRIVERS = sorted({("repo", _traffic_driver(harness.HERE, p.stem))
                          for p in (harness.HERE / "traffic").glob("*.json")}
                         | {("standin", _traffic_driver(STANDIN, p.stem))
                            for p in (STANDIN / "traffic").glob("*.json")})


def _params(cells):
    return pytest.mark.parametrize("where,name", cells,
                                   ids=[n for _, n in cells])


def tiny(cell):
    """The cell at its driver's tiny size."""
    cell.config, cell.traffic = cell.driver().tiny(cell.config, cell.traffic)
    return cell


def run_tiny(cell, capsys, trace=0, seconds=1.5):
    rc = run.main(["--workload", cell.name, "--seed", str(SEED),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  on_cpu=True, cell=cell)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@_params(CELLS)
def test_cell_is_correct(where, name, cell_at, capsys):
    cell = tiny(cell_at(where, name))
    res = run_tiny(cell, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@_params(FIRST_OF_EACH_DRIVER)
def test_traced_run_reads_its_spans(where, name, cell_at, capsys):
    cell = tiny(cell_at(where, name))
    res = run_tiny(cell, capsys, trace=1)
    assert res["correct"] is True
    spans = {m["name"] for m in cell.per_layer
             if m["source"] == "program_span"}
    assert spans and spans <= set(res["metrics"])


@pytest.mark.parametrize("where,name,fault", [
    (*c, f) for c in CELLS for f in DRIVERS[c][1].FAULTS],
    ids=[f"{c[1]}-{f}" for c in CELLS for f in DRIVERS[c][1].FAULTS])
def test_fault_is_not_correct(where, name, fault, cell_at, capsys,
                              monkeypatch):
    """Each fault of the cell's driver, planted under the timed path."""
    cell = tiny(cell_at(where, name))
    cell.driver().FAULTS[fault](monkeypatch)
    res = run_tiny(cell, capsys)
    assert res["correct"] is False


@_params(CELLS)
def test_control_is_not_correct(where, name, cell_at, capsys):
    """The control goes through the cell's own check and comes out not
    correct, as its printed line says."""
    (line,) = control.report(tiny(cell_at(where, name)), [SEED],
                             torch.device("cpu"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and printed == line


@pytest.mark.parametrize("where,driver", TRAFFIC_DRIVERS,
                         ids=[d for _, d in TRAFFIC_DRIVERS])
def test_driver_keeps_the_contract(where, driver, request):
    """Every driver a traffic file names defines the hooks that run.py
    and these tests call and at least one fault, and its tiny size keeps
    the keys of each configuration and mix it cuts, and changes neither."""
    if where == "repo":
        man, root = MAN, harness.ROOT
    else:
        man, root = request.getfixturevalue("standin")
    drv = harness.load_module(root / harness.BENCH / "drivers"
                              / f"{driver}.py", f"phbench_contract_{driver}")
    for hook in harness.DRIVER_HOOKS:
        assert callable(getattr(drv, hook, None)), hook
    assert drv.FAULTS and all(callable(f) for f in drv.FAULTS.values())
    for w in man["workloads"]:
        c = harness.Cell(w["name"], man, root)
        if c.traffic["driver"] != driver:
            continue
        before = json.dumps([c.config, c.traffic])
        small = drv.tiny(c.config, c.traffic)
        assert [set(x) for x in small] == [set(c.config), set(c.traffic)]
        assert json.dumps([c.config, c.traffic]) == before


def test_service_judges_answers_only_where_the_hash_agrees():
    """A hash off by a bit is hashes_off's to count, not answers_off's;
    an answer that differs under an agreeing hash is answers_off's."""
    service = next(m for d, m in DRIVERS.values() if d == "service")
    st = service.State()
    st.cfg = {"similarity": 40, "max_results": 100}
    rng = np.random.default_rng(3)
    st.hashes = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    st.quality = np.full(64, 100, np.int32)
    st.paths = [f"/p/{k}" for k in range(64)]
    variants = np.repeat(st.hashes[5][None], 8, 0)
    hashed = {0: (variants.tobytes(), 90.0), 1: (variants.tobytes(), 90.0)}
    flipped = variants[0].copy()
    flipped[0] ^= 1
    good = {"quality": 90.0, "hash": variants[0].tobytes().hex(),
            "matches": [{"path": "/p/5", "distance": 0, "index": 5}]}
    st.records = [[0, 0, 0, 0, 200, json.dumps(good), 0.0],
                  [1, 0, 0, 0, 200, json.dumps(dict(
                      good, hash=flipped.tobytes().hex(), matches=[])), 0.0]]
    cpu = torch.device("cpu")
    got = service.judge(st, cpu, [0, 1], hashed)
    assert got == {"answers_off": 0.0, "hashes_off": 0.5}
    good["matches"][0]["distance"] = 1
    st.records[0][5] = json.dumps(good)
    assert service.judge(st, cpu, [0, 1], hashed)["answers_off"] == 1.0


@pytest.mark.cuda
def test_sparse_cell_on_the_card(card):
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "phbench/run.py", "--workload",
                        "group_1m_sparse", "--seed", str(SEED),
                        "--seconds", "2", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True

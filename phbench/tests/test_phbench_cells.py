"""Every cell driven end to end at a tiny size, with the port pinned to
the CPU: correct against the reference as it stands, and not correct
with the timed path broken underneath (an answer altered where it is
produced; half of the work left out) or with the control in the
program's place."""

import json

import numpy as np
import pytest
import torch

from phbench import harness, run
from phbench.tools import control

SEED = 2**31 + 12345


# the pending cells too: their drivers, references and faults stay tested
MAN = harness.with_pending()


def tiny(name):
    c = harness.Cell(name, MAN)
    if c.traffic["driver"] == "library":
        c.config = dict(c.config, files=3000)
        c.traffic = dict(c.traffic, patterns=[
            dict(p, clusters=max(4, p["clusters"] // 100))
            for p in c.traffic["patterns"]])
    else:
        c.config = dict(c.config, rows=20000, sources=16)
        kinds = {k: dict(v, count=max(2, v["count"] // 32))
                 for k, v in c.traffic["pool"]["kinds"].items()}
        c.traffic = dict(c.traffic, pool={"kinds": kinds}, rate=5)
    return c


def run_tiny(name, capsys, trace=0, seconds=1.5):
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", str(trace)], on_cpu=True,
                  cell=tiny(name))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


CELLS = [w["name"] for w in MAN["workloads"]]
LIBRARY = [c for c in CELLS
           if harness.Cell(c, MAN).traffic["driver"] == "library"]
SERVICE = [c for c in CELLS
           if harness.Cell(c, MAN).traffic["driver"] == "service"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct(name, capsys):
    res = run_tiny(name, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in harness.Cell(name, MAN).end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS[:1] + SERVICE[:1])
def test_traced_run_reads_its_spans(name, capsys):
    res = run_tiny(name, capsys, trace=1)
    assert res["correct"] is True
    spans = {m["name"] for m in harness.Cell(name, MAN).per_layer
             if m["source"] == "program_span"}
    assert spans and spans <= set(res["metrics"])


def _drop_last_edge(orig):
    def broken(*a, **k):
        ei, ej = orig(*a, **k)
        return ei[:-1], ej[:-1]
    return broken


def _half_the_rows(orig):
    def broken(var_dev, low_conf=None, *a, **k):
        half = var_dev.shape[0] // 2
        return orig(var_dev[:half], np.asarray(low_conf)[:half], *a, **k)
    return broken


@pytest.mark.parametrize("fault", [_drop_last_edge, _half_the_rows])
@pytest.mark.parametrize("name", LIBRARY)
def test_library_fault_is_not_correct(name, fault, capsys, monkeypatch):
    from rupphash_tpu_torch.ops import hamming

    monkeypatch.setattr(hamming, "find_edges_fast_resident",
                        fault(hamming.find_edges_fast_resident))
    res = run_tiny(name, capsys)
    assert res["correct"] is False


def _distance_off_by_one(orig):
    def broken(*a, **k):
        d, i = orig(*a, **k)
        return d + 1, i
    return broken


def _half_the_index(orig):
    def broken(q, base, status, n_total, nbits, k):
        return orig(q, base, status, n_total // 2, nbits, k)
    return broken


@pytest.mark.parametrize("fault", [_distance_off_by_one, _half_the_index])
@pytest.mark.parametrize("name", SERVICE[:1])
def test_service_fault_is_not_correct(name, fault, capsys, monkeypatch):
    from rupphash_tpu_torch import serve

    monkeypatch.setattr(serve, "_query_topk", fault(serve._query_topk))
    res = run_tiny(name, capsys)
    assert res["correct"] is False


@pytest.mark.parametrize("name", LIBRARY + SERVICE[:1])
def test_control_is_not_correct(name, capsys):
    """The control goes through the cell's own check and comes out not
    correct, as its printed line says."""
    (line,) = control.report(tiny(name), [SEED], torch.device("cpu"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and printed == line


def test_service_judges_answers_only_where_the_hash_agrees():
    """A hash off by a bit is hashes_off's to count, not answers_off's;
    an answer that differs under an agreeing hash is answers_off's."""
    service = harness.Cell(SERVICE[0], MAN).driver()
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

"""The port's spans (rupphash_tpu_torch/utils/trace.py): off, on, on the
profiler's clock, exported, and the tree a grouping, a scan and a
service request record."""
import collections
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from phbench import program_spans
from rupphash_tpu_torch import device, serve
from rupphash_tpu_torch.grouping import engine
from rupphash_tpu_torch.ops import pdq_ref
from rupphash_tpu_torch.pipeline import scan
from rupphash_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


@pytest.fixture(autouse=True)
def _empty():
    trace.clear()
    yield
    trace.clear()


def _events(prof, names):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() in names]


def test_off_records_nothing_and_opens_no_range():
    assert not trace._forced, "RUPPHASH_TRACE is set in the test's process"
    a, b = trace.span("t.off.a"), trace.span("t.off.b", n=1)
    assert a is b                     # one shared no-op object
    with a as s:
        s.count("k", 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert trace.spans() == []
    assert _events(prof, {"t.off.a", "t.off.b"}) == []


def test_nested_records_across_two_threads():
    def work(tag):
        with trace.span("t.root", thread=tag) as r:
            with trace.span("t.mid"):
                with trace.span("t.leaf") as leaf:
                    leaf.count("items", 2)
                    leaf.count("items")
            r.count("thread", 0)

    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(rec) == 6 and rec == trace.spans()
    roots = [s for s in rec if s.name == "t.root"]
    assert sorted(s.counts["thread"] for s in roots) == [1, 2]
    assert len({s.thread for s in roots}) == 2
    for root in roots:
        assert root.parent is None and root.root == root.id
        (mid,) = [s for s in rec if s.parent == root.id]
        (leaf,) = [s for s in rec if s.parent == mid.id]
        assert (mid.name, leaf.name) == ("t.mid", "t.leaf")
        assert mid.root == leaf.root == root.id
        assert mid.thread == leaf.thread == root.thread
        assert leaf.counts == {"items": 3}
        assert (root.start_ns <= mid.start_ns <= leaf.start_ns
                <= leaf.end_ns <= mid.end_ns <= root.end_ns)


def test_self_time_is_what_the_children_leave():
    with trace.recording() as rec:
        with trace.span("group"):
            time.sleep(0.002)
            for _ in range(2):
                with trace.span("group.select"):
                    time.sleep(0.01)
    root = next(s for s in rec if s.name == "group")
    kids = sum(s.duration_ns for s in rec if s.parent == root.id)
    self_ns = program_spans.self_ns(root, rec)
    assert self_ns == root.duration_ns - kids
    assert 0.002e9 <= self_ns < root.duration_ns / 2
    # a grouping of the readers: the root and its two children
    (g,) = program_spans.groupings()
    assert [s.name for s in g] == ["group", "group.select", "group.select"]
    assert program_spans.median_ms("group.select") == pytest.approx(
        kids / 1e6)
    assert program_spans.median_ms("edges") is None


def test_buffer_keeps_the_newest(monkeypatch):
    assert trace._records.maxlen == trace.MAX_RECORDS == 1_000_000
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=5))
    with trace.recording() as rec:
        for k in range(8):
            with trace.span("t.k", k=k):
                pass
    assert [s.counts["k"] for s in trace.spans()] == [3, 4, 5, 6, 7]
    assert rec == trace.spans()


def test_spans_sit_on_the_profilers_clock():
    names = {"t.clock.outer", "t.clock.inner"}
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("t.clock.warm"):   # a process's first range
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("t.clock.outer"):
                torch.ones(64).sum()
                with trace.span("t.clock.inner"):
                    time.sleep(0.001)
    spans = [s for s in trace.spans() if s.name in names]
    events = _events(prof, names)
    assert len(spans) == len(events) == 6
    for name in names:
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(e.start_ns() for e in events if e.name() == name)
        ends = sorted(s.end_ns for s in spans if s.name == name)
        their_ends = sorted(e.start_ns() + e.duration_ns() for e in events
                            if e.name() == name)
        for a, b in zip(mine + ends, theirs + their_ends):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_export_writes_one_event_a_record(tmp_path):
    with trace.recording():
        with trace.span("t.exp", files=3) as s:
            s.count("rows", 2)
            with trace.span("t.exp.child"):
                pass
    n = trace.export(tmp_path / "t.json")
    doc = json.loads((tmp_path / "t.json").read_text())
    assert n == len(doc["traceEvents"]) == len(trace.spans()) == 2
    child, parent = doc["traceEvents"]
    assert parent["ph"] == child["ph"] == "X"
    assert parent["args"] == {"files": 3, "rows": 2, "id": parent["args"]["id"],
                              "parent": None, "root": parent["args"]["id"]}
    assert child["args"]["parent"] == parent["args"]["id"]
    assert parent["ts"] <= child["ts"] and parent["dur"] >= child["dur"]
    assert abs(parent["ts"] - time.time_ns() / 1e3) < 60e6


def test_switch_writes_the_file_at_exit(tmp_path):
    out = tmp_path / "trace.json"
    code = ("from rupphash_tpu_torch.utils import trace\n"
            "with trace.span('t.exit', n=1):\n"
            "    pass\n")
    env = dict(os.environ, RUPPHASH_TRACE=str(out))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
    (event,) = json.loads(out.read_text())["traceEvents"]
    assert event["name"] == "t.exit" and event["args"]["n"] == 1


def test_phase_is_a_span_that_keeps_its_timing_line(capsys):
    with trace.recording() as rec:
        with trace.Phase("unit") as p:
            p.add(5)
    (s,) = rec
    assert s.name == "phase.unit" and s.counts == {"items": 5}
    assert "[TIMING] unit: " in capsys.readouterr().err


GROUP_TREE = {"group": {"group.select", "group.resident_rows", "edges",
                        "cluster"},
              "edges": {"edges.count", "edges.extract"},
              "cluster": {"cluster.components", "cluster.stem_merge",
                          "cluster.analyze"}}


def _library(n=3000, seed=7):
    """n records of the library cells' kind, handed over as a cached
    rescan does: each stamped with its row of one device batch; a few
    hundred near copies, so that groups form."""
    rng = np.random.default_rng(seed)
    coeffs = rng.standard_normal((n, 256)).astype(np.float32)
    var = pdq_ref.dihedral_hashes_batch(coeffs)
    src = rng.choice(n // 2, 300, replace=False)
    var[n // 2 + np.arange(300)] = var[src]
    var[n // 2 + np.arange(300), :, 0] ^= 1
    records = [engine.FileRecord(
        path=Path(f"/lib/{k // 100}/img_{k}.jpg"), size=k,
        pdqhash=var[k, 0].tobytes(), pdq_quality=90,
        content_hash=bytes([k % 251, k // 251]), dihedral=var[k],
        device_slot=(0, k)) for k in range(n)]
    return records, [(records, torch.from_numpy(var))]


def test_grouping_records_its_tree_once():
    records, batches = _library()
    with trace.recording() as rec:
        for _ in range(2):
            groups, _, edges = engine.group_files(records,
                                                  device_batches=batches)
    assert len(groups) >= 290 and edges >= 300
    roots = [s for s in rec if s.parent is None]
    assert [s.name for s in roots] == ["group", "group"]
    for root in roots:
        tree = [s for s in rec if s.root == root.id]
        assert len(tree) == 1 + sum(map(len, GROUP_TREE.values()))
        by = {s.name: s for s in tree}
        assert len(by) == len(tree)              # each span once
        for parent, kids in GROUP_TREE.items():
            got = {s.name for s in tree if s.parent == by[parent].id}
            assert got == kids
            for k in kids:
                assert (by[parent].start_ns <= by[k].start_ns
                        <= by[k].end_ns <= by[parent].end_ns)
        assert by["group"].counts == {"files": 3000, "rows": 3000}
        assert by["group.resident_rows"].counts == {"rows": 3000}
        assert by["edges"].counts["edges"] == edges
        assert by["edges.extract"].counts["edges"] == edges
        assert by["edges.count"].counts["hot_rows"] > 0
        assert by["cluster"].counts["groups"] == len(groups)
        assert by["cluster"].counts["members"] == sum(map(len, groups))
        assert program_spans.self_ns(root, tree) < 0.1 * root.duration_ns


def test_fallback_is_counted_on_its_span():
    records, batches = _library(n=2100)
    records[5].device_slot = None
    with trace.recording() as rec:
        engine.group_files(records, device_batches=batches)
    (rr,) = [s for s in rec if s.name == "group.resident_rows"]
    assert rr.counts == {"fallback": 1}


def _png(path, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    Image.fromarray(base).resize((320, 240), Image.BILINEAR).save(path)


def test_scan_records_its_stages_per_batch(tmp_path):
    for k in range(5):
        _png(tmp_path / f"img{k}.png", k)
    _png(tmp_path / "twin.png", 0)
    cfg = scan.ScanConfig(workers=1, batch_size=4)
    with trace.recording() as rec:
        groups, _, records, stats = scan.scan_and_group([tmp_path], cfg)
    assert len(records) == 6 and len(groups) == 1
    names = collections.Counter(s.name for s in rec)
    assert {n for n in names if n.startswith("scan.")} == {
        "scan.walk", "scan.probe", "scan.heavy", "scan.device_dispatch",
        "scan.device_drain", "scan.cache_submit", "scan.cache_flush"}
    # one a batch of 4 and one for the 2 left over, never one a file
    assert names["scan.device_dispatch"] == names["scan.device_drain"] == 2
    phase, group_phase = [s for s in rec if s.parent is None]
    assert phase.name == "phase.scan+hash" and phase.counts == {"items": 6}
    assert group_phase.name == "phase.group"
    assert all(s.root == phase.id for s in rec if s.name.startswith("scan."))
    assert any(s.name == "group" and s.parent == group_phase.id
               for s in rec)


def test_service_request_spans(tmp_path):
    paths = []
    for k in range(3):
        paths.append(tmp_path / f"img{k}.png")
        _png(paths[-1], k)
    records, _ = scan.scan(paths, scan.ScanConfig(workers=1))
    svc = serve.NearDupService(serve.HashIndex.from_records(records))
    httpd, port = svc.serve()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    body = paths[1].read_bytes()
    try:
        with trace.recording() as rec:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/query", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                answer = json.loads(r.read())
            # the handler closes its span after the client has the body
            deadline = time.monotonic() + 10
            while (time.monotonic() < deadline and not any(
                    s.name == "http.request" for s in trace.spans())):
                time.sleep(0.01)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert answer["matches"][0]["path"].endswith("img1.png")
    (req_span,) = [s for s in rec if s.name == "http.request"]
    assert req_span.parent is None and req_span.root == req_span.id
    assert req_span.counts["bytes"] == len(body)
    assert req_span.counts["status"] == 200
    assert 0 <= req_span.counts["wait_us"] < 10_000_000
    kids = [s.name for s in rec if s.parent == req_span.id]
    assert kids == ["request.hash", "index.query", "http.respond"]

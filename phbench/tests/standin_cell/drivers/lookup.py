"""Driver of the stand-in cell that the benchmark's tests build to show
that a cell with a driver of its own is new files and entries alone:
rupphash_tpu_torch.serve.HashIndex.query over a resident index, batches
of queries in a closed loop.  It runs in the tests, on the CPU, and is
no cell of BENCHMARK.json.

Set-up builds the index from the configuration and the seed (random
rows, a share of them low quality) and the mix's queries, each a row of
the index with a number of its bits flipped, cycling over the mix's
range; one batch warms the query.  The window answers the queries a
batch at a time until `seconds` have passed and every query has an
answer; files_per_s is the queries answered a second.  The check
compares the last answer of every query with a brute-force search
(phbench/reference/service.py).
"""

from __future__ import annotations

import io
import time

import numpy as np

from phbench import harness, servegen
from phbench.reference import service as ref_service

# every answer exact
LIMITS = {"answers_off": 0}
QUALITY = 90.0     # a query's quality: above the gate, so the full radius


class State:
    pass


def inputs(cell, seed: int) -> State:
    st = State()
    cfg, tr = cell.config, cell.traffic
    st.similarity = int(cfg["similarity"])
    st.max_results = int(cfg["max_results"])
    st.batch = int(tr["batch"])
    n, nbytes = int(cfg["rows"]), int(cfg["hash_bits"]) // 8
    count = int(tr["queries"])
    if count % st.batch:
        raise harness.CellError("the queries are not whole batches")
    rng = np.random.default_rng([seed, 1])
    st.hashes = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    st.quality = np.where(rng.random(n) < float(cfg["low_share"]), 20,
                          90).astype(np.int32)
    st.paths = [f"/corpus/{i:07d}.jpg" for i in range(n)]
    rows = rng.choice(n, count, replace=False)
    st.quality[rows] = 90
    lo, hi = tr["flips"]
    queries = st.hashes[rows].copy()
    for k, h in enumerate(queries):
        for bit in rng.choice(nbytes * 8, lo + k % (hi - lo + 1),
                              replace=False):
            h[bit // 8] ^= np.uint8(1 << (bit % 8))
    st.queries = np.repeat(queries[:, None], 8, axis=1)
    return st


def setup(cell, seed: int, dev) -> State:
    from rupphash_tpu_torch import serve

    st = inputs(cell, seed)
    st.index = serve.HashIndex.load(io.BytesIO(servegen.index_file_bytes(
        st.hashes, st.quality, st.paths)))
    st.index.query(st.queries[:st.batch], st.similarity, st.max_results)
    return st


def window(st: State, seconds: float) -> None:
    st.answers = [None] * len(st.queries)
    st.done = 0
    t0 = time.perf_counter()
    while True:
        b0 = st.done % len(st.queries)
        st.answers[b0:b0 + st.batch] = st.index.query(
            st.queries[b0:b0 + st.batch], st.similarity, st.max_results)
        st.done += st.batch
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and st.done >= len(st.queries):
            break
    st.window_s = elapsed


def end_to_end(st: State) -> dict:
    return {"files_per_s": st.done / st.window_s}


def attempted(st: State) -> tuple[int, int]:
    return st.done, 0


def release(st: State) -> None:
    st.index = None


def close(st: State) -> None:
    """Nothing of a lookup cell outlives its run."""


def reference(st: State, dev, similarity: int) -> list:
    """The brute-force answers, as HashIndex.query gives them."""
    got = ref_service.answers([(q.tobytes(), QUALITY) for q in st.queries],
                              st.hashes, st.quality, st.paths, similarity,
                              st.max_results, dev)
    return [[(i, p, d) for p, d, i in a] for a in got]


def check(st: State, dev) -> tuple[harness.Checks, dict]:
    want = reference(st, dev, st.similarity)
    checks = harness.Checks()
    checks.add("answers_off", sum(got != w for got, w in zip(st.answers,
                                                            want)),
               LIMITS["answers_off"])
    return checks, {"queries": st.done}


def control(cell, seed: int, dev, fault: str | None = None
            ) -> tuple[harness.Checks, dict]:
    """The reference in the program's place with the radius one short (a
    gate off by one), judged as a run's answers are."""
    if fault is not None:
        raise harness.CellError(f"no fault {fault!r} for a lookup cell")
    st = inputs(cell, seed)
    st.answers = reference(st, dev, st.similarity - 1)
    st.done = len(st.queries)
    return check(st, dev)


def tiny(config: dict, traffic: dict) -> tuple[dict, dict]:
    return dict(config, rows=2000), dict(traffic, queries=64, batch=16)


def _distance_off_by_one(monkeypatch):
    from rupphash_tpu_torch import serve

    orig = serve._query_topk

    def broken(*a, **k):
        d, i = orig(*a, **k)
        return d + 1, i

    monkeypatch.setattr(serve, "_query_topk", broken)


FAULTS = {"distance_off_by_one": _distance_off_by_one}

"""Driver of the library cells: rupphash_tpu_torch.grouping.engine.
group_files on a resident library, in a closed loop.

Set-up builds the library from the configuration, the traffic mix's
cluster patterns and the seed (phbench/libgen.py): one FileRecord a file,
stamped with its device slot, and one uploaded batch of every file's 8
variants, the form pipeline.scan(..., device_sink=...) hands a cached
rescan's records to the grouping.  One warm grouping builds the kernels.
The window groups the library again and again; it closes at the end of
the first grouping that ends after `seconds`, so every grouping in it is
whole.  files_per_s is files x groupings / the window's length.

The check compares the first and the last grouping of the window and one
drawn from the seed, each with its groups, their members' order, their
infos and its edge count, against the plain reference
(phbench/reference/grouping.py) over the same library.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from phbench import harness, libgen
from phbench.reference import grouping as ref_grouping

# every number compared is exact: the limit is 0
LIMITS = {"groups_off": 0, "order_breaks": 0, "edge_count_gap": 0}


class State:
    pass


def inputs(cell, seed: int) -> State:
    """The library from the configuration, the mix and the seed: what the
    program and the reference are both handed."""
    st = State()
    cfg = cell.config
    st.n = int(cfg["files"])
    st.similarity = int(cfg["similarity"])
    st.sort_order = cfg["sort_order"]
    st.seed = seed
    lib = libgen.generate(st.n, cell.traffic["patterns"], seed)
    st.var, st.quality = lib["var"], lib["quality"]
    st.paths = libgen.paths(lib)
    st.content = [libgen.content_hash(c, seed)
                  for c in lib["content"].tolist()]
    return st


def setup(cell, seed: int, dev) -> State:
    from rupphash_tpu_torch.grouping import engine

    st = inputs(cell, seed)
    n, var = st.n, st.var
    rng = np.random.default_rng([seed, 1])
    sizes = rng.integers(1 << 20, 24 << 20, n).tolist()
    stamps = (1.1e9 + rng.random(n) * 6e8).tolist()
    var_dev = torch.from_numpy(var).to(dev)
    st.records = [engine.FileRecord(
        path=Path(p), size=sz, modified=ts, pdqhash=var[i, 0].tobytes(),
        pdq_quality=q, resolution=(4032, 3024), content_hash=ch,
        dihedral=var[i], device_slot=(0, i))
        for i, (p, sz, ts, q, ch) in enumerate(zip(
            st.paths, sizes, stamps, st.quality.tolist(), st.content))]
    st.batches = [(st.records, var_dev)]
    st.engine = engine     # looked up at each call: spans wrap it
    # warm: builds and loads the kernels, allocates the sweep's buffers
    grouped = engine.group_files(st.records, similarity=st.similarity,
                                 sort_order=st.sort_order,
                                 device_batches=st.batches)
    if not grouped[0]:
        raise harness.CellError("the warm grouping found no groups")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def window(st: State, seconds: float) -> None:
    """Groupings until `seconds` have passed.  Three outputs are kept for
    the check, the first, the last and one drawn from the seed (a
    reservoir of one), so that the window holds no more of them than a
    user's run would."""
    rng = np.random.default_rng([st.seed, 6])
    first = drawn = last = None
    count = 0
    st.walls = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        out = st.engine.group_files(
            st.records, similarity=st.similarity, sort_order=st.sort_order,
            device_batches=st.batches)
        st.walls.append(time.perf_counter() - t1)
        count += 1
        if first is None:
            first = out
        elif rng.random() < 1.0 / count:
            drawn = out
        last = out
        out = None
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    st.window_s = elapsed
    st.groupings = count
    st.outputs = [o for o in (first, drawn, last) if o is not None]


def end_to_end(st: State) -> dict:
    print("library: grouping walls (s) " + " ".join(
        f"{w:.3f}" for w in st.walls), file=sys.stderr)
    return {"files_per_s": st.n * st.groupings / st.window_s}


def attempted(st: State) -> tuple[int, int]:
    return st.groupings, 0


def release(st: State) -> None:
    """Drop the program's state before the reference runs."""
    st.outputs = [_canon(out) for out in st.outputs]
    st.batches = st.records = None


def close(st: State) -> None:
    """Nothing of a library cell outlives its run."""


def _canon(out):
    groups, infos, edge_count = out
    return ([(tuple(str(f.path) for f in g), inf.max_dist, inf.status)
             for g, inf in zip(groups, infos)], int(edge_count))


def reference(st: State, dev, control: bool = False):
    """(groups, ei, ej) of the plain reference; control: the reference
    that matches the identity variants alone, where the tool promises a
    pair within the radius on any of the 8."""
    low = st.quality < ref_grouping.MIN_QUALITY
    ei, ej = ref_grouping.edges(st.var, low, st.similarity, dev,
                                identity_only=control)
    return ref_grouping.groups(ei, ej, st.paths, st.content, st.var), ei, ej


def check(st: State, dev) -> tuple[harness.Checks, dict]:
    ref, ei, ej = reference(st, dev)
    worst = dict.fromkeys(LIMITS, 0)
    for groups, edge_count in st.outputs:
        got = ref_grouping.compare(groups, edge_count, ref, len(ei))
        worst = {k: max(worst[k], got[k]) for k in worst}
    checks = harness.Checks()
    for k, lim in LIMITS.items():
        checks.add(k, worst[k], lim)
    counters = {"files": st.n, "variants": int(st.var.shape[1]),
                "nbits": int(st.var.shape[2]) * 8,
                "groupings": st.groupings, "hot_rows": np.unique(ei)}
    return checks, counters


def tiny(config: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at the tests' size on the CPU: 3,000 files, each pattern
    with a hundredth of its clusters and at least 4."""
    return (dict(config, files=3000),
            dict(traffic, patterns=[
                dict(p, clusters=max(4, p["clusters"] // 100))
                for p in traffic["patterns"]]))


def _drop_last_edge(monkeypatch):
    """The edge search loses its last edge."""
    from rupphash_tpu_torch.ops import hamming

    orig = hamming.find_edges_fast_resident

    def broken(*a, **k):
        ei, ej = orig(*a, **k)
        return ei[:-1], ej[:-1]

    monkeypatch.setattr(hamming, "find_edges_fast_resident", broken)


def _half_the_rows(monkeypatch):
    """The edge search sees the first half of the rows alone."""
    from rupphash_tpu_torch.ops import hamming

    orig = hamming.find_edges_fast_resident

    def broken(var_dev, low_conf=None, *a, **k):
        half = var_dev.shape[0] // 2
        return orig(var_dev[:half], np.asarray(low_conf)[:half], *a, **k)

    monkeypatch.setattr(hamming, "find_edges_fast_resident", broken)


# the tests' faults under the timed path, each of which `check` must see
FAULTS = {"drop_last_edge": _drop_last_edge,
          "half_the_rows": _half_the_rows}


def control(cell, seed: int, dev, fault: str | None = None
            ) -> tuple[harness.Checks, dict]:
    """The check of a run in which the plain reference stands in the
    program's place, matching the identity variants alone (the 8-fold
    cheaper search that skips the dihedral variants the tool promises to
    match): its grouping is judged as a run's groupings are.  The library
    cells read no other fault this way."""
    if fault is not None:
        raise harness.CellError(f"no fault {fault!r} for a library cell")
    st = inputs(cell, seed)
    groups, ei, _ = reference(st, dev, control=True)
    st.outputs, st.groupings = [(groups, len(ei))], 1
    return check(st, dev)

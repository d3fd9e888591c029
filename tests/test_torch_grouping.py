"""The port's grouping engine vs rupphash_tpu.grouping.engine on the same
records: groups, order, infos and edge count."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rupphash_tpu.grouping import engine as ref_engine
from rupphash_tpu.ops import pdq_ref
from rupphash_tpu_torch import device
from rupphash_tpu_torch.grouping import engine
from rupphash_tpu_torch.utils import trace


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _flip(h, positions):
    o = h.copy()
    for p in positions:
        o[p // 8] ^= 1 << (p % 8)
    return o


def _corpus():
    """Field tuples for ~60 records: near-duplicate chains, a dihedral
    twin (found only through the variants), bit-identical copies,
    low-quality exact and near pairs, stem-mates, unhashed files."""
    rng = np.random.default_rng(21)
    coeffs = rng.standard_normal((30, 256)).astype(np.float32)
    dihedral = pdq_ref.dihedral_hashes_batch(coeffs)      # (30, 8, 32)
    rows = []

    def add(name, k, h=None, quality=90, content=None, size=1000, mtime=0.0,
            variants=None):
        # an edited hash has no variant set (the engines repeat it), so
        # slot 0 always holds the record's own hash
        if h is None:
            h, variants = dihedral[k, 0], dihedral[k]
        rows.append(dict(name=name, pdq=h.tobytes(), dihedral=variants,
                         quality=quality,
                         content=content or name.encode(), size=size,
                         modified=mtime))

    for k in range(30):
        add(f"/p/img_{k}.jpg", k, size=1000 + k, mtime=float(k))
    add("/p/near_a.jpg", 0, _flip(dihedral[0, 0], range(9)))
    add("/p/near_b.jpg", 0, _flip(dihedral[0, 0], range(20, 50)))
    add("/q/rot.jpg", 1, dihedral[1, 1],              # rot90 twin of img_1
        variants=np.roll(dihedral[1], -1, axis=0))
    add("/q/copy_2.jpg", 2, content=b"/p/img_2.jpg")  # bit-identical bytes
    add("/q/copy_2b.png", 2, content=b"/p/img_2.jpg")
    add("/q/lowA.jpg", 3, quality=10)
    add("/q/lowB.jpg", 3, quality=10)                 # exact, both low
    add("/q/lowC.jpg", 4, _flip(dihedral[4, 0], [0, 1]), quality=10)
    add("/r/img_5.nef", 5, _flip(dihedral[5, 0], range(35)))  # stem-mate
    add("/r/img_5.jpg", 6, _flip(dihedral[6, 0], range(3)))
    add("/r/10.jpg", 7, _flip(dihedral[7, 0], [1]), size=5)
    add("/r/9.jpg", 7, _flip(dihedral[7, 0], [2]), size=50)
    rows.append(dict(name="/r/broken.jpg", pdq=None, dihedral=None,
                     quality=None, content=b"broken", size=1, modified=0.0))
    return rows


def _records(mod, rows):
    return [mod.FileRecord(path=Path(r["name"]), pdqhash=r["pdq"],
                           pdq_quality=r["quality"], dihedral=r["dihedral"],
                           content_hash=r["content"], size=r["size"],
                           modified=r["modified"]) for r in rows]


def _summary(groups, infos, edges):
    return ([[str(f.path) for f in g] for g in groups],
            [(i.max_dist, i.status) for i in infos], edges)


@pytest.mark.parametrize("sort_order", ["name", "size-desc", "name-natural"])
@pytest.mark.parametrize("use_device", [False, True])
def test_groups_match_reference(use_device, sort_order):
    rows = _corpus()
    want = _summary(*ref_engine.group_files(_records(ref_engine, rows),
                                            similarity=40,
                                            sort_order=sort_order,
                                            use_device=False))
    got = _summary(*engine.group_files(_records(engine, rows),
                                       similarity=40, sort_order=sort_order,
                                       use_device=use_device))
    assert got == want
    paths, _, edges = got
    assert edges > 0
    assert any("/q/rot.jpg" in g for g in paths)
    assert not any("/q/lowC.jpg" in g for g in paths)


def _device_rows(recs):
    return torch.from_numpy(np.stack([
        f.dihedral if f.dihedral is not None
        else np.repeat(np.frombuffer(f.pdqhash, np.uint8)[None], 8, axis=0)
        for f in recs]))


def test_device_resident_route_matches_host_route():
    rows = _corpus()
    files = _records(engine, rows)
    hashed = [f for f in files if f.pdqhash is not None]
    batches = [(hashed[:25], _device_rows(hashed[:25])),
               (hashed[25:], _device_rows(hashed[25:]))]
    for b, (recs, _) in enumerate(batches):
        for k, f in enumerate(recs):
            f.device_slot = (b, k)
    before = trace.counters().get("GROUP-RESIDENT-FALLBACK", 0)
    got = _summary(*engine.group_files(files, use_device=True,
                                       device_batches=batches))
    assert trace.counters().get("GROUP-RESIDENT-FALLBACK", 0) == before
    want = _summary(*ref_engine.group_files(_records(ref_engine, rows),
                                            use_device=False))
    assert got == want


def test_missing_device_slot_falls_back_loudly(capsys):
    rows = _corpus()
    files = _records(engine, rows)
    hashed = [f for f in files if f.pdqhash is not None]
    batches = [(hashed, _device_rows(hashed))]
    for k, f in enumerate(hashed[1:]):
        f.device_slot = (0, k + 1)
    before = trace.counters().get("GROUP-RESIDENT-FALLBACK", 0)
    got = _summary(*engine.group_files(files, use_device=True,
                                       device_batches=batches))
    assert trace.counters()["GROUP-RESIDENT-FALLBACK"] == before + 1
    assert "device-resident path unavailable" in capsys.readouterr().err
    want = _summary(*ref_engine.group_files(_records(ref_engine, rows),
                                            use_device=False))
    assert got == want


def test_host_semantics_match_reference():
    keys = ["a10.jpg", "a9.jpg", "1.jpg", "b.jpg", "A2.png", "a02.jpg"]
    assert (sorted(keys, key=engine.natural_key)
            == sorted(keys, key=ref_engine.natural_key))
    uf = engine.UnionFind(6)
    for a, b in [(0, 1), (1, 2), (4, 5)]:
        uf.union(a, b)
    assert sorted(map(sorted, uf.components())) == [[0, 1, 2], [4, 5]]
    files = _records(engine, _corpus())
    groups = [[30, 5], [39, 38], [1, 2]]
    assert (engine.merge_groups_by_stem(groups, files)
            == ref_engine.merge_groups_by_stem(
                groups, _records(ref_engine, _corpus())))
    assert engine.group_files([]) == ([], [], 0)

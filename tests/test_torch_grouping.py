"""The port's grouping engine vs rupphash_tpu.grouping.engine on the same
records: groups, order, infos and edge count."""
import random
from collections import Counter
from pathlib import Path, PurePosixPath

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
            variants=None, **extra):
        # an edited hash has no variant set (the engines repeat it), so
        # slot 0 always holds the record's own hash
        if h is None:
            h, variants = dihedral[k, 0], dihedral[k]
        rows.append(dict(name=name, pdq=h.tobytes(), dihedral=variants,
                         quality=quality,
                         content=content or name.encode(), size=size,
                         modified=mtime, **extra))

    for k in range(30):
        # EXIF dates on some, GPS on others: the exif-date and location
        # orders have something to order
        extra = {}
        if k % 2 == 0:
            extra["exif"] = 5000 - 7 * k
        if k % 3 == 0:
            extra["gps"] = (40.0 + (k * 7 % 11) * 0.3, -100.0 + k * 0.2)
        add(f"/p/img_{k}.jpg", k, size=1000 + k, mtime=float(k), **extra)
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


def _edge_corpus():
    """Field tuples for the clustering tail's corner cases: members and
    whole groups without a variant set, empty content hashes, pixel
    hashes on some exact copies, groups that merge by stem across
    components (in a chain of three, at the root, under "//", relative),
    and the names pathlib treats apart: ".hidden", "name.", "a.tar.gz",
    RAW suffixes in upper, lower and mixed case."""
    rng = np.random.default_rng(33)
    coeffs = rng.standard_normal((16, 256)).astype(np.float32)
    dihedral = pdq_ref.dihedral_hashes_batch(coeffs)      # (16, 8, 32)
    rows = []

    def add(name, k, flips=(), variants=True, content=None, **extra):
        h = _flip(dihedral[k, 0], flips)
        rows.append(dict(name=name, pdq=h.tobytes(),
                         dihedral=(dihedral[k] if variants and not flips
                                   else None),
                         quality=90,
                         content=name.encode() if content is None else content,
                         **{"size": len(rows) % 4,
                            "modified": float(len(rows) % 3), **extra}))

    # no variant set anywhere: plain Hamming from the first hash
    add("rel.jpg", 0, variants=False)
    add("rel.CR2", 0, range(5))
    add("sub/rel.jpg", 0, range(10, 22))
    # the first members lack a variant set: the pivot is a later one
    add("/m/a.jpg", 1, range(3))
    add("/m/b.NEF", 1, exif=40)
    add("/m/b.jpg", 1, range(30, 36), exif=10)
    add("/m/c.dng", 1, range(7))
    # exact copies, pixel hashes on some, empty content hashes
    add("/c/x1.jpg", 2, content=b"same", pixel_hash=b"\x02")
    add("/c/x2.jpg", 2, content=b"same", pixel_hash=b"\x01")
    add("/c/x3.png", 2, content=b"same")
    add("/c/e1.jpg", 2, range(2), content=b"")
    add("/c/e2.jpg", 2, range(4), content=b"")
    # stem twins in three components: a chain that merges by stem
    add("/s/x.jpg", 3)
    add("/s/w.jpg", 3, range(8))
    add("/s/x.NEF", 4)
    add("/s/y.jpg", 4, range(9))
    add("/s/y.Dng", 5)
    add("/s/z.jpg", 5, range(1))
    # at the root and under "//": the parents "/" and "//" differ
    add("/top.jpg", 6)
    add("/top2.jpg", 6, range(2))
    add("/top.nef", 7)
    add("/top3.jpg", 7, range(3))
    add("//dbl.jpg", 8)
    add("//dbl2.jpg", 8, range(4))
    add("/dbl.raf", 9)
    add("/dbl2.raf", 9, range(2))
    # pathlib's stems: ".hidden" has none, "name." keeps its dot,
    # "a.tar.gz" and "a.tar.NEF" share "a.tar", ".hidden.nef" has ".hidden"
    add("/h/.hidden", 10)
    add("/h/name.", 10, range(5))
    add("/h/a.tar.gz", 10, range(6))
    add("/h/.hidden.nef", 11)
    add("/h/a.tar.NEF", 11, range(2))
    add("/h/name", 11, range(3))
    # one name in three directories, equal in size and date: only the
    # members' order before the sort tells them apart
    add("/t/a/dup.jpg", 15, size=7, modified=1.0)
    add("/t/b/dup.jpg", 15, range(2), size=7, modified=1.0)
    add("/t/c/dup.jpg", 15, range(4), size=7, modified=1.0)
    # one stem, the names in another order than the rows
    add("/t/d/dup.png", 15, range(5), size=7, modified=1.0)
    add("/t/e/dup.gif", 15, range(6), size=7, modified=1.0)
    # exact copies of one name: the pixel hash orders them
    add("/t/f/dup.jpg", 15, range(8), content=b"twin", pixel_hash=b"\x09")
    add("/t/g/dup.jpg", 15, range(8), content=b"twin", pixel_hash=b"\x03")
    add("/t/h/dup.png", 15, range(9), content=b"pair")
    add("/t/i/dup.bmp", 15, range(9), content=b"pair")
    # no content hash on either: not identical
    add("/e/a.jpg", 13, range(1), content=b"")
    add("/e/b.jpg", 13, range(2), content=b"")
    # every member one content hash: all-identical
    add("/i/one.jpg", 12, content=b"all")
    add("/i/two.jpg", 12, content=b"all")
    # no group holds these two
    add("/n/lone.jpg", 14)
    add("/n/lone.nef", 0, range(100))
    return rows


_CORPORA = {"base": _corpus, "edge": _edge_corpus}
_ORDERS = ["name", "name-desc", "name-natural", "name-natural-desc", "date",
           "date-desc", "size", "size-desc", "exif-date", "exif-date-desc",
           "random", "location", "unknown-order"]


def _records(mod, rows):
    return [mod.FileRecord(path=Path(r["name"]), pdqhash=r["pdq"],
                           pdq_quality=r["quality"], dihedral=r["dihedral"],
                           content_hash=r["content"], size=r["size"],
                           modified=r["modified"],
                           pixel_hash=r.get("pixel_hash"),
                           exif_timestamp=r.get("exif"),
                           gps_pos=r.get("gps")) for r in rows]


def _summary(groups, infos, edges):
    return ([[str(f.path) for f in g] for g in groups],
            [(i.max_dist, i.status) for i in infos], edges)


@pytest.mark.parametrize("corpus", sorted(_CORPORA))
@pytest.mark.parametrize("sort_order", _ORDERS)
@pytest.mark.parametrize("use_device", [False, True])
def test_groups_match_reference(use_device, sort_order, corpus):
    rows = _CORPORA[corpus]()
    random.seed(14)
    want = _summary(*ref_engine.group_files(_records(ref_engine, rows),
                                            similarity=40,
                                            sort_order=sort_order,
                                            use_device=False))
    random.seed(14)
    got = _summary(*engine.group_files(_records(engine, rows),
                                       similarity=40, sort_order=sort_order,
                                       use_device=use_device))
    if sort_order == "random":
        # the groups' members as multisets; with one seed each engine
        # shuffles the same groups the same way, so the rest holds too
        assert (Counter(tuple(sorted(g)) for g in got[0])
                == Counter(tuple(sorted(g)) for g in want[0]))
    assert got == want
    paths, _, edges = got
    assert edges > 0
    if corpus == "base":
        assert any("/q/rot.jpg" in g for g in paths)
        assert not any("/q/lowC.jpg" in g for g in paths)
    else:
        # the chain of stem twins and the root's twins each merged
        assert any({"/s/x.jpg", "/s/y.Dng", "/s/z.jpg"} <= set(g)
                   for g in paths)
        assert any({"/top.jpg", "/top.nef"} <= set(g) for g in paths)
        assert not any({"//dbl.jpg", "/dbl.raf"} <= set(g) for g in paths)
        assert not any("/n/lone.jpg" in g for g in paths)


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


_EDGE_PATHS = ["/a/b/IMG_1.JPG", "/a/b/IMG_1.nef", "/top.jpg", "/top",
               "//dbl.Cr2", "/", "//", ".", "", "rel.jpg", "rel", "sub/x.y",
               "./sub//x.ARW/", "/h/.hidden", "/h/.hidden.nef", "/h/name.",
               "/h/name..", "/h/..", "/h/...", "/h/..a", "/h/a.tar.gz",
               "/h/a.tar.NEF", "/d.ir/file", "/d.ir/file.", "/u/ünï.Dng",
               "/u/\udcff.jpg", "a/.b.", "../up.raf"]


def test_path_columns_follow_pathlib():
    paths = [PurePosixPath(p) for p in _EDGE_PATHS]
    names, stems, exts, raw, ids = engine._path_columns(list(map(str, paths)))
    assert names == [p.name for p in paths]
    assert stems == [p.stem for p in paths]
    assert exts == [p.suffix[1:] for p in paths]
    assert raw.tolist() == [p.suffix.lower().lstrip(".") in engine.RAW_EXTS
                            for p in paths]
    keys = [(str(p.parent), p.stem) for p in paths]
    assert len(set(keys)) < len(keys)       # some share a key
    for a in range(len(paths)):
        for b in range(len(paths)):
            assert (ids[a] == ids[b]) == (keys[a] == keys[b]), (a, b)


def _loop_components(roots, min_size):
    """The components from the roots by a plain loop over the sorted
    roots, as the engine built them before its array passes."""
    order = sorted(range(len(roots)), key=lambda i: roots[i])
    groups, run = [], []
    for i in order:
        if run and roots[run[-1]] != roots[i]:
            if len(run) >= min_size:
                groups.append(run)
            run = []
        run.append(i)
    if len(run) >= min_size:
        groups.append(run)
    return groups


@pytest.mark.parametrize("min_size", [1, 2, 3])
@pytest.mark.parametrize("case", ["empty", "one", "singletons", "few",
                                  "many"])
def test_components_from_roots_match_a_loop(case, min_size):
    rng = np.random.default_rng(len(case) * 10 + min_size)
    roots = {"empty": np.zeros(0, np.int64),
             "one": np.array([4]),
             "singletons": rng.permutation(50),
             "few": rng.integers(0, 5, 40),
             "many": rng.integers(0, 300, 1000)}[case]
    assert (engine._components_from_roots(roots, min_size)
            == _loop_components(roots.tolist(), min_size))


class _Clash(bytes):
    """A content hash whose hash() is every other's."""

    def __hash__(self):
        return 7


@pytest.mark.parametrize("corpus", sorted(_CORPORA))
@pytest.mark.parametrize("sort_order", ["name", "size-desc", "name-natural",
                                        "exif-date-desc", "location"])
def test_analyze_group_is_the_batched_call(corpus, sort_order):
    """analyze_group on one group equals the batched pass over all of
    them and the JAX package's analyze_group, on groups handed over in a
    shuffled order, with a member lacking its hash, a group that lacks
    every hash and one whose content hashes collide in hash()."""
    groups, _, _ = engine.group_files(_records(engine, _CORPORA[corpus]()))
    groups = [g[::-1] for g in groups]
    groups[0].append(engine.FileRecord(path=Path("/p/unhashed.jpg")))
    groups.append([engine.FileRecord(path=Path(f"/p/unhashed_{k}.jpg"),
                                     content_hash=b"u") for k in range(2)])
    h = groups[1][0].pdqhash
    groups.append([engine.FileRecord(path=Path(f"/p/clash_{k}.jpg"),
                                     pdqhash=h, content_hash=_Clash(c))
                   for k, c in enumerate([b"x", b"y", b"z", b"y"])])
    rng = random.Random(3)
    for g in groups:
        rng.shuffle(g)
    one = [list(g) for g in groups]
    infos = [engine.analyze_group(g, sort_order) for g in one]
    offsets = np.cumsum([0] + [len(g) for g in groups])
    batch, max_dist, status = engine._analyze(
        engine._Members([f for g in groups for f in g]), offsets, sort_order)
    assert batch == one
    assert [engine.GroupInfo(d, engine._STATUS[s]) for d, s in zip(
        max_dist.tolist(), status.tolist())] == infos
    ref = [[ref_engine.FileRecord(**{k: getattr(f, k) for k in (
        "path", "pdqhash", "dihedral", "content_hash", "pixel_hash", "size",
        "modified", "exif_timestamp", "gps_pos")}) for f in g]
           for g in groups]
    ref_infos = [ref_engine.analyze_group(g, sort_order) for g in ref]
    assert ([[str(f.path) for f in g] for g in one]
            == [[str(f.path) for f in g] for g in ref])
    assert ([(i.max_dist, i.status) for i in infos]
            == [(i.max_dist, i.status) for i in ref_infos])
    assert engine.analyze_group([], sort_order) == engine.GroupInfo()


def test_analyze_span_counts_rows_and_plain_pivots():
    files = _records(engine, _edge_corpus())
    with trace.recording() as rec:
        groups, _, _ = engine.group_files(files)
    by = {s.name: s for s in rec}
    plain = sum(all(f.dihedral is None for f in g) for g in groups)
    assert plain >= 1
    assert by["cluster.analyze"].counts == {
        "rows": by["cluster"].counts["members"], "plain_pivot": plain}
    assert by["cluster"].counts["members"] == sum(map(len, groups))

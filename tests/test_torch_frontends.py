"""The port's copies of the frontends' host modules against the JAX
package's: session state (`state`), view mode (`pipeline/view`), the
curses browser's logic (`tui`), the search language (`search`,
`search_index`), OKLab analysis (`pipeline/palette`), HDR decoding and
dither (`pipeline/hdr` with its blue-noise asset) and animated-image
probing (`pipeline/animated`).

Each case runs for both packages: it takes one package as its own, runs
the scenario there and checks what the JAX package's own tests check,
then runs the same scenario on the other package over a copy of the
same inputs and requires the same result.  The tolerance is exact: the
code is copied, so every value, status string and file left behind
must be equal.  Inputs are made from numpy seeds."""
import io
import math
import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu_torch import device
from torch_mirror import PKGS, load, plain, same

@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


@pytest.fixture(params=PKGS)
def m(request):
    return load(request.param)


# --- state ------------------------------------------------------------------

def _groups(m, root, n_groups=3, per_group=3):
    groups, infos = [], []
    k = 0
    for g in range(n_groups):
        members = []
        for f in range(per_group):
            p = root / f"g{g}_f{f}.png"
            p.write_bytes(b"data" + bytes([k]))
            members.append(m.engine.FileRecord(
                path=p, size=10 + k, modified=float(k),
                content_hash=bytes([k]) * 32, unique_file_id=k))
            k += 1
        groups.append(members)
        infos.append(m.engine.GroupInfo(max_dist=g * 5, status="none"))
    return groups, infos


def _names(st):
    return [[f.path.name for f in g] for g in st.groups]


def _left(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_state_navigation(m, tmp_path):
    def run(m, root):
        st = m.state.AppState(*_groups(m, root))
        seen = [(st.cursor_group, st.cursor_file)]
        for name in ("NEXT_ITEM", "NEXT_GROUP", "END", "HOME", "PAGE_DOWN"):
            st.handle_input(getattr(m.state.Intent, name))
            seen.append((st.cursor_group, st.cursor_file, st.flat_cursor))
        return seen, len(st.rows)

    seen, n_rows = same(run, m, tmp_path)
    assert seen[:5] == [(0, 0), (0, 1, 1), (1, 0, 3), (2, 2, 8), (0, 0, 0)]
    assert seen[5][2] == n_rows - 1            # clamped


def test_state_mark_and_delete_with_confirm(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        st = m.state.AppState(*_groups(m, root))
        st.handle_input(I.TOGGLE_MARK)
        trail = [len(st.marked)]
        st.handle_input(I.CONFIRM_DELETE)
        trail.append(st.pending_confirm)
        st.handle_input(I.CANCEL)
        trail.append(st.pending_confirm)
        victim = next(iter(st.marked)).name
        st.handle_input(I.CONFIRM_DELETE)
        st.handle_input(I.EXECUTE_DELETE)
        return trail, victim, st.status, _names(st), _left(root)

    trail, victim, status, names, left = same(run, m, tmp_path)
    assert trail == [1, "delete", None]
    assert victim not in left and "deleted 1" in status and len(names) == 3


def test_state_delete_below_two_drops_group(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        st = m.state.AppState(*_groups(m, root))
        st.handle_input(I.MARK_GROUP)
        st.handle_input(I.EXECUTE_DELETE)       # arms the gate only
        armed = (st.pending_confirm, len(st.groups))
        st.handle_input(I.EXECUTE_DELETE)
        return armed, _names(st), _left(root)

    armed, names, left = same(run, m, tmp_path)
    assert armed == ("delete", 3) and len(names) == 2 and len(left) == 6


def test_state_delete_immediate_is_confirm_gated(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        st = m.state.AppState(*_groups(m, root))
        victim = st.current().path
        trail = []
        for name in ("DELETE_IMMEDIATE", "CANCEL", "DELETE_IMMEDIATE",
                     "EXECUTE_DELETE"):
            st.handle_input(getattr(I, name))
            trail.append((st.pending_confirm, victim.exists()))
        return trail

    assert same(run, m, tmp_path) == [("delete-one", True), (None, True),
                                      ("delete-one", True), (None, False)]


def test_state_move_marked_is_confirm_gated(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        target = root / "dst"
        target.mkdir()
        st = m.state.AppState(*_groups(m, root))
        st.move_target = target
        st.handle_input(I.TOGGLE_MARK)
        victim = next(iter(st.marked)).name
        st.handle_input(I.MOVE_MARKED)
        armed = st.pending_confirm
        st.handle_input(I.MOVE_MARKED)          # confirm
        return armed, victim, st.status, _left(root)

    armed, victim, status, left = same(run, m, tmp_path)
    assert armed == "move" and victim not in left
    assert f"dst/{victim}" in left


def test_state_resort_updates_every_group_info(m, tmp_path):
    def run(m, root):
        groups, _ = _groups(m, root, n_groups=3, per_group=2)
        infos = [m.engine.GroupInfo(max_dist=0, status="none"),
                 m.engine.GroupInfo(max_dist=0, status="none"),
                 m.engine.GroupInfo(max_dist=7, status="none")]
        st = m.state.AppState(groups, infos)
        st.handle_input(m.state.Intent.CHANGE_SORT, "size")
        fresh = [m.engine.analyze_group(g, "size") for g in st.groups]
        return st.infos, fresh, st.infos[0] is st.infos[1], _names(st)

    infos, fresh, aliased, _ = same(run, m, tmp_path)
    assert plain(infos) == plain(fresh) and not aliased


def test_state_search_rename_and_distance_bands(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        st = m.state.AppState(*_groups(m, root))
        out = []
        st.handle_input(I.SUBMIT_SEARCH, "g2_f1")
        out.append(st.current().path.name)
        st.handle_input(I.NEXT_SEARCH)          # wraps to the one match
        out.append(st.current().path.name)
        st.handle_input(I.SUBMIT_SEARCH, "f[02]$|g0_f0")
        out.append(st.status)
        st.handle_input(I.HOME)
        st.handle_input(I.NEXT_GROUP_BY_DIST)
        out.append(st.cursor_group)
        st.handle_input(I.PREV_GROUP_BY_DIST)
        out.append(st.cursor_group)
        st.handle_input(I.SUBMIT_RENAME, "renamed.png")
        out.append(st.current().path.name)
        st.handle_input(I.NEXT_ITEM)
        st.handle_input(I.SUBMIT_RENAME, "renamed.png")   # collision
        out.append(st.status)
        return out, _left(root)

    out, left = same(run, m, tmp_path)
    assert out[:6] == ["g2_f1.png", "g2_f1.png", "", 1, 0, "renamed.png"]
    assert "exists" in out[6] and "renamed.png" in left


def test_state_transforms_quit_and_move_target(m, tmp_path):
    def run(m, root):
        I = m.state.Intent
        st = m.state.AppState(*_groups(m, root))
        for name in ("ROTATE_CW", "ROTATE_CW", "FLIP_H"):
            st.handle_input(getattr(I, name))
        uid = st.current().unique_file_id
        t = st.transforms[uid]
        turned = (t.quarter_turns, t.flip_h)
        st.handle_input(I.RESET_TRANSFORM)
        reset = uid in st.transforms
        st.handle_input(I.SET_MOVE_TARGET, str(root))
        good = st.move_target == root
        st.handle_input(I.SET_MOVE_TARGET, "/definitely/not/a/dir")
        kept = (st.move_target == root, "not a directory" in st.status)
        st.handle_input(I.QUIT)
        return turned, reset, good, kept, st.quit

    assert same(run, m, tmp_path) == ((2, True), False, True, (True, True),
                                      True)


def test_state_ignore_persists_to_store(m, tmp_path):
    def run(m, root):
        store = m.store.CacheStore(root / "c.db", master_key=b"\x09" * 32,
                                   start_writer=False)
        (root / "p").mkdir()
        groups, infos = _groups(m, root / "p")
        store.register_duplicate_groups(
            [[(f.content_hash, None) for f in g] for g in groups])
        st = m.state.AppState(groups, infos, store=store)
        st.handle_input(m.state.Intent.IGNORE_GROUP)
        armed = st.pending_confirm
        st.handle_input(m.state.Intent.IGNORE_GROUP)      # confirm
        try:
            return (armed, st.status, _names(st),
                    [store.is_ignored(bytes([k]) * 32) for k in range(9)])
        finally:
            store.close()

    armed, status, names, ignored = same(run, m, tmp_path)
    assert armed == "ignore-group" and "ignored 3" in status
    assert len(names) == 2 and ignored == [True] * 3 + [False] * 6


def test_state_marks_follow_drops_renames_and_failures(m, tmp_path,
                                                      monkeypatch):
    def run(m, root):
        I = m.state.Intent
        groups, infos = _groups(m, root)
        st = m.state.AppState(groups, infos)
        a, b = groups[0][0].path, groups[0][1].path
        # a failed delete keeps the file listed and marked
        real = m.fileops.delete_file

        def flaky(path, use_trash):
            if path == a:
                raise OSError("simulated EACCES")
            return real(path, use_trash)

        with monkeypatch.context() as mp:
            mp.setattr(f"{m.pkg}.state.fileops.delete_file", flaky)
            st.handle_input(I.TOGGLE_MARK)
            st.handle_input(I.TOGGLE_MARK)
            st.handle_input(I.CONFIRM_DELETE)
            st.handle_input(I.EXECUTE_DELETE)
        failed = (a in st.marked, "1 failed" in st.status, _names(st))
        # a dropped (ignored) file loses its mark and survives a later
        # delete of the marked files
        st._drop_paths({a})
        st.cursor_group, st.cursor_file = 0, 0
        st.handle_input(I.TOGGLE_MARK)           # and the cursor moves on
        st.cursor_group, st.cursor_file = 0, 0
        renamed_from = st.current().path.name
        st._rename_current("renamed.png")
        marks = sorted(p.name for p in st.marked)
        empty = m.state.AppState([], [])
        empty.handle_input(I.MARK_GROUP)
        return failed, renamed_from, marks, a.exists(), len(empty.marked)

    failed, _, marks, a_left, n_empty = same(run, m, tmp_path)
    assert failed[:2] == (True, True) and "g0_f1.png" not in failed[2][0]
    assert a_left and marks == ["renamed.png"] and n_empty == 0


# --- view mode --------------------------------------------------------------

def _viewdir(root):
    d = root / "v"
    (d / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3),
                                     dtype=np.uint8)).save(d / f"img{i}.png")
    Image.fromarray(np.zeros((20, 20, 3), dtype=np.uint8)).save(
        d / "sub" / "nested.png")
    return d


def _rec_view(recs, root):
    return [(str(r.path.relative_to(root)), r.size, r.resolution)
            for r in recs]


def test_view_listing_batches_and_sort(m, tmp_path):
    def run(m, root):
        d = _viewdir(root)
        flat, subdirs = m.view.list_view([d], recursive=False)
        deep, _ = m.view.list_view([d], recursive=True)
        desc, _ = m.view.list_view([d], sort="name-desc")
        batches = [len(b) for b in m.view.stream_batches(flat, batch=2)]
        return (_rec_view(flat, root), [s.name for s in subdirs],
                _rec_view(deep, root), _rec_view(desc, root), batches)

    flat, subdirs, deep, desc, batches = same(run, m, tmp_path)
    assert len(flat) == 5 and subdirs == ["sub"] and len(deep) == 6
    assert [n for n, _, _ in desc] == sorted((n for n, _, _ in desc),
                                             reverse=True)
    assert batches == [2, 2, 1]


def test_view_enrichment_fills_features_and_cache(m, tmp_path):
    def run(m, root):
        d = _viewdir(root)
        store = m.store.CacheStore(root / "c.db", master_key=b"\x0a" * 32)
        try:
            recs, _ = m.view.list_view([d], store=store)
            before = [r.resolution for r in recs]
            enr = m.view.Enrichment(recs, store=store, workers=2)
            enr.start()
            enr.join(timeout=60)
            got = []
            while not enr.results.empty():
                got.append(enr.results.get())
            after = _rec_view(recs, root)
            store.flush()
            recs2, _ = m.view.list_view([d], store=store)
            again = m.view.Enrichment(recs2, store=store).records
            return before, len(got), after, _rec_view(recs2, root), again
        finally:
            store.close()

    before, n_got, after, cached, again = same(run, m, tmp_path)
    assert before == [None] * 5 and n_got == 5
    assert [res for _, _, res in after] == [(60, 40)] * 5
    assert cached == after and again == []


# --- the TUI's logic --------------------------------------------------------

def test_tui_completion_and_sort_menu(m, tmp_path):
    def run(m, root):
        for name in ("alpha.png", "alpine.png", "beta.png"):
            (root / name).touch()
        comp = m.tui._Completer(m.tui.complete_rename(root))
        ren = [comp.next(s) for s in ("al", "alpha.png", "alpine.png", "b",
                                      "zzz")]
        (root / "photos").mkdir()
        (root / "phrases").mkdir()
        (root / "photo.txt").touch()
        comp = m.tui._Completer(m.tui.complete_move())
        first = comp.next(str(root / "ph"))
        moves = [first, comp.next(first)]
        recs = [m.engine.FileRecord(path=Path(p), size=i, modified=float(i))
                for i, p in enumerate(["b.png", "a10.png", "a2.png"])]
        orders = {}
        for order in m.tui.SORT_MENU:
            rs = list(recs)
            m.engine.sort_files(rs, order)
            orders[order] = [r.path.name for r in rs]
        orders["random"].sort()                 # a permutation, unseeded
        return ren, [Path(p).name for p in moves], m.tui.SORT_MENU, orders

    ren, moves, menu, orders = same(run, m, tmp_path)
    assert ren == ["alpha.png", "alpine.png", "alpha.png", "beta.png", "zzz"]
    assert moves == ["photos", "phrases"]
    assert menu == ["name", "name-desc", "name-natural", "name-natural-desc",
                    "date", "date-desc", "size", "size-desc", "random"]
    assert orders["name-natural"] == ["a2.png", "a10.png", "b.png"]


def test_tui_time_format(m):
    now = time.time()

    def run(m):
        return [m.tui._fmt_time(now - 30, True),
                m.tui._fmt_time(now - 7200, True),
                m.tui._fmt_time(now - 3 * 86400, True),
                m.tui._fmt_time(now, False), m.tui._fmt_time(0, True)]

    out = same(run, m)
    assert out[:3] == ["just now", "2h ago", "3d ago"] and out[4] == "?"
    assert len(out[3]) == 16 and out[3][4] == "-"


# --- search -----------------------------------------------------------------

def _search_records(m):
    def rec(name, gps=None, ts=None, quality=None, res=None):
        return m.engine.FileRecord(path=Path(name), gps_pos=gps,
                                   exif_timestamp=ts, pdq_quality=quality,
                                   resolution=res, content_hash=b"")
    return [rec("/p/helsinki_cathedral.jpg", (60.1699, 24.9384), 1000, 90,
                (4000, 3000)),
            rec("/p/tampere_lake.jpg", (61.4978, 23.7610), 2000, 95,
                (4000, 3000)),
            rec("/p/paris_tower.jpg", (48.8584, 2.2945), 3000, 40,
                (1920, 1080)),
            rec("/p/nogps_scan.png", None, None, 10, (640, 480))]


_QUERIES = {
    "filename": ("tampere", None, ["tampere_lake.jpg"]),
    "suffix": ("jpg$", None, ["helsinki_cathedral.jpg", "tampere_lake.jpg",
                              "paris_tower.jpg"]),
    "geo": ("distancelonlat:24.9384:60.1699:200", None,
            ["helsinki_cathedral.jpg", "tampere_lake.jpg"]),
    "named": ("DistanceFrom:paris:50", {"paris": [48.8566, 2.3522]},
              ["paris_tower.jpg"]),
    "quality": ("quality:>=:90", None,
                ["helsinki_cathedral.jpg", "tampere_lake.jpg"]),
    "width": ("width:1920", None, ["paris_tower.jpg"]),
    "and": ("jpg$ quality:>=:90 distancelonlat:24.9384:60.1699:50", None,
            ["helsinki_cathedral.jpg"]),
}


@pytest.mark.parametrize("case", sorted(_QUERIES))
def test_search_records(m, case):
    query, locations, want = _QUERIES[case]

    def run(m):
        return [r.path.name for r in m.search.search_records(
            _search_records(m), query, locations=locations)]

    assert same(run, m) == want


def test_search_unknown_location_raises(m):
    def run(m):
        with pytest.raises(ValueError) as e:
            m.search.search_records(_search_records(m),
                                    "DistanceFrom:nowhere:5")
        return str(e.value)

    same(run, m)


# --- search index -----------------------------------------------------------

def test_search_index_parsing(m):
    def run(m):
        si = m.si
        nums = {s: si.extract_number_from_string(s) for s in (
            "f/2.8", "F/2.8", "1/250s", "1/250", "ISO 100", "24mm", "100",
            "2.8", "-3.5", "1/37.738", "not a number", "1e-5", "3-4")}
        ranges = [si.parse_range_value(s) for s in (
            "24-70", "1600-", "-3-3", "f/2.8-f/11", "100")]
        aliases = [si.resolve_tag_name(s) for s in (
            "iso", "aperture", "shutter", "az", "camera", "nosuchtag", "wb",
            "metering", "program", "lat", "longitude", "datetime", "date",
            "subjectdistance")]
        with pytest.raises(ValueError):
            si.parse_search_query("bogus:1")
        return nums, ranges, aliases

    nums, ranges, aliases = same(run, m)
    assert nums["1/250s"] == pytest.approx(1 / 250)
    assert nums["not a number"] is None and nums["3-4"] is None
    assert ranges == [(24.0, 70.0), (1600.0, math.inf), (-3.0, 3.0),
                      (2.8, 11.0), None]
    assert aliases[:6] == ["ISO", "FNumber", "ExposureTime", "SunAzimuth",
                           "Model", None]


_INDEX_DATA = [
    {"Make": "Canon", "Model": "EOS R5", "ISO": 100, "FNumber": "f/2.8",
     "FocalLength": "24mm"},
    {"Make": "Canon", "Model": "EOS R6", "ISO": 1600, "FNumber": "f/4",
     "FocalLength": "70mm"},
    {"Make": "Nikon", "Model": "Z9", "ISO": 6400, "FNumber": "f/1.8",
     "FocalLength": "50 mm"},
    {"Make": "SONY", "Model": "A7 IV", "ISO": 400, "ExposureTime": "1/250s"},
]
_INDEX_QUERIES = {
    "make:Canon": {0, 1}, "make:~:cano": {0, 1}, "model:~:eos": {0, 1},
    "make:nikon": {2}, "iso:100": {0}, "iso:>:400": {1, 2},
    "iso:>=:400": {1, 2, 3}, "iso:<:400": {0}, "iso:100-1600": {0, 1, 3},
    "iso:1600-": {1, 2}, "aperture:f/2.8": {0}, "f:<=:2.8": {0, 2},
    "make:Canon iso:>:200": {1}, "make:Canon; iso:<:200": {0},
    "model:re:^EOS.R[56]$": {0, 1}, "model:re:Z\\d": {2},
    "shutter:<:0.01": {3}, "focal:24-50": {0, 2}, "iso:<:abc": set(),
}


def test_search_index_queries(m):
    def run(m):
        ix = m.si.SearchIndex()
        for k, tags in enumerate(_INDEX_DATA):
            ix.insert(k, tags)
        ix.finalize()
        return {q: ix.search(q) for q in _INDEX_QUERIES}

    assert same(run, m) == _INDEX_QUERIES


def test_search_index_remove_and_slot_reuse(m):
    def run(m):
        ix = m.si.SearchIndex()
        for k, tags in enumerate(_INDEX_DATA):
            ix.insert(k, tags)
        ix.finalize()
        ix.remove(1)
        out = [ix.search("make:Canon")]
        slot = ix.alloc_slot()
        ix.insert(slot, {"Make": "Fuji", "ISO": 200})
        ix.finalize()
        out += [slot, ix.search("make:fuji"), ix.search("iso:200"),
                ix.search("make:Nikon")]
        ix2 = m.si.SearchIndex()
        a = ix2.alloc_slot()
        ix2.insert(a, {"Make": "x"})
        ix2.remove(a)
        ix2.remove(a)              # a duplicate watcher event
        out.append(ix2.alloc_slot() != ix2.alloc_slot())
        return out

    assert same(run, m) == [{0}, 1, {1}, {1}, {2}, True]


def test_search_index_bulk_remove(m):
    """The bulk removal's result (its speed is the JAX package's own
    test's business; no time limit here)."""
    def run(m):
        ix = m.si.SearchIndex()
        for i in range(20_000):
            ix.insert(ix.alloc_slot(),
                      {"Make": f"Maker{i % 50}", "ISO": 100 + (i % 32) * 100,
                       "FNumber": f"f/{1 + (i % 8)}.0"})
        ix.finalize()
        n = ix.remove_many(list(range(4_000, 6_000)))
        return n, len(ix), ix.search("iso:100"), ix.search("make:maker7")

    n, size, hits, makers = same(run, m)
    assert n == 2_000 and size == 18_000
    assert hits and not (set(range(4_000, 6_000)) & hits)
    assert len(makers) == 360


def test_search_index_tags_from_features(m):
    def run(m):
        ix = m.si.SearchIndex()
        ix.insert(0, {"WhiteBalance": 1, "MeteringMode": 5,
                      "GPSLatitude": 60.1699, "GPSLongitude": 24.9384,
                      "SubjectDistance": [4.0]})
        ix.insert(1, {"WhiteBalance": 0, "MeteringMode": 2,
                      "GPSLatitude": -33.8688, "GPSLongitude": 151.2093})
        ix.finalize()
        found = [ix.search(q) for q in ("wb:1", "metering:2", "lat:0-90",
                                        "lon:100-180", "subjectdistance:3-5")]
        tags = m.si.features_to_tags(
            {"width": 640, "height": 480, "orientation": 6,
             "exif_timestamp": 1700000000, "altitude": 12.5,
             "tags": {"Make": "Canon", "UnknownTag": "x"}}, quality=95)
        gps = m.si.features_to_tags({"gps": [40.7580, -73.9855],
                                     "width": 10, "height": 8})
        return found, tags, gps

    found, tags, gps = same(run, m)
    assert found == [{0}, {1}, {0}, {1}, {0}]
    assert tags["ImageWidth"] == 640 and tags["PdqQuality"] == 95
    assert "UnknownTag" not in tags
    assert (gps["GPSLatitude"], gps["GPSLongitude"]) == (40.758, -73.9855)


# --- palette ----------------------------------------------------------------

def test_palette_oklab_and_histograms(m):
    def run(m):
        p = m.palette
        rgb = np.random.default_rng(0).integers(0, 256, (64, 3),
                                                dtype=np.uint8)
        lab = p.rgb_to_oklab(rgb)
        marks = p.rgb_to_oklab(np.array([[255, 255, 255], [0, 0, 0]],
                                        dtype=np.uint8))
        grey = np.full((64, 64, 3), 128, dtype=np.uint8)
        return (lab, p.oklab_to_rgb_u8(lab), marks, p.oklab_histograms(grey),
                p.luma_histogram(grey))

    lab, back, marks, (hl, ha, hb), lh = same(run, m)
    rgb = np.random.default_rng(0).integers(0, 256, (64, 3), dtype=np.uint8)
    assert np.abs(back.astype(int) - rgb.astype(int)).max() <= 1
    assert marks[0, 0] == pytest.approx(1.0, abs=1e-3)
    assert marks[1, 0] == pytest.approx(0.0, abs=1e-3)
    assert hl.sum() == 64 * 64 and hl.argmax() > 100
    assert abs(int(ha.argmax()) - 128) <= 2 and lh[128] == 64 * 64


@pytest.mark.parametrize("scene", ["two_colours", "dominant", "dark_floor"])
def test_palette_kmeans(m, scene):
    def image():
        if scene == "two_colours":
            img = np.zeros((40, 40, 3), dtype=np.uint8)
            img[:20] = [255, 0, 0]
            img[20:] = [0, 0, 255]
            return img
        rng = np.random.default_rng(1 if scene == "dominant" else 2)
        img = np.zeros((120 if scene == "dominant" else 80,) * 2 + (3,),
                       dtype=np.uint8)
        if scene == "dominant":
            img[:, :60] = [200, 40, 40]
            img[:, 60:] = [40, 60, 200]
            noise = rng.integers(-12, 12, img.shape)
        else:
            img[:40] = [3, 3, 3]
            img[40:60] = [220, 180, 40]
            img[60:] = [10, 160, 90]
            noise = rng.integers(-6, 6, img.shape)
        return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)

    def run(m):
        cfg = (None if scene == "two_colours"
               else m.palette.PaletteConfig(dominant_colors=4))
        args = (image(),) if cfg is None else (image(), cfg)
        return [tuple(int(v) for v in c) for c in
                m.palette.kmeans_palette(*args)]

    pal = same(run, m)
    if scene == "two_colours":
        assert set(pal) == {(255, 0, 0), (0, 0, 255)}
    elif scene == "dominant":
        for target in ([200, 40, 40], [40, 60, 200]):
            assert any(np.abs(np.asarray(c) - target).max() < 40 for c in pal)
    else:
        assert all(sum(c) > 24 for c in pal)


# --- HDR --------------------------------------------------------------------

def test_hdr_transfer_functions(m):
    def run(m):
        h = m.hdr
        x = np.linspace(0, 1, 100)
        knee = [h.hlg_oetf_inverse(np.float64(v)) for v in
                (0.0, 0.5, 1.0, 0.4999, 0.5001)]
        lin = np.array([[[0.1, 0.1, 0.1]]])
        sdr = np.array([[[0.01, 0.01, 0.01]]])
        rgb = np.random.default_rng(0).random((4, 4, 3))
        return (h.pq_eotf(np.float64(1.0)), h.pq_inverse_eotf(np.float64(0.01)),
                h.pq_inverse_eotf(h.pq_eotf(x)), knee,
                h.tonemap_pq_maxrgb(lin, peak_nits=203.0),
                h.tonemap_pq_maxrgb(sdr, peak_nits=203.0),
                h.hdr_to_sdr(rgb, h.Cicp(h.PRIMARIES_BT709, h.TRANSFER_SRGB)),
                h.srgb_eotf(rgb), [np.ones((1, 3)) @ mm.T for mm in
                                   (h.BT2020_TO_BT709, h.P3_TO_BT709)])

    pq1, sig, rt, knee, peak, kept, passthru, srgb, whites = same(run, m)
    assert pq1 == pytest.approx(1.0, abs=1e-9)
    assert sig == pytest.approx(0.5081, abs=2e-3)
    assert np.allclose(rt, np.linspace(0, 1, 100), atol=1e-6)
    assert knee[1] == pytest.approx(1 / 12, abs=1e-6)
    assert abs(float(knee[4]) - float(knee[3])) < 1e-3
    assert peak.max() <= 1.0
    assert 0.7 < float(kept[0, 0, 0]) / (0.01 / (203.0 / 10000.0)) <= 1.05
    assert np.allclose(passthru, srgb, atol=1e-9)
    assert all(np.allclose(w, 1.0, atol=5e-3) for w in whites)


def _png_with_cicp(p, t, mx, fr):
    def chunk(ctype, payload):
        c = struct.pack(">I", len(payload)) + ctype + payload
        return c + struct.pack(">I", zlib.crc32(ctype + payload))
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"cICP", bytes([p, t, mx, fr]))
            + chunk(b"IDAT", b"\x00") + chunk(b"IEND", b""))


def test_hdr_detects_cicp(m):
    def run(m):
        h = m.hdr
        png = h.detect_cicp_png(_png_with_cicp(9, 16, 0, 1))
        plain_png = h.detect_cicp_png(
            _png_with_cicp(1, 13, 0, 1).replace(b"cICP", b"cXCP"))
        avif = h.detect_cicp_isobmff(
            b"\x00\x00\x00\x18ftypavif" + b"\x00" * 16 + b"colrnclx"
            + struct.pack(">HHH", 12, 18, 6) + b"\x80")
        icc = (b"\x00" * 128 + struct.pack(">I", 1)
               + struct.pack(">4sII", b"cicp", 144, 12)
               + b"cicp" + b"\x00" * 4 + bytes([9, 16, 0, 1]))
        return (png, png.is_hdr, png.needs_conversion, plain_png, avif,
                h.detect_cicp_icc(icc))

    png, is_hdr, needs, plain_png, avif, icc = same(run, m)
    assert (png.primaries, png.transfer) == (9, 16) and is_hdr and needs
    assert plain_png is None
    assert (avif.primaries, avif.transfer, avif.full_range) == (12, 18, True)
    assert icc.transfer == 16


def test_hdr_pipeline_and_dither(m):
    def run(m):
        h = m.hdr
        tones = h.encode_srgb_u8_dithered(h.hdr_to_sdr(
            np.array([[[0.0] * 3, [0.5] * 3, [1.0] * 3]]),
            h.Cicp(h.PRIMARIES_BT709, h.TRANSFER_BT709)), seed=1)
        grad = np.linspace(0, 0.6, 64)
        pq = h.encode_srgb_u8_dithered(h.hdr_to_sdr(
            np.stack([grad] * 3, axis=-1)[None],
            h.Cicp(h.PRIMARIES_BT2020, h.TRANSFER_PQ)))
        flat = h.encode_srgb_u8_dithered(np.full((64, 64, 3), 0.2))
        ramp = np.linspace(0.195, 0.205, 4096)[:, None, None] * np.ones(
            (1, 8, 3))
        return tones, pq, flat, h.encode_srgb_u8_dithered(ramp)

    tones, pq, flat, ramp = same(run, m)
    assert tuple(tones[0, 0]) == (0, 0, 0)
    assert tuple(tones[0, 2]) == (255, 255, 255) and tones[0, 1, 0] < 122
    vals = pq[0, :, 0].astype(int)
    assert vals[0] <= 2 and vals[-1] >= 200 and np.all(np.diff(vals) >= -2)
    assert abs(flat.mean() - float(load("rupphash_tpu").hdr.srgb_oetf(
        np.array(0.2))) * 255) < 0.5
    assert np.array_equal(ramp[..., 0], ramp[..., 1])
    assert len(np.unique(ramp[:, 0, 0])) >= 2


def test_hdr_blue_noise_asset(m):
    """Each package loads the 256x256 tile from its own assets/ (a missing
    asset would fall back to a generated 64x64 tile)."""
    def run(m):
        asset = Path(m.hdr.__file__).resolve().parents[1] / "assets" / \
            "blue-noise-256.npy"
        return asset.read_bytes(), m.hdr.blue_noise_tile()

    _, bn = same(run, m)
    assert bn.shape == (256, 256)
    n = bn.size
    assert np.allclose(np.sort(bn.flatten()), (np.arange(n) + 0.5) / n)
    f = np.fft.fftshift(np.abs(np.fft.fft2(bn - bn.mean())) ** 2)
    yy, xx = np.meshgrid(*[np.arange(256) - 128] * 2, indexing="ij")
    r = np.hypot(yy, xx)
    assert f[(r >= 64) & (r < 256 / 2.2)].mean() > 3 * f[(r > 0)
                                                         & (r < 32)].mean()


# --- animated ---------------------------------------------------------------

def _gif(n_frames=4, duration=50, size=(32, 24)) -> bytes:
    rng = np.random.default_rng(0)
    frames = [Image.fromarray(
        rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
        for _ in range(n_frames)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True,
                   append_images=frames[1:], duration=duration, loop=0)
    return buf.getvalue()


def _webp_anim(n_frames=3, duration=80) -> bytes:
    rng = np.random.default_rng(1)
    frames = [Image.fromarray(
        rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
        for _ in range(n_frames)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True,
                   append_images=frames[1:], duration=duration)
    return buf.getvalue()


def _still(fmt):
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, format=fmt)
    return buf.getvalue()


def test_animated_probe_and_sniff(m):
    def run(m):
        a = m.animated
        probes = [a.probe(b) for b in (
            _gif(), _still("GIF"), _webp_anim(), _still("WEBP"), b"",
            b"RIFFxxxxWEBP", b"\x89PNG\r\n\x1a\nbroken")]
        sniffs = [a.sniff_animatable(b) for b in (
            _gif()[:16], _webp_anim()[:16], b"\x89PNG\r\n\x1a\n" + b"\0" * 8,
            b"\xff\xd8\xff\xe0" + b"\0" * 12, b"II*\x00" + b"\0" * 12, b"")]
        return probes, sniffs

    assert same(run, m) == ([("gif"), None, "webp", None, None, None, None],
                            [True, True, True, False, False, False])


def test_animated_decode_frames(m):
    def run(m):
        a = m.animated
        out = [a.decode_frames(_gif(5, duration=d)) for d in (50, 0, 1)]
        return out, a.decode_frames(b"garbage"), (
            a.DEFAULT_FRAME_DELAY_S, a.MIN_FRAME_DELAY_S)

    out, garbage, (default, floor) = same(run, m)
    (frames, delays), (_, zero), (_, fast) = out
    assert len(frames) == 5 and all(abs(d - 0.05) < 1e-9 for d in delays)
    assert zero == [default] * 5 and all(d >= floor for d in fast)
    assert garbage == (None, None)


def test_frontend_sources_are_the_reference_copies():
    """The port's frontend modules are the JAX package's, byte for byte
    (they bind to the port's modules through relative imports)."""
    root = Path(__file__).resolve().parent.parent
    files = ["state.py", "tui.py", "search.py", "search_index.py",
             "pipeline/view.py", "pipeline/animated.py", "pipeline/hdr.py",
             "pipeline/palette.py", "gui/__init__.py", "gui/imaging.py",
             "gui/lut.py", "gui/page.py", "gui/server.py", "gui/watcher.py",
             "assets/blue-noise-256.npy"]
    differ = [f for f in files
              if (root / "rupphash_tpu" / f).read_bytes()
              != (root / "rupphash_tpu_torch" / f).read_bytes()]
    assert differ == []
    assert os.path.getsize(root / "rupphash_tpu_torch" / "assets"
                           / "blue-noise-256.npy") == 131_200

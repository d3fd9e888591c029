"""The port's web GUI (`gui/`: server, imaging, LUTs, watcher) against the
JAX package's.

Each case runs for both packages (`torch_mirror.same`): the package a
case was given serves a session over its own copy of a numpy-seeded
tree, and the other package serves the same session over another copy;
every HTTP answer must be equal.  /api/state and the other JSON answers
compare equal once each tree's directory reads ROOT; /api/image and
/api/analysis answers are the same bytes.  The per-session CSRF token
comes from the page at `/`, as a browser takes it; the two pages differ
in nothing else."""
import contextlib
import io
import json
import re
import sys
import threading
import time
import urllib.parse
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu_torch import device
from torch_child import GuiClient, http, png16
from torch_mirror import PKGS, load, same


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


@pytest.fixture(params=PKGS)
def m(request):
    return load(request.param)


def _identity_cube(n=9):
    lines = [f"LUT_3D_SIZE {n}"]
    for b in range(n):
        for g in range(n):
            for r in range(n):
                lines.append(f"{r/(n-1):.6f} {g/(n-1):.6f} {b/(n-1):.6f}")
    return "\n".join(lines)


def _invert_cube(n):
    lines = ['TITLE "invert"', f"LUT_3D_SIZE {n}"]
    for b in range(n):
        for g in range(n):
            for r in range(n):
                lines.append(f"{1-r/(n-1):.6f} {1-g/(n-1):.6f} "
                             f"{1-b/(n-1):.6f}")
    return "\n".join(lines)


def _three_pngs(root):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(base).resize((96, 64), Image.BILINEAR))
    paths = []
    for i, name in enumerate(["a.png", "b.png", "c.png"]):
        arr = img.copy()
        arr[0, 0, 0] = i                   # distinct bytes
        Image.fromarray(arr).save(root / name)
        paths.append(root / name)
    return paths


class Session:
    """One package's GuiServer on a thread, and a client of it."""

    def __init__(self, srv):
        self.srv = srv
        self.httpd, port = srv.serve()
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.gui = GuiClient(f"http://127.0.0.1:{port}/")

    def json(self, path):
        status, ctype, body = self.gui.get(path)
        return status, ctype, json.loads(body)

    def post(self, endpoint, payload, token=None, origin=None):
        headers = {"Content-Type": "application/json",
                   "X-Session-Token": self.gui.token if token is None
                   else token}
        if origin:
            headers["Origin"] = origin
        status, _, body = http(self.gui.base + endpoint,
                               json.dumps(payload).encode(), headers)
        return status, json.loads(body)

    def intent(self, name, arg=None, **kw):
        return self.post("/api/intent", {"intent": name, "arg": arg}, **kw)

    def key(self, key, **kw):
        return self.post("/api/key", {"key": key}, **kw)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@contextlib.contextmanager
def serving(m, root, groups=None, infos=None, **server_kw):
    """The three-PNG session of the JAX package's GUI tests unless
    groups are given."""
    paths = []
    if groups is None:
        paths = _three_pngs(root)
        groups = [[m.engine.FileRecord(path=p, size=p.stat().st_size,
                                       resolution=(96, 64),
                                       unique_file_id=100 + i)
                   for i, p in enumerate(paths)]]
        infos = [m.engine.GroupInfo(max_dist=2)]
    st = m.state.AppState(groups, infos or [m.engine.GroupInfo()])
    s = Session(m.server.GuiServer(st, **server_kw))
    s.paths = paths
    try:
        yield s
    finally:
        s.close()


def _exists(paths):
    return [p.exists() for p in paths]


# --- LUTs and the image engine's pure functions ----------------------------

def test_lut_parse_and_apply(m):
    def run(m):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (31, 17, 3), dtype=np.uint8)
        ident = m.lut.parse_cube(_identity_cube())
        inv = m.lut.parse_cube(_invert_cube(5))
        ramp = np.repeat(np.arange(0, 256, 5, dtype=np.uint8).reshape(
            -1, 1, 1), 3, axis=2)
        bad = [m.lut.parse_cube(t) is None for t in (
            "LUT_3D_SIZE 2\n0 0 0", "LUT_1D_SIZE 4\n0\n1\n2\n3",
            "garbage everywhere")]
        return (ident.size, m.lut.apply_lut_u8(img, ident), inv.title,
                m.lut.apply_lut_u8(ramp, inv), bad)

    size, same_img, title, inverted, bad = same(run, m)
    img = np.random.default_rng(0).integers(0, 256, (31, 17, 3),
                                            dtype=np.uint8)
    assert size == 9 and np.array_equal(same_img, img)
    ramp = np.repeat(np.arange(0, 256, 5).reshape(-1, 1, 1), 3, axis=2)
    assert title == "invert"
    assert np.abs(inverted.astype(int) - (255 - ramp)).max() <= 1
    assert bad == [True, True, True]


def test_exif_orient_transforms_and_png16(m):
    def run(m):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
        oriented = [m.imaging.exif_orient(img, o) for o in range(1, 9)]
        small = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
        turns = [m.imaging.apply_transform(small, quarter_turns=q)
                 for q in range(5)]
        flips = m.imaging.apply_transform(
            m.imaging.apply_transform(small, flip_h=True), flip_h=True)
        deep = rng.integers(0, 65536, (12, 17, 3), dtype=np.uint16)
        return oriented, turns, flips, m.imaging.encode_png16(deep), deep

    oriented, turns, flips, encoded, deep = same(run, m)
    img = oriented[0]
    table = [img, img[:, ::-1], img[::-1, ::-1], img[::-1],
             np.swapaxes(img, 0, 1), np.rot90(img, 3),
             np.swapaxes(img[::-1, ::-1], 0, 1), np.rot90(img, 1)]
    assert all(np.array_equal(o, t) for o, t in zip(oriented, table))
    assert np.array_equal(turns[4], turns[0])
    assert np.array_equal(turns[1], np.rot90(turns[0], -1))
    assert np.array_equal(flips, turns[0])
    assert np.array_equal(png16(encoded), deep)


# --- the HTTP surface -------------------------------------------------------

def test_page_state_and_token(m, tmp_path):
    """The page differs only in its token; /api/state is equal."""
    def run(m, root):
        with serving(m, root) as s:
            status, ctype, page = s.gui.get("/")
            page = page.replace(s.gui.token.encode(), b"TOKEN")
            return status, ctype, page, s.json("/api/state")

    status, ctype, page, (_, _, snap) = same(run, m, tmp_path)
    assert status == 200 and "text/html" in ctype
    assert b"rupphash_tpu" in page and b"const TOKEN = 'TOKEN'" in page
    assert len(snap["groups"][0]["files"]) == 3
    assert snap["groups"][0]["max_dist"] == 2 and snap["cursor"] == [0, 0]


def test_image_and_analysis_endpoints(m, tmp_path):
    """/api/image (JPEG, 48-bit PNG, rotated) and /api/analysis: the same
    bytes from both servers."""
    def run(m, root):
        with serving(m, root) as s:
            out = [s.gui.get(q) for q in (
                "/api/image?g=0&f=1&s=512", "/api/image?g=0&f=0&deep=1",
                "/api/analysis?g=0&f=0", "/api/image?g=9&f=0")]
            s.intent("rotate_cw")
            out.append(s.gui.get("/api/image?g=0&f=0&s=512"))
            return out

    jpeg, deep, analysis, missing, rotated = same(run, m, tmp_path)
    assert jpeg[:2] == (200, "image/jpeg") and jpeg[2][:2] == b"\xff\xd8"
    assert Image.open(io.BytesIO(jpeg[2])).size == (96, 64)
    assert deep[1] == "image/png"
    assert np.array_equal(png16(deep[2]), np.asarray(
        Image.open(tmp_path / m.pkg / "a.png"))[..., :3].astype(np.uint16) * 257)
    a = json.loads(analysis[2])
    assert len(a["luma"]) == 256 and len(a["okl"]) == 256 and a["palette"]
    assert missing[0] == 404
    assert Image.open(io.BytesIO(rotated[2])).size == (64, 96)


def test_intents_mark_delete_and_gates(m, tmp_path):
    def run(m, root):
        with serving(m, root) as s:
            trail = [s.intent(n)[1] for n in ("toggle_mark", "next_item")]
            # the CSRF gate: no token, a wrong one, a foreign Origin
            gates = [s.intent("execute_delete", token="")[0],
                     s.intent("execute_delete", token="deadbeef" * 4)[0],
                     s.intent("execute_delete",
                              origin="http://evil.example")[0]]
            kept = _exists(s.paths)
            trail += [s.intent(n)[1] for n in ("confirm_delete",
                                               "execute_delete")]
            return trail, gates, kept, _exists(s.paths)

    trail, gates, kept, left = same(run, m, tmp_path)
    assert trail[0]["marked"] == 1 and trail[0]["cursor"] == [0, 1]
    assert trail[1]["cursor"] == [0, 2]
    assert gates == [403, 403, 403] and kept == [True] * 3
    assert trail[2]["pending_confirm"] == "delete"
    assert trail[3]["pending_confirm"] is None
    assert left == [False, True, True]
    assert len(trail[3]["groups"][0]["files"]) == 2


def test_destructive_intents_are_confirm_gated(m, tmp_path):
    def run(m, root):
        with serving(m, root) as s:
            snaps = [s.intent(n)[1] for n in (
                "toggle_mark", "execute_delete", "cancel", "delete_immediate",
                "cancel", "move_marked", "unmark_all")]
            return snaps, _exists(s.paths)

    snaps, left = same(run, m, tmp_path)
    assert [x["pending_confirm"] for x in snaps[1:5]] == [
        "delete", None, "delete-one", None]
    assert "no move target" in snaps[5]["status"] and left == [True] * 3


def test_rename_search_complete_and_quit(m, tmp_path):
    def run(m, root):
        with serving(m, root) as s:
            (root / "sub").mkdir()
            (root / "somefile.txt").write_text("x")
            out = [s.json("/api/search?q=a.png"),
                   s.json("/api/search?q=imagewidth:96"),
                   s.json("/api/search?q=imagewidth:>:1000"),
                   s.json("/api/complete?prefix="
                          + urllib.parse.quote(str(root) + "/s")),
                   s.json("/api/complete?prefix=/no/such/dir/x"),
                   s.intent("submit_rename", "renamed.png"),
                   s.intent("unknown_thing"), s.intent("quit")]
            return out, (root / "renamed.png").exists()

    out, renamed = same(run, m, tmp_path)
    assert out[0][2]["matches"] == [[0, 0]]
    assert out[1][2]["matches"] == [[0, 0], [0, 1], [0, 2]]
    assert out[2][2]["matches"] == []
    assert "ROOT/sub/" in [c.replace(str(tmp_path / m.pkg), "ROOT")
                           for c in out[3][2]["completions"]]
    assert out[4][2]["completions"] == []
    assert renamed and "unknown intent" in out[6][1]["status"]
    assert out[7][1]["quit"]


def test_concurrent_intents_and_reads_are_serialized(m, tmp_path):
    """Eight clients at once: every answer a whole snapshot; the final
    state equal between the packages."""
    import concurrent.futures

    def run(m, root):
        with serving(m, root) as s:
            def worker(k):
                for _ in range(10):
                    if k % 3 == 2:
                        snap = s.json("/api/state")[2]
                    else:
                        snap = s.intent("next_item" if k % 3 == 0
                                        else "prev_item")[1]
                    assert 0 <= snap["cursor"][1] < 3
                    assert len(snap["groups"][0]["files"]) == 3

            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                for f in [ex.submit(worker, k) for k in range(8)]:
                    f.result(timeout=120)
            snap = s.json("/api/state")[2]
            snap.pop("cursor")             # depends on the interleaving
            snap.pop("rev")
            for f in snap["groups"][0]["files"]:
                f.pop("cls")
            return snap

    assert same(run, m, tmp_path)["groups"]


@pytest.mark.parametrize("keys", [
    "j ArrowUp space u !",
    "W W W Z Z Z Z Z z I I I N N N E P P P < < > > > > ? T A",
    "space d Shift Escape d y",
    "c C r / f F n p",
    "s s .",
    "s s s s s s s s s s s s",
], ids=["navigate", "view", "confirm", "prompts", "sort", "sort-cycle"])
def test_key_endpoint(m, tmp_path, keys):
    """The server-side keymap: each key's answer (snapshot and prompt
    descriptor) equal between the packages."""
    def run(m, root):
        with serving(m, root) as s:
            out = []
            for k in keys.split():
                status, ans = s.key(" " if k == "space" else k)
                out.append((status, ans, s.srv.rev, s.srv.data_rev))
            out.append(s.key("j", token="deadbeef")[0])
            return out, _exists(s.paths)

    out, left = same(run, m, tmp_path)
    assert out[-1] == 403
    if keys.startswith("space d"):
        assert out[1][1]["snapshot"]["pending_confirm"] == "delete"
        assert out[3][1]["snapshot"]["pending_confirm"] is None
        assert left == [False, True, True]
    elif keys.startswith("c C"):
        assert out[0][1]["ui"] == {"op": "prompt",
                                   "label": "Move-target directory:",
                                   "intent": "set_move_target",
                                   "paths": True}
        assert out[2][1]["ui"]["preset"] == "a.png"
    elif keys == "s s .":
        assert [o[1]["snapshot"]["sort_order"] for o in out[:2]] == [
            "name-desc", "name-natural"]
        assert out[2][1]["snapshot"]["status"] == (
            "directory change not available")
    elif keys.startswith("W"):
        assert [o[1]["snapshot"]["view"]["zoom_mode"] for o in out[:8]] == [
            "fitw", "fith", "fit", "x1", "x2", "x4", "x8", "fit"]
    elif keys.startswith("s s s"):
        seen = [o[1]["snapshot"]["sort_order"] for o in out[:-1]]
        assert "location" in seen and seen[-1] == "name"
    else:
        assert out[0][1]["snapshot"]["cursor"] == [0, 1]
        assert out[4][1]["ui"] is None


def test_map_locations_distance_and_malformed_entries(m, tmp_path):
    def run(m, root):
        rng = np.random.default_rng(9)
        Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
                        ).resize((96, 64), Image.BILINEAR).save(root / "geo.png")
        p = root / "geo.png"
        rec = m.engine.FileRecord(path=p, size=p.stat().st_size,
                                  resolution=(96, 64), unique_file_id=7,
                                  gps_pos=(60.1699, 24.9384))
        locations = {"home": (61.4978, 23.7610),
                     "office": {"lat": 60.4518, "lon": 22.2666},
                     "typo_str": "60.17,24.94",
                     "typo_keys": {"latitude": 1, "longitude": 2}}
        with serving(m, root, [[rec]], locations=locations) as s:
            maps = [s.json("/api/state")[2]["map"]]
            maps += [s.key(k)[1]["snapshot"]["map"]
                     for k in ("b", "B", "b", "b", "b", "b")]
            return maps

    maps = same(run, m, tmp_path)
    assert [x["name"] for x in maps[0]["locations"]] == ["home", "office"]
    assert maps[1]["distance"].startswith("image to home:")
    km = float(maps[1]["distance"].split(": ")[1].split(" km")[0])
    assert 150 < km < 175
    assert maps[2]["distance"].startswith("home to image:")
    assert maps[3]["selected_location"] == "office"


def test_lut_cycle_and_animated_passthrough(m, tmp_path):
    def run(m, root):
        rng = np.random.default_rng(0)
        frames = [Image.fromarray(rng.integers(0, 256, (24, 32, 3),
                                               dtype=np.uint8))
                  for _ in range(4)]
        p = root / "mislabeled.jpg"        # an animated GIF named .jpg
        frames[0].save(p, format="GIF", save_all=True,
                       append_images=frames[1:], duration=50, loop=0)
        rec = m.engine.FileRecord(path=p, size=p.stat().st_size,
                                  unique_file_id=9)
        lt = m.lut.parse_cube(_invert_cube(2))
        with serving(m, root, [[rec]],
                     engine=m.imaging.ImageEngine([lt])) as s:
            out = [s.gui.get("/api/image?g=0&f=0")]
            s.srv.apply_intent("rotate_cw")
            out.append(s.srv.apply_intent("cycle_lut")["status"])
            out.append(s.gui.get("/api/image?g=0&f=0"))
            out.append(s.srv.apply_intent("cycle_lut")["status"])
            return out, p.read_bytes()

    (orig, lut_on, apng, lut_off), gif = same(run, m, tmp_path)
    assert orig[1] == "image/gif" and orig[2] == gif
    assert "LUT" in lut_on and apng[1] == "image/png"
    assert b"acTL" in apng[2][:200]
    im = Image.open(io.BytesIO(apng[2]))
    assert im.size == (24, 32) and getattr(im, "n_frames", 1) == 4


def test_watcher_drops_external_deletes(m, tmp_path):
    def run(m, root):
        with serving(m, root) as s:
            w = m.watcher.Watcher(s.srv, [root], interval=999)
            w.tick()                        # baseline
            s.paths[1].unlink()
            w.tick()
            out = [s.srv.snapshot()]
            (root / "new.png").write_bytes(s.paths[0].read_bytes())
            w.tick()
            out.append(s.srv.snapshot()["status"])
            for p in (s.paths[0], root / "new.png", s.paths[2]):
                p.unlink()
            w.tick()
            out.append(s.srv.snapshot()["groups"])
            return out

    snap, status, groups = same(run, m, tmp_path)
    names = [f["name"] for f in snap["groups"][0]["files"]]
    assert names == ["a.png", "c.png"]
    assert "removed externally" in snap["status"]
    assert "rescan to refresh" in status and groups == []


def test_revless_mutation_reaches_pollers(m, tmp_path):
    def run(m, root):
        with serving(m, root) as s:
            rev0 = s.json("/api/state")[2]["rev"]
            unchanged = s.json(f"/api/state?rev={rev0}")[2]
            s.srv.state.groups[0][0].gps_pos = (12.34, 56.78)
            time.sleep(1.1)                 # past the serialisation TTL
            snap = s.json(f"/api/state?rev={rev0}")[2]
            return rev0, unchanged, snap

    rev0, unchanged, snap = same(run, m, tmp_path)
    assert unchanged.get("unchanged") and snap["rev"] > rev0
    assert snap["groups"][0]["files"][0]["gps"] == [12.34, 56.78]


def test_run_gui_scanning_and_viewer_config(m, tmp_path, monkeypatch):
    """_make_server's streaming state, and the map tile template from
    the configuration file."""
    def run(m, root):
        monkeypatch.setenv("RUPPHASH_CONFIG_DIR", str(root / "cfg"))

        class A:
            use_trash = False
            move_marked = None
            sort = "name"
            relative_times = False
            slideshow = None

        srv = m.server._make_server([], [], A())
        srv.progress = (0, 0)
        scanning = srv.snapshot()["scanning"]
        p = root / "z.png"
        Image.fromarray(np.random.default_rng(8).integers(
            0, 256, (16, 16, 3), dtype=np.uint8)).save(p)
        with srv.lock:
            srv.state.groups = [[m.engine.FileRecord(path=p, size=1,
                                                     unique_file_id=1)]]
            srv.state.infos = [m.engine.GroupInfo()]
            srv.state._rebuild()
            srv.progress = None
        cfg = m.config.load_config()
        tiles = [m.server._viewer_config()[2]]
        cfg["selected_provider"] = "custom"
        cfg["map_providers"]["custom"] = "https://t.example/{z}/{x}/{y}.png"
        m.config.save_config(cfg)
        tiles.append(m.server._viewer_config()[2])
        return scanning, srv.snapshot(), tiles

    scanning, snap, tiles = same(run, m, tmp_path)
    assert scanning == [0, 0] and snap["scanning"] is None
    assert len(snap["groups"]) == 1
    assert tiles == ["https://tile.openstreetmap.org/{z}/{x}/{y}.png",
                     "https://t.example/{z}/{x}/{y}.png"]


def test_host_header_gate(m):
    ok = ["127.0.0.1:8123", "localhost:8123", "localhost", "[::1]:8123",
          "10.1.2.3:80", "127.0.0.1"]
    bad = ["evil.com:8123", "evil.com", "my-box.local:8123", "sub.domain.tld"]

    def run(m):
        return [m.server.GuiServer.host_allowed(h) for h in ok + bad]

    assert same(run, m) == [True] * len(ok) + [False] * len(bad)


def test_preview_less_dng_renders_through_the_demosaic(m, tmp_path):
    """A preview-less DNG in the session: /api/image and /api/analysis
    render it through each package's own demosaic.  The two demosaics
    sum in another order (PERF.md §2), so the two renditions are held to
    at most 1 u8 level apart on at most 1e-4 of the values, and the
    rest of the answers are equal."""
    sys.path.insert(0, str(Path(__file__).parent))
    from test_dng import _scene, write_dng

    from rupphash_tpu_torch.ops import demosaic

    rgb, mosaic = _scene(64, 96)
    dng = write_dng(mosaic, cm=demosaic._XYZ2SRGB)
    out = {}
    for pkg in (m.pkg, PKGS[1 - PKGS.index(m.pkg)]):
        mm = load(pkg)
        root = tmp_path / pkg
        root.mkdir()
        p = root / "x.dng"
        p.write_bytes(dng)
        rec = mm.engine.FileRecord(path=p, size=len(dng), unique_file_id=1)
        with serving(mm, root, [[rec]]) as s:
            png = s.gui.get("/api/image?g=0&f=0&deep=1")
            status, _, analysis = s.json("/api/analysis?g=0&f=0")
            thumb = mm.imaging.ImageEngine(raw_thumbnails=True).render(
                p, max_side=512)
        out[pkg] = (png, status, analysis, thumb)
    a, b = out[m.pkg], out[PKGS[1 - PKGS.index(m.pkg)]]
    assert a[0][:2] == b[0][:2] == (200, "image/png")
    x = png16(a[0][2]).astype(np.int64)
    y = png16(b[0][2]).astype(np.int64)
    assert x.shape == y.shape == (64, 96, 3)
    diff = np.abs(x - y) / 257.0           # in u8 levels
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size
    assert a[1] == b[1] == 200 and len(a[2]["luma"]) == 256
    assert a[3] is not None and a[3][:2] == b"\xff\xd8"

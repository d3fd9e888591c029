"""The port's CLI against rupphash_tpu's on the same directory, and the
cache shared between the two packages."""
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu.cache import config as cfgmod
from rupphash_tpu.cache.store import CacheStore
from rupphash_tpu.pipeline import scan as ref_scan
from rupphash_tpu_torch import cli, device
from rupphash_tpu_torch.pipeline import scan
from torch_child import Lines, PtyChild, start_gui, stop


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _textured(rng, size=(320, 240)):
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize(size, Image.BILINEAR))


@pytest.fixture
def photos(tmp_path, monkeypatch):
    """Format twins, near-duplicate variants, a mirrored copy, a resized
    copy, unrelated textured images and a corrupt file."""
    monkeypatch.setenv("RUPPHASH_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.setenv("RUPPHASH_CACHE_DIR", str(tmp_path / "cache"))
    d = tmp_path / "photos"
    d.mkdir()
    rng = np.random.default_rng(7)
    a, b, c = (_textured(rng) for _ in range(3))
    Image.fromarray(a).save(d / "a.png")
    Image.fromarray(a).save(d / "a_twin.jpg", quality=92)
    bright = np.clip(a.astype(np.int16) + 12, 0, 255).astype(np.uint8)
    Image.fromarray(bright).save(d / "a_bright.png")
    Image.fromarray(b).save(d / "b.png")
    Image.fromarray(b[:, ::-1]).save(d / "b_mirror.png")
    Image.fromarray(b).resize((200, 150), Image.BILINEAR).save(d / "b_small.png")
    noisy = np.clip(b.astype(np.int16)
                    + rng.integers(-6, 7, b.shape), 0, 255).astype(np.uint8)
    Image.fromarray(noisy).save(d / "b_noisy.jpg", quality=85)
    Image.fromarray(c).save(d / "c.png")
    for k in range(4):
        Image.fromarray(_textured(rng, (180 + 40 * k, 200))).save(
            d / f"other_{k}.png")
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    return d


def _run(module, args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
           "RUPPHASH_CONFIG_DIR": str(tmp_path / "cfg"),
           "RUPPHASH_CACHE_DIR": str(tmp_path / "cache")}
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cli_prints_same_groups_as_reference(photos, tmp_path):
    ours = _run("rupphash_tpu_torch", ["--no-cache", "--device", "cpu",
                                       str(photos)], tmp_path)
    ref = _run("rupphash_tpu", ["--no-cache", str(photos)], tmp_path)
    assert ours == ref
    assert "Found 2 duplicate groups" in ours
    for name in ("a.png", "a_twin.jpg", "a_bright.png", "b.png",
                 "b_mirror.png", "b_small.png", "b_noisy.jpg"):
        assert name in ours
    assert "c.png" not in ours and "other_" not in ours


def test_jax_cache_read_by_port_as_full_hits(photos):
    cfg = ref_scan.ScanConfig()

    def open_store():
        conf = cfgmod.load_config()
        return CacheStore(cfgmod.cache_dir() / "cache.db",
                          conf["_master_key_bytes"])

    store = open_store()
    try:
        ref_groups, ref_infos, _, ref_stats = ref_scan.scan_and_group(
            [photos], cfg, store)
    finally:
        store.close()
    assert ref_stats.decoded == 12 and ref_stats.cache_full == 0
    store = open_store()
    try:
        groups, infos, _, stats = scan.scan_and_group(
            [photos], scan.ScanConfig(), store)
    finally:
        store.close()
    assert stats.cache_full == 12 and stats.decoded == 0
    assert ([[str(f.path) for f in g] for g in groups]
            == [[str(f.path) for f in g] for g in ref_groups])
    assert ([(i.max_dist, i.status) for i in infos]
            == [(i.max_dist, i.status) for i in ref_infos])


def test_cli_surface(capsys):
    assert cli.main(["--similarity", "99", "/tmp"]) == 2
    assert cli.main([]) == 2
    assert cli.main(["--use-tui", "/tmp"]) == 3   # no card, CPU not asked for
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["--slideshow", "0", "--device", "cpu", "/tmp"]) == 2
    assert "Slideshow interval must be positive" in capsys.readouterr().err
    assert cli.main(["--serve"]) == 2
    assert "paths required" in capsys.readouterr().err
    assert cli.main(["--show-build-info"]) == 3   # no card, CPU not asked for
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["--show-build-info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"torch"' in out and '"device": "cpu"' in out


@pytest.fixture(scope="module")
def ignored_cache(tmp_path_factory):
    """A cache filled by the port's CLI over twin images, with the twin
    group ignored: the template that the cache-route cases copy."""
    root = tmp_path_factory.mktemp("cache_routes")
    d = root / "photos"
    d.mkdir()
    rng = np.random.default_rng(5)
    a, b = _textured(rng), _textured(rng)
    Image.fromarray(a).save(d / "a.png")
    Image.fromarray(a).save(d / "a_twin.jpg", quality=92)
    Image.fromarray(b).save(d / "b.png")
    env = {"RUPPHASH_CONFIG_DIR": str(root / "cfg"),
           "RUPPHASH_CACHE_DIR": str(root / "cache")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        assert cli.main([str(d), "--device", "cpu"]) == 0
        conf = cfgmod.load_config()
        store = CacheStore(cfgmod.cache_dir() / "cache.db",
                           conf["_master_key_bytes"])
        from rupphash_tpu.utils import hashes as H
        twins = [H.content_hash(store.content_key, (d / n).read_bytes())
                 for n in ("a.png", "a_twin.jpg")]
        assert store.set_files_ignored(twins) == 2
        uuid = store.get_group_uuid(twins[0])
        store.close()
    return root, d, uuid


@pytest.mark.parametrize("route", ["show_ignored", "unignore_path",
                                   "unignore_uuid", "prune"])
def test_cache_routes_match_reference(ignored_cache, tmp_path, monkeypatch,
                                      capsys, route):
    """--show-ignored, --unignore and --prune: the port and rupphash_tpu,
    each on its own copy of one cache, print the same and leave the
    same ignore state."""
    from rupphash_tpu import cli as ref_cli

    root, d, uuid = ignored_cache
    argv = {"show_ignored": ["--show-ignored"],
            "unignore_path": ["--unignore", str(d / "a.png")],
            "unignore_uuid": ["--unignore", uuid.hex()],
            "prune": ["--prune", "0"]}[route]
    results = []
    for name, main in (("port", cli.main), ("ref", ref_cli.main)):
        for sub in ("cfg", "cache"):
            shutil.copytree(root / sub, tmp_path / name / sub)
        monkeypatch.setenv("RUPPHASH_CONFIG_DIR", str(tmp_path / name / "cfg"))
        monkeypatch.setenv("RUPPHASH_CACHE_DIR",
                           str(tmp_path / name / "cache"))
        rc = main(argv)
        out = capsys.readouterr().out
        conf = cfgmod.load_config()
        store = CacheStore(cfgmod.cache_dir() / "cache.db",
                           conf["_master_key_bytes"])
        ignored = sorted(ch.hex() for ch, _ in store.list_ignored())
        store.close()
        results.append((rc, out, ignored))
    assert results[0] == results[1]
    rc, out, ignored = results[0]
    assert rc == 0
    if route == "show_ignored":
        assert len(out.splitlines()) == 2 and f"uuid={uuid.hex()}" in out
    elif route == "prune":
        assert re.match(r"Pruned \d+ stale entries, swept \d+ orphans", out)
    else:
        assert out.startswith("Cleared ignore flag on ")
        assert len(ignored) == (1 if route == "unignore_path" else 0)


def test_cache_routes_need_the_cache(capsys):
    assert cli.main(["--no-cache", "--prune", "10"]) == 2
    assert "--prune requires the cache" in capsys.readouterr().err
    assert cli.main(["--no-cache", "--show-ignored"]) == 2


def test_serve_cli_answers_and_saves_on_sigint(photos, tmp_path):
    """`--serve DIR --port 0 --index-file F`: scans, prints its URL,
    answers a query and an add, and saves F (adds included) on SIGINT."""
    from rupphash_tpu_torch import serve

    index_file = tmp_path / "index.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path), "RUPPHASH_DEBUG": "1",
           "RUPPHASH_CONFIG_DIR": str(tmp_path / "cfg"),
           "RUPPHASH_CACHE_DIR": str(tmp_path / "cache")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rupphash_tpu_torch", "--serve", str(photos),
         "--device", "cpu", "--port", "0", "--index-file", str(index_file)],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        err = Lines(proc.stderr)
        url = err.wait_for(r"service at (http://\S+/v1/)", 300).group(1)
        assert "indexed 12 images (1 failures)" in err.text()
        with urllib.request.urlopen(url + "stats", timeout=60) as r:
            assert json.loads(r.read())["indexed"] == 12
        req = urllib.request.Request(url + "query",
                                     data=(photos / "a_twin.jpg").read_bytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            names = [pathlib.Path(m["path"]).name
                     for m in json.loads(r.read())["matches"]]
        assert {"a.png", "a_twin.jpg", "a_bright.png"} <= set(names)
        req = urllib.request.Request(url + f"add?path={photos / 'c.png'}",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["size"] == 13
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        rest = err.finish(60)
        assert rc == 0, rest
    finally:
        stop(proc)
    assert "saved index (13 hashes)" in rest
    assert re.search(r"\[KERNELS\] pdq_hash_kernel=0 ", rest)  # CPU: plain
    ix = serve.HashIndex.load(index_file)
    assert len(ix) == 13 and ix.paths.count(str(photos / "c.png")) == 2


# --- the frontends: view mode, TUI, web GUI ---------------------------------

_GUI_ROUTES = {"use-gui": ["--use-gui"],
               "view-flatten": ["--view-flatten", "--use-gui"],
               "shuffle": ["--shuffle", "--use-gui"],
               "slideshow": ["--slideshow", "2", "--use-gui"]}
_TUI_ROUTES = {"use-tui": ["--use-tui"], "view": ["--view"]}


def _frontend_env(tmp_path, name):
    return {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
            "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path / name),
            "RUPPHASH_CONFIG_DIR": str(tmp_path / name / "cfg"),
            "RUPPHASH_CACHE_DIR": str(tmp_path / name / "cache"),
            "TERM": "xterm-256color", "LINES": "40", "COLUMNS": "160"}


def _argv(module, route_args, photos):
    extra = ["--device", "cpu"] if module == "rupphash_tpu_torch" else []
    return [sys.executable, "-m", module, *route_args, *extra, str(photos)]


def _settled(snap):
    """Scan done, and in view mode every decodable file enriched."""
    return snap["scanning"] is None and all(
        f["res"] is not None for g in snap["groups"] for f in g["files"]
        if f["name"] != "corrupt.jpg")


@pytest.mark.parametrize("route", sorted(_GUI_ROUTES))
def test_gui_routes_serve_the_reference_state(route, photos, tmp_path):
    """Each web-GUI route of the port on the CPU serves the /api/state
    that the JAX package's serves for the same directory (the shuffled
    listing as a set), marks a file and quits with exit 0."""
    states = {}
    for module in ("rupphash_tpu", "rupphash_tpu_torch"):
        proc, err, gui = start_gui(
            _argv(module, _GUI_ROUTES[route], photos),
            _frontend_env(tmp_path, module), cwd=ROOT)
        try:
            snap = gui.wait_until(_settled, 300)
            snap = gui.state()       # past the settle, no drift left
            snap.pop("rev")
            if route == "shuffle":
                for g in snap["groups"]:
                    g["files"].sort(key=lambda f: f["name"])
                    for f in g["files"]:   # "sel" follows the cursor
                        f.pop("cls")
                snap.pop("cursor")
            states[module] = snap
            assert gui.intent("toggle_mark")["marked"] == 1
            assert gui.intent("quit")["quit"]
            assert proc.wait(timeout=60) == 0, err.finish(30)
            assert "scan failed" not in err.text()
        finally:
            stop(proc)
    assert states["rupphash_tpu_torch"] == states["rupphash_tpu"]
    names = sorted(f["name"] for g in states["rupphash_tpu"]["groups"]
                   for f in g["files"])
    if route == "use-gui":
        assert sorted(len(g["files"]) for g in states["rupphash_tpu"][
            "groups"]) == [3, 4]
    else:
        assert len(names) == 13 and "corrupt.jpg" in names
    assert (states["rupphash_tpu"]["slideshow"]
            == (2.0 if route == "slideshow" else None))


@pytest.mark.parametrize("route", sorted(_TUI_ROUTES))
def test_tui_routes_render_the_reference_list(route, photos, tmp_path):
    """Each curses route of the port on the CPU, on a pseudo-terminal:
    the list shows the files the JAX package's shows, the sort menu
    opens and closes, the rename prompt takes multi-byte input, and z
    quits with exit 0 (no file renamed)."""
    shown = {}
    for module in ("rupphash_tpu", "rupphash_tpu_torch"):
        child = PtyChild(_argv(module, _TUI_ROUTES[route], photos),
                         _frontend_env(tmp_path, module), cwd=ROOT)
        try:
            child.wait_for(b"a.png", 300)
            child.read_for(1.0)
            shown[module] = sorted(set(re.findall(
                rb"[a-z_0-9]+\.(?:png|jpg)", child.out)))
            child.send(b"s")
            assert b"Sort order" in child.out, child.out[-1500:]
            child.send(b"\x1b")
            child.send(b"r")                    # the rename prompt
            child.send("é".encode())            # multi-byte input
            assert "é".encode() in child.out, child.out[-1500:]
            child.send(b"\x1b")
            child.send(b"z")
        finally:
            rc = child.close(60)
        assert rc == 0, child.out[-2000:]
    assert sorted(p.name for p in photos.iterdir()) == sorted(
        p.name for p in photos.iterdir() if "é" not in p.name)
    assert shown["rupphash_tpu_torch"] == shown["rupphash_tpu"]
    if route == "use-tui":
        assert b"c.png" not in shown["rupphash_tpu"]
        assert b"b_mirror.png" in shown["rupphash_tpu"]
    else:
        assert b"c.png" in shown["rupphash_tpu"]

"""The PyTorch port imports neither jax nor the JAX package, and needs
neither triton nor nvcc to import or to run its plain (CPU) path."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from rupphash_tpu_torch import device


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


ROOT = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "rupphash_tpu_torch",
    "rupphash_tpu_torch.device",
    "rupphash_tpu_torch.cli",
    "rupphash_tpu_torch.ops._build",
    "rupphash_tpu_torch.ops.pdq_torch",
    "rupphash_tpu_torch.ops.pdq_cuda",
    "rupphash_tpu_torch.ops.hamming",
    "rupphash_tpu_torch.ops.hamming_cuda",
    "rupphash_tpu_torch.ops.pdq_hybrid",
    "rupphash_tpu_torch.ops.phash_torch",
    "rupphash_tpu_torch.ops.restack",
    "rupphash_tpu_torch.ops.demosaic",
    "rupphash_tpu_torch.grouping.engine",
    "rupphash_tpu_torch.pipeline.decode",
    "rupphash_tpu_torch.pipeline.heavy",
    "rupphash_tpu_torch.pipeline.scan",
    "rupphash_tpu_torch.serve",
    "rupphash_tpu_torch.tools",
    "rupphash_tpu_torch.tools.selftest",
    "rupphash_tpu_torch.tools.mosaic_repro",
    "rupphash_tpu_torch.tools.prof_nz",
    "rupphash_tpu_torch.state",
    "rupphash_tpu_torch.tui",
    "rupphash_tpu_torch.search",
    "rupphash_tpu_torch.search_index",
    "rupphash_tpu_torch.pipeline.view",
    "rupphash_tpu_torch.pipeline.animated",
    "rupphash_tpu_torch.pipeline.hdr",
    "rupphash_tpu_torch.pipeline.palette",
    "rupphash_tpu_torch.gui.server",
    "rupphash_tpu_torch.gui.imaging",
    "rupphash_tpu_torch.gui.lut",
    "rupphash_tpu_torch.gui.page",
    "rupphash_tpu_torch.gui.watcher",
]

_CHILD = """
import importlib, sys
import numpy as np
for m in {mods!r}:
    importlib.import_module(m)
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import _build, hamming, pdq_torch
device.pin("cpu")
rng = np.random.default_rng(0)
out = pdq_torch.pdq_hash_batch(rng.integers(0, 256, (2, 40, 50), dtype=np.uint8))
assert out["dihedral"].shape == (2, 8, 32)
base = rng.integers(0, 256, (20, 32), dtype=np.uint8)
base[3] = base[11]
ei, ej = hamming.find_edges_fast(base)
assert (ei.tolist(), ej.tolist()) == ([3], [11])
from rupphash_tpu_torch import serve
from rupphash_tpu_torch.ops import pdq_hybrid, phash_torch, restack
from rupphash_tpu_torch.tools import selftest
hyb = pdq_hybrid.pdq_hash_batch_hybrid(rng.integers(0, 256, (2, 40, 50), dtype=np.uint8))
assert hyb["dihedral"].shape == (2, 8, 32)
assert phash_torch.phash_batch(rng.integers(0, 256, (2, 32, 32), dtype=np.uint8))["hash"].shape == (2, 8)
ix = serve.HashIndex()
ix.add("/a", bytes(base[3]), 90)
assert ix.query(np.repeat(base[3][None, None], 8, axis=1), similarity=0)[0][0][:2] == (0, "/a")
import torch
assert restack.restack(torch.zeros((1, 64, 16)), 2).shape == (512, 2)
assert selftest.main([]) == 3
assert "jax" not in sys.modules, "jax imported"
assert "triton" not in sys.modules, "triton imported"
assert _build.load.cache_info().currsize == 0, "kernel library loaded on CPU"
print("OK")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(mods=PORT_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


_RAW_CHILD = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import json, pathlib, tempfile, threading, urllib.request
from PIL import Image
sys.path.insert(0, "tests")
from test_dng import _scene, write_dng
from rupphash_tpu_torch import device, serve
from rupphash_tpu_torch.ops import demosaic
from rupphash_tpu_torch.pipeline import scan
device.pin("cpu")
rgb, mosaic = _scene(240, 320, seed=11)
d = pathlib.Path(tempfile.mkdtemp())
dng = write_dng(mosaic, cm=demosaic._XYZ2SRGB)     # no embedded preview
(d / "photo.dng").write_bytes(dng)
Image.fromarray(rgb).save(d / "twin.png")
groups, infos, records, stats = scan.scan_and_group(
    [d], scan.ScanConfig(batch_size=2))
assert stats.failed == 0, f"{stats.failed} files failed to decode"
assert [sorted(f.path.name for f in g) for g in groups] == [
    ["photo.dng", "twin.png"]], groups
svc = serve.NearDupService(serve.HashIndex.from_records(records))
httpd, port = svc.serve()
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/query", data=dng,
                             method="POST")
with urllib.request.urlopen(req, timeout=60) as r:
    out = json.loads(r.read())
httpd.shutdown()
httpd.server_close()
assert sorted(pathlib.Path(m["path"]).name for m in out["matches"]) == [
    "photo.dng", "twin.png"], out
assert sys.modules.pop("jax") is None
assert not [m for m in sys.modules if m.startswith("jax")], "jax imported"
assert "jax" not in sys.modules
print("OK")
"""


def test_preview_less_raw_scans_and_serves_without_jax(tmp_path):
    """A preview-less DNG is decoded by the port's demosaic, grouped with
    its PNG twin by the scan and matched by a /v1/query of its bytes,
    with every import of jax failing (as on a machine without jax)."""
    proc = subprocess.run(
        [sys.executable, "-c", _RAW_CHILD], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT))
                 for p in (ROOT / "rupphash_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [p.name for p in [ROOT / "chip_smoke.py"]
                  if p.exists() and pattern.search(p.read_text())]
    assert offenders == []


_ALONE_CHILD = """
import sys
sys.modules["rupphash_tpu"] = None      # any import of the JAX package fails
sys.modules["jax"] = None
import importlib, io, json, pathlib, pkgutil, tempfile, threading
import urllib.request
import numpy as np
from PIL import Image
import chip_smoke
import rupphash_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(rupphash_tpu_torch.__path__,
                                              "rupphash_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from rupphash_tpu_torch import cli, device, serve
from rupphash_tpu_torch.pipeline import scan
from rupphash_tpu_torch.tools import selftest
device.pin("cpu")
rng = np.random.default_rng(4)
d = pathlib.Path(tempfile.mkdtemp())
for k, (fmt, ext) in enumerate((("JPEG", "jpg"), ("PNG", "png"),
                                ("WEBP", "webp"))):
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((320, 240), Image.BILINEAR)
    img.save(d / f"img{k}.{ext}", format=fmt, quality=95)
    img.save(d / f"img{k}_twin.png")
rgb, dng = chip_smoke.dng_scene(rng)
(d / "raw.dng").write_bytes(dng)
Image.fromarray(rgb).save(d / "raw_twin.png")
groups, infos, records, stats = scan.scan_and_group(
    [d], scan.ScanConfig(batch_size=4))
assert stats.failed == 0, stats
got = sorted(sorted(f.path.name for f in g) for g in groups)
assert got == [["img0.jpg", "img0_twin.png"], ["img1.png", "img1_twin.png"],
               ["img2.webp", "img2_twin.png"], ["raw.dng", "raw_twin.png"]], got
svc = serve.NearDupService(serve.HashIndex.from_records(records))
httpd, port = svc.serve()
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/query",
                             data=(d / "img2.webp").read_bytes(), method="POST")
with urllib.request.urlopen(req, timeout=60) as r:
    out = json.loads(r.read())
httpd.shutdown()
httpd.server_close()
assert sorted(pathlib.Path(m["path"]).name for m in out["matches"]) == [
    "img2.webp", "img2_twin.png"], out
assert cli.main([str(d), "--no-cache", "--device", "cpu"]) == 0
assert selftest.main(["--device", "cpu"]) == 0
sys.path.insert(0, "tests")
from torch_child import gui_in_thread
t, rc, gui = gui_in_thread(cli.main, [str(d), "--no-cache", "--device", "cpu"])
snap = gui.wait_until(lambda s: s["scanning"] is None, 300)
assert len(snap["groups"]) == 4 and not snap["status"].startswith(
    "scan failed"), snap["status"]
assert gui.intent("quit")["quit"]
t.join(60)
assert not t.is_alive() and rc == [0], rc
t, rc, gui = gui_in_thread(cli.main, [str(d), "--view", "--no-cache",
                                      "--device", "cpu"])
assert [len(g["files"]) for g in gui.state()["groups"]] == [8]
assert gui.intent("quit")["quit"]
t.join(60)
assert not t.is_alive() and rc == [0], rc
assert sys.modules["rupphash_tpu"] is None and sys.modules["jax"] is None
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("rupphash_tpu", "jax"))
assert not loaded, loaded
print("OK", len(mods))
"""


def test_port_runs_with_the_jax_package_blocked(tmp_path):
    """With every import of `rupphash_tpu` and of jax failing, every
    module of the port imports, and the scan (JPEG, PNG, WebP and a
    preview-less DNG, each with a PNG twin), a /v1/query, the CLI, the
    self-test and the web GUI (the scan route and view mode: /api/state,
    quit) run on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-c", _ALONE_CHILD], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK ")
    assert "Found 4 duplicate groups" in proc.stdout


def test_no_jax_package_import_in_port_sources():
    """No module of the port, and not chip_smoke.py, imports the JAX
    package (eagerly, lazily or through importlib)."""
    pattern = re.compile(
        r"^\s*(import rupphash_tpu(?!_torch)\b|from rupphash_tpu(?!_torch)\b)"
        r"|import_module\(\s*f?[\"']rupphash_tpu(?!_torch)\b", re.MULTILINE)
    files = [*(ROOT / "rupphash_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from rupphash_tpu.utils import trace")
    assert pattern.search("    import rupphash_tpu")
    assert not pattern.search("from rupphash_tpu_torch import device")

"""The port's CLI against rupphash_tpu's on the same directory, and the
cache shared between the two packages."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu.cache import config as cfgmod
from rupphash_tpu.cache.store import CacheStore
from rupphash_tpu.pipeline import scan as ref_scan
from rupphash_tpu_torch import cli
from rupphash_tpu_torch.pipeline import scan

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
    ours = _run("rupphash_tpu_torch", ["--no-cache", str(photos)], tmp_path)
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
    assert cli.main(["--serve", "/tmp"]) == 2
    assert "--serve is not ported" in capsys.readouterr().err
    assert cli.main(["--show-build-info"]) == 0
    out = capsys.readouterr().out
    assert '"torch"' in out and '"device": "cpu"' in out

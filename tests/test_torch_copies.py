"""The port's own copies of the JAX package's jax-free host modules,
held against the originals on the same inputs: the CLI parser and
printers, the cache (each package reads what the other wrote), decode
and luma per format, the PDQ and pHash goldens, EXIF fields and place
names, and the atomic build of the port's native library."""
import builtins
import io
import os
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu import cli as ref_cli
from rupphash_tpu.cache import config as ref_config
from rupphash_tpu.cache import store as ref_store
from rupphash_tpu.ops import pdq_ref as ref_pdq
from rupphash_tpu.ops import phash_ref as ref_phash
from rupphash_tpu.pipeline import decode as ref_decode
from rupphash_tpu.pipeline import exif as ref_exif
from rupphash_tpu.utils import geonames as ref_geonames
from rupphash_tpu_torch import cli, device
from rupphash_tpu_torch.cache import config, store
from rupphash_tpu_torch.ops import pdq_ref, phash_ref
from rupphash_tpu_torch.pipeline import decode, exif
from rupphash_tpu_torch.utils import geonames

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _textured(rng, size=(320, 240)):
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize(size, Image.BILINEAR))


# --- CLI ------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["/tmp/a", "/tmp/b"],
    ["--similarity", "12", "--pixel-hash", "--sort", "exif-date-desc", "x"],
    ["--no-cache", "--rehash-only", "--relative-times", "--rehash", "d"],
    ["--serve", "--port", "8080", "--host", "0.0.0.0", "--allow-host",
     "a.example", "--allow-host", "b", "--index-file", "i.npz", "d"],
    ["--unignore", "aa", "bb", "--prune", "5", "--show-ignored"],
    ["--delete", "--use-trash", "--3dlut", "a.cube", "b.cube",
     "--move-marked", "/m", "x"],
    ["--view", "--view-flatten", "--slideshow", "2.5", "--shuffle",
     "--raw-thumbnails", "--use-tui", "--use-gui", "--show-build-info",
     "--show-exif-tags"],
], ids=["paths", "grouping", "rehash", "serve", "cache", "delete", "view"])
def test_parser_matches_reference(argv):
    ours = vars(cli.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(ref_cli.build_parser().parse_args(argv))


def test_version_constants_match_reference():
    """The cache's algorithm byte and the version are shared, so the two
    packages accept each other's cache entries and index files."""
    import rupphash_tpu
    import rupphash_tpu_torch
    assert rupphash_tpu_torch.PDQ_ALGO_VERSION == rupphash_tpu.PDQ_ALGO_VERSION
    assert rupphash_tpu_torch.__version__ == rupphash_tpu.__version__


def _groups():
    day = 86400.0
    now = time.time()

    def rec(name, ch, res, size, age_days):
        return SimpleNamespace(path=pathlib.Path("/photos") / name,
                               content_hash=ch, resolution=res, size=size,
                               modified=now - age_days * day)

    groups = [[rec("a.png", b"1", (320, 240), 1234, 3),
               rec("a_copy.png", b"1", (320, 240), 1234, 40)],
              [rec("b.jpg", b"2", (640, 480), 2 * 1024 ** 2, 400),
               rec("b.png", b"3", None, 512, 2),
               rec("b2.png", b"3", (640, 480), 5 * 1024 ** 3, 9)],
              [rec("c.webp", b"4", (100, 80), 77, 1),
               rec("c.bmp", b"5", (100, 80), 99_999, 5)]]
    infos = [SimpleNamespace(status="all-identical", max_dist=0),
             SimpleNamespace(status="some-identical", max_dist=3),
             SimpleNamespace(status="", max_dist=17)]
    return groups, infos


@pytest.mark.parametrize("relative", [False, True])
def test_print_groups_matches_reference(capsys, relative):
    groups, infos = _groups()
    ref_cli.print_groups(groups, infos, relative)
    want = capsys.readouterr().out
    cli.print_groups(groups, infos, relative)
    assert capsys.readouterr().out == want
    assert want.count("--- Group") == 3


def test_interactive_delete_prompt_matches_reference(capsys, monkeypatch):
    """ENTER skips every group, so nothing is deleted: the prompts and
    listings of the two packages are compared."""
    monkeypatch.setattr(builtins, "input", lambda prompt="": print(prompt)
                        or "")
    groups, infos = _groups()
    ref_cli.run_interactive_delete(groups, infos, False, True)
    want = capsys.readouterr().out
    cli.run_interactive_delete(groups, infos, False, True)
    assert capsys.readouterr().out == want
    assert "Enter numbers to TRASH" in want


def test_exif_tag_list_matches_reference(capsys):
    ref_cli.show_exif_tags()
    want = capsys.readouterr().out
    cli.show_exif_tags()
    assert capsys.readouterr().out == want


# --- cache ----------------------------------------------------------------

def test_cache_directories_and_key_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    for var in ("RUPPHASH_CONFIG_DIR", "RUPPHASH_CACHE_DIR",
                "XDG_CONFIG_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    assert config.config_dir() == ref_config.config_dir()
    assert config.cache_dir() == ref_config.cache_dir()
    ours = config.load_config()          # creates the config and its key
    assert ours["_master_key_bytes"] == \
        ref_config.load_config()["_master_key_bytes"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_written_by_one_package_reads_in_the_other(tmp_path, writer):
    key = bytes(range(32))
    path = tmp_path / "cache.db"
    w_mod, r_mod = ((ref_store, store) if writer == "reference"
                    else (store, ref_store))
    w = w_mod.CacheStore(path, key)
    ch = w.content_key[:8] + b"content-hash-000000000000"[:24]
    pdq = bytes(range(32))
    coeffs = np.linspace(-3, 3, 256, dtype=np.float32)
    feats = {"width": 640, "height": 480, "gps": [28.68, -81.31],
             "tags": {"Make": "Canon"}}
    w.put_pdqhash(ch, pdq, 87)
    w.put_coefficients(ch, coeffs)
    w.put_features(ch, feats)
    w.put_pixel_hash(ch, b"p" * 32)
    mkey = w.compute_meta_key(123456789, 4242, 77)
    w.put_meta(mkey, ch)
    w.register_duplicate_groups([[(ch, pdq), (b"x" * 32, pdq)]])
    assert w.set_files_ignored([ch]) == 1
    w.close()

    r = r_mod.CacheStore(path, key)
    try:
        assert r.content_key == w.content_key
        assert r.compute_meta_key(123456789, 4242, 77) == mkey
        assert r.get_meta(mkey) == ch
        assert r.get_pdqhash(ch) == (pdq, 87)
        assert np.array_equal(r.get_coefficients(ch), coeffs)
        assert r.get_features(ch) == feats
        assert r.get_pixel_hash(ch) == b"p" * 32
        assert r.is_ignored(ch)
        assert [c for c, _ in r.list_ignored()] == [ch]
    finally:
        r.close()


# --- decode, luma, hashes ---------------------------------------------------

@pytest.mark.parametrize("fmt,suffix,kw", [
    ("PNG", "png", {}), ("JPEG", "jpg", {"quality": 90}),
    ("WEBP", "webp", {"quality": 80}), ("BMP", "bmp", {}),
    ("GIF", "gif", {}), ("TIFF", "tif", {}),
])
def test_load_image_and_luma_match_reference(tmp_path, fmt, suffix, kw):
    rng = np.random.default_rng(len(suffix) * 7 + len(fmt))
    img = _textured(rng, (700, 420))
    path = tmp_path / f"img.{suffix}"
    Image.fromarray(img).save(path, format=fmt, **kw)
    want, want_res = ref_decode.load_image(path)
    got, res = decode.load_image(path, device="cpu")
    assert res == want_res == (700, 420)
    assert np.array_equal(got, want)
    luma = decode.prepare_luma_fast(got)
    assert np.array_equal(luma, ref_decode.prepare_luma_fast(want))
    assert luma.shape == (307, 512)       # the 512-px box downsample
    data = path.read_bytes()
    assert np.array_equal(decode.sniff_decode_bytes(data, "cpu"),
                          ref_decode.sniff_decode_bytes(data))


@pytest.mark.parametrize("shape", [(64, 64), (240, 320), (530, 600)])
def test_pdq_and_phash_goldens_match_reference(shape):
    rng = np.random.default_rng(shape[0])
    img = _textured(rng, (shape[1], shape[0]))
    luma = pdq_ref.prepare_luma(img)
    assert np.array_equal(luma, ref_pdq.prepare_luma(img))
    coeffs, buf, quality = pdq_ref.pdq_from_luma(luma)
    w_coeffs, w_buf, w_quality = ref_pdq.pdq_from_luma(luma)
    assert np.array_equal(coeffs, w_coeffs) and quality == w_quality
    assert pdq_ref.dihedral_hashes(coeffs) == ref_pdq.dihedral_hashes(
        w_coeffs)
    h = phash_ref.hash_image(img)
    assert h == ref_phash.hash_image(img)
    assert phash_ref.dihedral_hashes(h) == ref_phash.dihedral_hashes(h)


# --- EXIF and place names ----------------------------------------------------

def _jpeg_with_exif(gps: bool) -> bytes:
    rng = np.random.default_rng(3)
    im = Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8))
    ex = Image.Exif()
    ex[274] = 6
    ex[271] = "Canon"
    ex[272] = "EOS"
    ex[0x8769] = {36867: "2024:03:01 10:00:00"}
    if gps:
        ex[0x8825] = {1: "N", 2: (28.0, 40.0, 48.0), 3: "W",
                      4: (81.0, 18.0, 36.0), 7: (12.0, 30.0, 0.0),
                      29: "2024:03:01"}
    buf = io.BytesIO()
    im.save(buf, format="JPEG", exif=ex)
    return buf.getvalue()


@pytest.mark.parametrize("gps", [True, False])
def test_exif_fields_match_reference(gps):
    data = _jpeg_with_exif(gps)
    feats = exif.extract(data=data)
    assert feats == ref_exif.extract(data=data)
    assert feats["orientation"] == 6 and feats["tags"]["Make"] == "Canon"
    assert exif.derive_location(feats) == ref_exif.derive_location(feats)
    assert exif.derive_sun_position(feats) == \
        ref_exif.derive_sun_position(feats)
    assert ("gps" in feats and feats["gps"] is not None) == gps


@pytest.mark.parametrize("lat,lon", [(28.68, -81.31), (48.14, 11.58),
                                     (-33.87, 151.21), (35.68, 139.69),
                                     (0.0, -160.0)])
def test_place_names_match_reference(lat, lon):
    assert geonames.derive_location(lat, lon) == \
        ref_geonames.derive_location(lat, lon)
    assert geonames.timezone_name(lat, lon) == \
        ref_geonames.timezone_name(lat, lon)


# --- native library build ------------------------------------------------------

_BUILD_CHILD = """
import sys
from pathlib import Path
sys.modules["rupphash_tpu"] = None
from rupphash_tpu_torch.native import _build
_build.BUILD_DIR = Path(sys.argv[1])
import numpy as np
from rupphash_tpu_torch import native
from rupphash_tpu_torch.ops import pdq_ref
assert native.get_lib() is not None, "native library did not build"
img = np.arange(40 * 50 * 3, dtype=np.uint8).reshape(40, 50, 3)
assert np.array_equal(native.luma601(img), pdq_ref.to_luma601(img))
print("OK")
"""


def test_native_library_builds_atomically_in_two_processes(tmp_path):
    """Two processes build the port's host library into one empty build
    directory at the same moment: both load a whole library, and only
    the finished file (and the lock) is left there."""
    build = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(build)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "OK"
    assert sorted(f.name for f in build.iterdir()) == [
        "ruppnative.so", "ruppnative.so.lock"]
    assert not (ROOT / "rupphash_tpu_torch" / "native" /
                "ruppnative.so").exists()

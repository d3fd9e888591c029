"""The port's RAW demosaic and decode routing against the JAX package's.

Tolerance: the reference demosaics in XLA, whose summation order the
port's fixed-order PyTorch stencils cannot reproduce, so the two may
differ by at most 1 u8 level, on at most 1e-4 of the output values
(measured: 0 to 20 values of 2,880,000 at 800x1200).  LinearRaw is host
numpy in both and must be identical, as must every non-RAW decode and
every RAW file decoded from its embedded preview.
"""
import io
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu.ops import demosaic as jdemosaic
from rupphash_tpu.pipeline import decode as jdecode
from rupphash_tpu.pipeline import heavy as jheavy
from rupphash_tpu.pipeline.dng import RawImage
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import demosaic
from rupphash_tpu_torch.pipeline import decode, heavy


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_dng import _scene, write_dng  # noqa: E402
from test_rawcontainers import (XTRANS, _scene14, _scene_xtrans14,  # noqa: E402
                                write_cr2, write_cr3, write_nef, write_raf)

MAX_LEVELS = 1
MAX_SHARE = 1e-4

_CFAS = {"RGGB": (0, 1, 1, 2), "BGGR": (2, 1, 1, 0), "GRBG": (1, 0, 2, 1)}
_CAMERA = np.array([[0.9, -0.3, -0.1], [-0.4, 1.2, 0.2],
                    [-0.05, 0.2, 0.6]])


def assert_close(got, want):
    assert got is not None and want is not None
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= MAX_LEVELS
    assert np.count_nonzero(diff) <= MAX_SHARE * diff.size


def _bayer_raw(cfa, matrix, h=240, w=320):
    _, mosaic = _scene(h, w, seed=11)
    return RawImage(mosaic=mosaic, cfa=np.array(cfa).reshape(2, 2),
                    black=64.0, white=60000.0,
                    as_shot_neutral=np.array([0.5, 1.0, 0.7]),
                    color_matrix=matrix)


@pytest.mark.parametrize("matrix", ["none", "srgb", "camera"])
@pytest.mark.parametrize("cfa", sorted(_CFAS))
def test_bayer_matches_reference(cfa, matrix):
    m = {"none": None, "srgb": demosaic._XYZ2SRGB, "camera": _CAMERA}[matrix]
    raw = _bayer_raw(_CFAS[cfa], m)
    assert_close(demosaic.process_raw(raw, "cpu"), jdemosaic.process_raw(raw))


def test_bayer_at_800x1200_within_tolerance():
    raw = _bayer_raw(_CFAS["RGGB"], demosaic._XYZ2SRGB, 800, 1200)
    assert_close(demosaic.process_raw(raw, "cpu"), jdemosaic.process_raw(raw))


def test_xtrans_matches_reference():
    _, mosaic = _scene_xtrans14(240, 322, seed=7)   # 322 is not 6-aligned
    raw = RawImage(mosaic=mosaic, cfa=XTRANS, black=0.0, white=16383.0,
                   as_shot_neutral=np.array([0.6, 1.0, 0.8]),
                   color_matrix=_CAMERA)
    got = demosaic.process_raw(raw, "cpu")
    assert got.shape == (240, 318, 3)
    assert_close(got, jdemosaic.process_raw(raw))


def test_linear_raw_identical():
    _, mosaic = _scene(64, 96)
    raw = RawImage(mosaic=mosaic, cfa=np.array([[0, 1], [1, 2]]),
                   black=100.0, white=50000.0, linear=True)
    assert np.array_equal(demosaic.process_raw(raw, "cpu"),
                          jdemosaic.process_raw(raw))


@pytest.mark.parametrize("case", ["cygm", "missing_blue", "not_square",
                                  "tiny", "smaller_than_cfa"])
def test_rejected_patterns_return_none(case):
    _, mosaic = _scene(64, 96)
    cfa = {"cygm": np.array([[0, 1], [3, 2]]),
           "missing_blue": np.where(XTRANS == 2, 1, XTRANS),
           "not_square": np.array([[0, 1, 1], [1, 2, 1]]),
           "tiny": np.array([[0, 1], [1, 2]]),
           "smaller_than_cfa": np.zeros((8, 8), np.int64)}[case]
    if case == "tiny":
        mosaic = mosaic[:3, :3]
    if case == "smaller_than_cfa":
        mosaic = mosaic[:6, :6]
    raw = RawImage(mosaic=mosaic, cfa=cfa, black=0.0, white=65535.0)
    assert jdemosaic.process_raw(raw) is None
    assert demosaic.process_raw(raw, "cpu") is None


@pytest.mark.parametrize("asn", [None, (0.0, 1.0, 0.0),
                                 (np.nan, 1.0, 1.0)])
def test_malformed_metadata_falls_back_like_reference(asn):
    """Missing or malformed AsShotNeutral means neutral gains; a
    singular colour matrix means no matrix."""
    _, mosaic = _scene(64, 96)
    raw = RawImage(mosaic=mosaic, cfa=np.array([[0, 1], [1, 2]]), black=0.0,
                   white=65535.0,
                   as_shot_neutral=None if asn is None else np.array(asn),
                   color_matrix=np.zeros((3, 3)))
    assert_close(demosaic.process_raw(raw, "cpu"), jdemosaic.process_raw(raw))


def _jpeg(rgb):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _raw_files():
    """Preview-less raws of every container the routing dispatches, and
    a CR3 with an embedded preview (hashed from the preview)."""
    _, m16 = _scene(240, 320, seed=11)
    rgb14, m14 = _scene14(240, 320, seed=11)
    _, mx = _scene_xtrans14(72, 96, seed=3)
    return {
        "photo.dng": write_dng(m16, cm=demosaic._XYZ2SRGB),
        "shot.cr2": write_cr2(m14, wb=(1024, 1024, 1024, 1024)),
        "shot.nef": write_nef(m14, wb=(1.0, 1.0)),
        "xtrans.raf": write_raf(mx, xtrans=XTRANS),
        "full.cr3": write_cr3(m14, wb=(1024, 1024, 1024, 1024)),
        "preview.cr3": write_cr3(m14, wb=(1024, 1024, 1024, 1024),
                                 preview_jpeg=_jpeg(rgb14)),
    }


@pytest.mark.parametrize("name", sorted(_raw_files()))
def test_load_image_matches_reference(tmp_path, name):
    data = _raw_files()[name]
    p = tmp_path / name
    p.write_bytes(data)
    img, res = decode.load_image(p, device="cpu")
    want, want_res = jdecode.load_image(p)
    assert res == want_res
    if name == "preview.cr3":
        assert np.array_equal(img, want)   # the preview, decoded by PIL
    else:
        assert_close(img, want)


def test_cr3_full_raw_prefers_the_raw_track():
    """full_raw is the reference's _full_raw: a CR3 decodes its raw
    track first, its preview only when the track fails."""
    from rupphash_tpu.pipeline import cr3

    data = _raw_files()["preview.cr3"]
    got = decode.full_raw(data, device="cpu")
    assert_close(got, cr3.decode_cr3(data, prefer_full_raw=True))
    assert not np.array_equal(got, jdecode.decode_bytes(
        cr3.parse_cr3(data)["preview"]))


@pytest.mark.parametrize("name", ["photo.dng", "xtrans.raf", "full.cr3",
                                  "preview.cr3"])
def test_sniff_decode_bytes_matches_reference(name):
    data = _raw_files()[name]
    got = decode.sniff_decode_bytes(data, device="cpu")
    want = jdecode.sniff_decode_bytes(data)
    if name == "preview.cr3":
        assert np.array_equal(got, want)
    else:
        assert_close(got, want)


def test_non_raw_formats_decode_identically(tmp_path):
    """PNG, JPEG, PDF and junk: the reference's own decoders."""
    from test_jxl_pdf import _image_obj, _jpeg_bytes, _make_pdf

    rgb, _ = _scene(64, 96)
    files = {"a.png": None, "b.jpg": _jpeg(rgb), "junk.jpg": b"\xff\xd8junk",
             "c.pdf": _make_pdf([_image_obj(96, 64, b"/DCTDecode",
                                            b"/DeviceRGB", _jpeg_bytes(rgb))])}
    Image.fromarray(rgb).save(tmp_path / "a.png")
    for name, data in files.items():
        if data is not None:
            (tmp_path / name).write_bytes(data)
        p = tmp_path / name
        got, want = (decode.load_image(p, device="cpu"), jdecode.load_image(p))
        assert got[1] == want[1]
        assert (got[0] is None and want[0] is None) or np.array_equal(*(
            g for g, _ in (got, want)))
        body = p.read_bytes()
        a = decode.sniff_decode_bytes(body, device="cpu")
        b = jdecode.sniff_decode_bytes(body)
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("name", ["a.png", "b.jpg", "photo.dng",
                                  "preview.cr3"])
def test_heavy_prepare_matches_reference(tmp_path, name):
    rgb, _ = _scene(240, 320, seed=11)
    data = {"a.png": None, "b.jpg": _jpeg(rgb)}.get(name) \
        or _raw_files().get(name)
    p = tmp_path / name
    if data is None:
        Image.fromarray(rgb).save(p)
    else:
        p.write_bytes(data)
    got = heavy.heavy_prepare(str(p), b"k" * 32, False, "cpu")
    want = jheavy.heavy_prepare(str(p), b"k" * 32, False)
    assert got.keys() == want.keys()
    assert (got["content_hash"], got["res"], got["features"]) == (
        want["content_hash"], want["res"], want["features"])
    diff = np.abs(got["luma"].astype(int) - want["luma"].astype(int))
    # luma of a raw inherits the demosaic's tolerance; the rest is exact
    assert int(diff.max()) <= (MAX_LEVELS if name == "photo.dng" else 0)

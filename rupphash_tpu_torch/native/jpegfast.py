"""Fused JPEG -> probe-luma fast path (ruppjpeg.cpp loader + gate).

The scan's hashing probe needs only (full dims, <=512px luma).  The
fused decoder (ruppjpeg.cpp) streams libjpeg scanlines straight into
the luma/box-resample accumulators, skipping the PIL image, the
PIL->numpy copy, and the separate full-resolution luma pass — ~2x
host throughput at 4 MP on one core (the reference decodes JPEG on
the host too: zune-jpeg full decode, scanner.rs:461-520).

Bit-exactness is enforced fail-closed at THREE levels:
  * build: system libjpeg headers/library absent => disabled;
  * runtime self-probe (first use, per process): a deterministic
    corpus spanning baseline/progressive, 4:4:4/4:2:2/4:2:0,
    grayscale, odd dims and the >512px resample branch is decoded by
    BOTH paths and compared bit-for-bit; any mismatch (e.g. a system
    libjpeg whose pixel output deviates from Pillow's bundled
    libjpeg-turbo) disables the fast path on this machine;
  * per stream: the C++ side rejects non-8-bit precision, CMYK/YCCK,
    and any libjpeg warning, so dirty or exotic streams always take
    the PIL path and inherit its exact behavior.

`RUPPHASH_NO_JPEGFAST=1` force-disables (escape hatch + used by the
equivalence tests to drive the slow path).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import fastpath
from .fastpath import FastLib

_HERE = Path(__file__).resolve().parent


def _configure(lib):
    lib.jpeg_luma_probe.restype = ctypes.c_int
    lib.jpeg_luma_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]


def jpeg_dims(data: bytes):
    """(width, height) from the SOF0/1/2 marker, or None for streams
    the fast path must not touch (lossless/arithmetic/hierarchical
    SOFs, 12-bit precision, component counts other than 1/3)."""
    if len(data) < 4 or data[:3] != b"\xff\xd8\xff":
        return None
    p = 2
    n = len(data)
    while p + 9 <= n:
        if data[p] != 0xFF:
            return None
        marker = data[p + 1]
        p += 2
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9 or marker == 0xDA:
            return None
        seglen = (data[p] << 8) | data[p + 1]
        if seglen < 2:
            return None
        if marker in (0xC0, 0xC1, 0xC2) and p + 9 <= n:
            prec = data[p + 2]
            h = (data[p + 3] << 8) | data[p + 4]
            w = (data[p + 5] << 8) | data[p + 6]
            nc = data[p + 7]
            if prec != 8 or nc not in (1, 3) or not (h and w):
                return None
            return (w, h)
        if marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                      0xCD, 0xCE, 0xCF):
            return None  # lossless / arithmetic / hierarchical
        p += seglen
    return None


def _decode(data: bytes, nw: int, nh: int):
    """Raw C++ call: (luma (nh, nw) u8, full (w, h)) or None."""
    lib = _FAST.get_lib()
    if lib is None:
        return None
    out = np.empty((nh, nw), dtype=np.uint8)
    fw = ctypes.c_int()
    fh = ctypes.c_int()
    rc = lib.jpeg_luma_probe(data, len(data), nw, nh, out.ctypes.data,
                             ctypes.byref(fw), ctypes.byref(fh))
    if rc != 0:
        return None
    return out, (fw.value, fh.value)


def _probe_corpus():
    import io

    from PIL import Image

    rng = np.random.default_rng(0xC0FFEE)

    def enc(arr, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", **kw)
        return buf.getvalue()

    rgb_odd = rng.integers(0, 256, (41, 67, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    big = np.asarray(
        Image.fromarray(rng.integers(0, 256, (30, 53, 3), np.uint8))
        .resize((530, 300), Image.BILINEAR))
    return [
        enc(rgb_odd, quality=88, subsampling=2),           # 4:2:0
        enc(rgb_odd, quality=76, subsampling=0,
            progressive=True),                             # prog 4:4:4
        enc(rgb_odd, quality=95, subsampling=1),           # 4:2:2
        enc(gray, quality=90),                             # grayscale
        enc(big, quality=85, subsampling=2),               # resample
    ]


def _self_probe() -> bool:
    return fastpath.self_probe_via(jpeg_dims, _decode, _probe_corpus())


_FAST = FastLib(_HERE / "ruppjpeg.cpp", "ruppjpeg.so",
                ["-ljpeg"], _configure, _self_probe,
                "RUPPHASH_NO_JPEGFAST",
                deps=[_HERE / "rupp_stream.h"])


def available() -> bool:
    """Library built AND the self-probe validated bit-equality."""
    return _FAST.available()


def probe_luma(data: bytes):
    """(luma, (w, h)) for a JPEG stream via the fused decoder, or None
    (not a clean 8-bit baseline/progressive JPEG, fast path disabled,
    dims outside the hashable/budget window) => use the PIL path.
    luma is bit-identical to decode_bytes -> prepare_luma_fast."""
    return fastpath.probe_luma_via(available, jpeg_dims, _decode, data)

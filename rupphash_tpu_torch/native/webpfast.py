"""Fused WebP -> probe-luma fast path (ruppwebp.cpp loader + gate).

Same slot as jpegfast/pngfast: the bitstream decodes once through
libwebp into packed RGB, rows reduce to luma and stream into the
box-resample sink — the PIL object, the RGBA->RGB convert copy and the
PIL->numpy copy never exist.  ~1.5x host throughput for 4 MP WebPs.

Pillow decodes WebP through the same system libwebp, and libwebp's RGB
and RGBA output modes emit identical color samples, so accepted
streams are sample-exact by construction; the runtime self-probe
(lossy/lossless x alpha/no-alpha, odd dims, the resample branch) plus
the per-stream gates (animation and any decode failure reject) keep
accept/reject behavior aligned with the PIL route.
`RUPPHASH_NO_WEBPFAST=1` force-disables.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import fastpath
from .fastpath import FastLib

_HERE = Path(__file__).resolve().parent


def _configure(lib):
    lib.webp_luma_probe.restype = ctypes.c_int
    lib.webp_luma_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.webp_dims.restype = ctypes.c_int
    lib.webp_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]


def webp_dims(data: bytes):
    """(width, height) for a decodable *still* WebP (lossy, lossless,
    or extended without animation), else None.  Pure-Python container
    peek so it works without the library too."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    p = 12
    while p + 8 <= len(data):
        fourcc = data[p:p + 4]
        size = int.from_bytes(data[p + 4:p + 8], "little")
        payload = data[p + 8:p + 8 + size]
        if fourcc == b"VP8X":
            if len(payload) < 10 or payload[0] & 0x02:  # animation
                return None
            w = int.from_bytes(payload[4:7], "little") + 1
            h = int.from_bytes(payload[7:10], "little") + 1
            return (w, h)
        if fourcc == b"VP8 ":
            # 3-byte frame tag, 9D 01 2A start code, 14-bit dims
            if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
                return None
            w = int.from_bytes(payload[6:8], "little") & 0x3FFF
            h = int.from_bytes(payload[8:10], "little") & 0x3FFF
            return (w, h) if w and h else None
        if fourcc == b"VP8L":
            if len(payload) < 5 or payload[0] != 0x2F:
                return None
            bits = int.from_bytes(payload[1:5], "little")
            return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1)
        p += 8 + size + (size & 1)  # RIFF chunks are 2-byte aligned
    return None


def _decode(data: bytes, nw: int, nh: int):
    lib = _FAST.get_lib()
    if lib is None:
        return None
    out = np.empty((nh, nw), dtype=np.uint8)
    fw = ctypes.c_int()
    fh = ctypes.c_int()
    rc = lib.webp_luma_probe(data, len(data), nw, nh, out.ctypes.data,
                             ctypes.byref(fw), ctypes.byref(fh))
    if rc != 0:
        return None
    return out, (fw.value, fh.value)


def _probe_corpus():
    import io

    from PIL import Image

    rng = np.random.default_rng(0xFADE)

    def enc(arr, mode=None, **kw):
        im = (Image.fromarray(arr) if mode is None
              else Image.fromarray(arr, mode))
        buf = io.BytesIO()
        im.save(buf, "WEBP", **kw)
        return buf.getvalue()

    smooth = np.asarray(
        Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8))
        .resize((61, 45), Image.BILINEAR))
    noise = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    rgba = np.concatenate([smooth, noise[..., :1]], axis=2)
    big = np.asarray(
        Image.fromarray(rng.integers(0, 256, (40, 70, 3), np.uint8))
        .resize((620, 355), Image.BILINEAR))
    return [
        enc(smooth, quality=80),                       # lossy VP8
        enc(noise, quality=95),                        # lossy, noisy
        enc(noise, lossless=True),                     # VP8L
        enc(rgba, "RGBA", quality=85),                 # lossy + alpha
        enc(rgba, "RGBA", lossless=True),              # lossless + alpha
        enc(big, quality=82),                          # resample branch
    ]


def _self_probe() -> bool:
    return fastpath.self_probe_via(webp_dims, _decode, _probe_corpus())


_FAST = FastLib(_HERE / "ruppwebp.cpp", "ruppwebp.so",
                ["-lwebp"], _configure, _self_probe,
                "RUPPHASH_NO_WEBPFAST",
                deps=[_HERE / "rupp_stream.h"])


def available() -> bool:
    """Library built AND the self-probe validated bit-equality."""
    return _FAST.available()


def probe_luma(data: bytes):
    """(luma, (w, h)) for a still-WebP stream via the fused decoder,
    or None (animated, fast path disabled, dims outside the
    hashable/budget window, decode failure) => use the PIL path.
    Bit-identical to decode_bytes -> prepare_luma_fast for every
    accepted stream."""
    return fastpath.probe_luma_via(available, webp_dims, _decode, data)

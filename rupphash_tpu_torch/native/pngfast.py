"""Fused PNG -> probe-luma fast path (ruppng.cpp loader + gate).

Same slot as jpegfast: IDAT inflates once through libdeflate (~2.6x
zlib on this host), rows unfilter + reduce to luma + stream into the
box-resample sink — the full RGB image and the PIL->numpy copy never
exist.  ~4x host throughput for 4 MP PNGs.

PNG is lossless so any correct decode is sample-exact; the runtime
self-probe (color types 0/2/3/4/6, all five filters via varied
content, the resample branch) plus the per-stream fail-closed gates
(8-bit non-interlaced only, critical-chunk CRCs verified like Pillow,
truncation fails) keep accept/reject behavior aligned with the PIL
route.  `RUPPHASH_NO_PNGFAST=1` force-disables.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import fastpath
from .fastpath import FastLib

_HERE = Path(__file__).resolve().parent


def _configure(lib):
    lib.png_luma_probe.restype = ctypes.c_int
    lib.png_luma_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.png_dims.restype = ctypes.c_int
    lib.png_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def png_dims(data: bytes):
    """(width, height) for the supported class (8-bit non-interlaced,
    color 0/2/3/4/6), else None.  Pure-Python IHDR peek so it works
    without the library too."""
    if len(data) < 33 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    if data[8:16] != b"\x00\x00\x00\x0dIHDR":
        return None
    w = int.from_bytes(data[16:20], "big")
    h = int.from_bytes(data[20:24], "big")
    depth, ct, comp, filt, inter = data[24:29]
    if not w or not h or depth != 8 or comp or filt or inter:
        return None
    if ct not in (0, 2, 3, 4, 6):
        return None
    return (w, h)


def _decode(data: bytes, nw: int, nh: int):
    lib = _FAST.get_lib()
    if lib is None:
        return None
    out = np.empty((nh, nw), dtype=np.uint8)
    fw = ctypes.c_int()
    fh = ctypes.c_int()
    rc = lib.png_luma_probe(data, len(data), nw, nh, out.ctypes.data,
                            ctypes.byref(fw), ctypes.byref(fh))
    if rc != 0:
        return None
    return out, (fw.value, fh.value)


def _probe_corpus():
    import io

    from PIL import Image

    rng = np.random.default_rng(0xBADCAB)

    def enc(im):
        buf = io.BytesIO()
        im.save(buf, "PNG")
        return buf.getvalue()

    out = []
    # mixed content => the encoder exercises several filter types
    noise = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    smooth = np.asarray(
        Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8))
        .resize((61, 45), Image.BILINEAR))
    out.append(enc(Image.fromarray(noise)))                    # RGB
    out.append(enc(Image.fromarray(smooth)))                   # RGB smooth
    out.append(enc(Image.fromarray(noise[..., 0])))            # gray
    rgba = np.concatenate([smooth, noise[..., :1]], axis=2)
    out.append(enc(Image.fromarray(rgba, "RGBA")))             # RGBA
    out.append(enc(Image.fromarray(smooth).convert(
        "P", palette=Image.ADAPTIVE, colors=199)))             # palette
    out.append(enc(Image.fromarray(
        np.stack([noise[..., 0], smooth[..., 1]], axis=2),
        "LA")))                                                # gray+alpha
    big = np.asarray(
        Image.fromarray(rng.integers(0, 256, (40, 70, 3), np.uint8))
        .resize((620, 355), Image.BILINEAR))
    out.append(enc(Image.fromarray(big)))                      # resample
    return out


def _self_probe() -> bool:
    return fastpath.self_probe_via(png_dims, _decode, _probe_corpus())


_FAST = FastLib(_HERE / "ruppng.cpp", "ruppng.so",
                ["-ldeflate"], _configure, _self_probe,
                "RUPPHASH_NO_PNGFAST",
                deps=[_HERE / "rupp_stream.h"])


def available() -> bool:
    """Library built AND the self-probe validated bit-equality."""
    return _FAST.available()


def probe_luma(data: bytes):
    """(luma, (w, h)) for a PNG stream via the fused decoder, or None
    => use the PIL path.  Bit-identical to decode_bytes ->
    prepare_luma_fast for every accepted stream."""
    return fastpath.probe_luma_via(available, png_dims, _decode, data)

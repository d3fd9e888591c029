"""Native host library: build-on-first-use C++ with ctypes bindings.

Compiles ruppnative.cpp with g++ the first time it is needed, atomically
into build/rupphash_tpu_torch/native/ (native/_build.py); every entry
point has a pure-Python fallback so the package works without a
toolchain.  See ruppnative.cpp for what lives here and why.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import _build

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "ruppnative.cpp"
_lock = threading.Lock()
_lib = None
_build_failed = False


def get_lib():
    """The loaded library or None (fallbacks used)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build.ensure(_SRC, "ruppnative.so", [["-O3"]])
        if so is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.hchacha20.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p]
        lib.xchacha20poly1305_seal.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p]
        lib.xchacha20poly1305_open.restype = ctypes.c_int
        lib.xchacha20poly1305_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p]
        lib.luma601.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_void_p]
        lib.box_resample_u8.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
        lib.union_find.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
        lib.lj92_decode.restype = ctypes.c_int
        lib.lj92_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.nef_decode.restype = ctypes.c_int
        lib.nef_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.arw2_decode.restype = ctypes.c_int
        lib.arw2_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.rw2_decode.restype = ctypes.c_int
        lib.rw2_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rw2_v6_decode.restype = ctypes.c_int
        lib.rw2_v6_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rw2_v7_decode.restype = ctypes.c_int
        lib.rw2_v7_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.orf_decode.restype = ctypes.c_int
        lib.orf_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.raf_decode.restype = ctypes.c_int
        lib.raf_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p]
        lib.crx_decode_plane.restype = ctypes.c_int
        lib.crx_decode_plane.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.crx_decode_plane_wavelet.restype = ctypes.c_int
        lib.crx_decode_plane_wavelet.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return _lib


def hchacha20(key: bytes, nonce16: bytes) -> bytes | None:
    if len(key) != 32 or len(nonce16) != 16:
        return None  # fall back to the asserting Python path: the C
                     # core reads fixed 32/16-byte buffers regardless
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.hchacha20(key, nonce16, out)
    return out.raw


def xchacha_seal(key: bytes, nonce24: bytes, plaintext: bytes,
                 aad: bytes) -> bytes | None:
    """XChaCha20-Poly1305 seal: ciphertext || 16-byte tag, or None when
    the native library is unavailable (caller falls back to the
    `cryptography` route in cache/crypto.py)."""
    if len(key) != 32 or len(nonce24) != 24:
        return None
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(len(plaintext) + 16)
    lib.xchacha20poly1305_seal(key, nonce24, aad, len(aad),
                               plaintext, len(plaintext), out)
    return out.raw


class NativeTagError(Exception):
    """Poly1305 tag mismatch from the native open path."""


def xchacha_open(key: bytes, nonce24: bytes, ct_and_tag: bytes,
                 aad: bytes) -> bytes | None:
    """XChaCha20-Poly1305 open.  Returns plaintext, raises
    NativeTagError on tag mismatch, or returns None when the native
    library is unavailable (fallback duty is the caller's)."""
    if len(key) != 32 or len(nonce24) != 24 or len(ct_and_tag) < 16:
        return None
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(len(ct_and_tag) - 16)
    rc = lib.xchacha20poly1305_open(key, nonce24, aad, len(aad),
                                    ct_and_tag, len(ct_and_tag), out)
    if rc != 0:
        raise NativeTagError()
    return out.raw


def luma601(img: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    if img.ndim == 2:
        return np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c not in (3, 4):
        return None  # the C loop reads p[0..2] per pixel; a 2-channel
                     # (LA) layout would read past the buffer
    src = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((h, w), dtype=np.uint8)
    lib.luma601(src.ctypes.data, h * w, c, out.ctypes.data)
    return out


def box_resample_u8(luma: np.ndarray, new_w: int, new_h: int):
    lib = get_lib()
    if lib is None:
        return None
    h, w = luma.shape
    src = np.ascontiguousarray(luma, dtype=np.uint8)
    out = np.empty((new_h, new_w), dtype=np.uint8)
    lib.box_resample_u8(src.ctypes.data, h, w, out.ctypes.data,
                        new_h, new_w)
    return out


def _sof3_dims(stream: bytes):
    """(H, W, NC) from the SOF3 marker, or None (marker walk only)."""
    p = 2
    n = len(stream)
    while p + 9 <= n:
        if stream[p] != 0xFF:
            return None
        marker = stream[p + 1]
        p += 2
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (stream[p] << 8) | stream[p + 1]
        if seglen < 2:
            return None
        if marker == 0xC3 and p + 8 <= n:
            h = (stream[p + 3] << 8) | stream[p + 4]
            w = (stream[p + 5] << 8) | stream[p + 6]
            nc = stream[p + 7]
            return (h, w, nc) if h and w and nc else None
        if marker == 0xDA:
            return None
        p += seglen
    return None


def lj92_decode(data: bytes, max_pixels: int = 512_000_000 // 4):
    """Decode a lossless-JPEG (SOF3) stream to a (h, w*ncomp) uint16
    array, or None on failure / when the library is unavailable.
    This is the tile codec of DNG Compression=7 (see pipeline/dng.py)."""
    lib = get_lib()
    if lib is None:
        return None
    # size the output from the SOF3 header when findable (a 20 MB
    # strip would otherwise allocate a 256 MB transient per call);
    # fall back to the >=1-bit/sample stream bound
    dims = _sof3_dims(data)
    if dims is not None:
        cap = min(dims[0] * dims[1] * dims[2] + 64, max_pixels)
    else:
        cap = min(max(len(data) * 8, 1 << 16), max_pixels)
    out = np.empty(cap, dtype=np.uint16)
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    rc = lib.lj92_decode(data, len(data), out.ctypes.data, cap,
                         ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(nc))
    if rc != 0:
        return None
    stride = w.value * nc.value
    return out[:h.value * stride].reshape(h.value, stride).copy()


def nef_huff_decode(data: bytes, vpred: np.ndarray, curve: np.ndarray,
                    width: int, height: int, tree: int, split: int = 0):
    """Decode a Nikon 34713 compressed strip to a (height, width) uint16
    mosaic, or None on failure / when the library is unavailable.  vpred
    is 4 uint16 seeds, curve a 0x4000-entry uint16 LUT, tree the base
    Huffman tree index (0..5), split the row where lossy streams switch
    to tree+1 (0 = never).  See ruppnative.cpp nef_decode."""
    lib = get_lib()
    if lib is None:
        return None
    vp = np.ascontiguousarray(vpred, dtype=np.uint16)
    cv = np.ascontiguousarray(curve, dtype=np.uint16)
    if vp.size != 4 or cv.size < 0x4000:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.nef_decode(data, len(data), vp.ctypes.data, cv.ctypes.data,
                        width, height, tree, split, out.ctypes.data)
    return out if rc == 0 else None


def arw2_decode(data: bytes, curve: np.ndarray, width: int, height: int,
                row_stride: int | None = None):
    """Decode a Sony ARW2 (compression 32767, 1 byte/px) stream to a
    (height, width) uint16 mosaic, or None.  curve is the 0x1000-entry
    tone-curve LUT built from SR2 tag 0x7010 knees."""
    lib = get_lib()
    if lib is None:
        return None
    cv = np.ascontiguousarray(curve, dtype=np.uint16)
    if cv.size < 0x1000:
        return None
    stride = row_stride if row_stride is not None else width
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.arw2_decode(data, len(data), cv.ctypes.data, width, height,
                         stride, out.ctypes.data)
    return out if rc == 0 else None


def rw2_decode(data: bytes, width: int, height: int):
    """Decode a Panasonic RW2 12-bit predictive bitstream to a
    (height, width) uint16 mosaic, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.rw2_decode(data, len(data), width, height,
                        out.ctypes.data)
    return out if rc == 0 else None


def rw2_v6_decode(data: bytes, width: int, height: int):
    """Decode a Panasonic RW2 RawFormat-6 cell raster (16-byte pages,
    11 pixels: 2 full 14-bit + 3 groups of scale + 10-bit deltas) to a
    (height, width) uint16 mosaic, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.rw2_v6_decode(data, len(data), width, height,
                           out.ctypes.data)
    return out if rc == 0 else None


def rw2_v7_decode(data: bytes, width: int, height: int, bps: int):
    """Decode a Panasonic RW2 RawFormat-7 raster (fixed-rate 16-byte
    blocks: 9x14-bit or 10x12-bit pixels, little-endian bit order) to
    a (height, width) uint16 mosaic, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.rw2_v7_decode(data, len(data), width, height, bps,
                           out.ctypes.data)
    return out if rc == 0 else None


def with_py_fallback(native_fn, py_fn, *args):
    """Run a native decoder; fall back to its pure-Python oracle ONLY
    when the native library is unavailable (no toolchain).  A native
    *reject* (None with the library loaded) is authoritative: the
    oracles are differential twins carrying the same fail-closed gates,
    so re-running a full pure-Python decode after a native reject would
    stall the scan for minutes per foreign bitstream on a 1-core host
    while reaching the same None."""
    out = native_fn(*args)
    if out is None and get_lib() is None:
        out = py_fn(*args)
    return out


def crx_decode_plane(data: bytes, width: int, height: int, nbits: int):
    """Decode one CRX-class raw plane (MED + adaptive Golomb-Rice) to
    a (height, width) uint16 array, or None.  Strict: out-of-range
    samples or inexact bitstream consumption reject the stream."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.crx_decode_plane(data, len(data), width, height, nbits,
                              out.ctypes.data)
    return out if rc == 0 else None


def crx_decode_plane_wavelet(data: bytes, band_sizes, width: int,
                             height: int, nbits: int, levels: int,
                             lossless: bool):
    """Decode one CRX wavelet-class (CRAW) raw plane to a
    (height, width) uint16 array, or None.  band_sizes are the
    3*levels+1 per-subband byte sizes from the mdat tile header."""
    lib = get_lib()
    if lib is None:
        return None
    bs = np.ascontiguousarray(band_sizes, dtype=np.int64)
    if bs.size != 3 * levels + 1:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.crx_decode_plane_wavelet(
        data, len(data), bs.ctypes.data, bs.size, width, height,
        nbits, levels, 1 if lossless else 0, out.ctypes.data)
    return out if rc == 0 else None


def raf_decode(data: bytes, width: int, height: int,
               xtrans: np.ndarray):
    """Decode a Fujifilm compressed RAF raster (lossless X-Trans/Bayer
    class: 'IS' header + stripe table + gradient-adaptive Golomb
    stripes) to a (height, width) uint16 mosaic, or None.  xtrans is
    the 6x6 color lattice (values 0/1/2)."""
    lib = get_lib()
    if lib is None:
        return None
    xt = np.ascontiguousarray(xtrans, dtype=np.uint8)
    if xt.shape != (6, 6):
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.raf_decode(data, len(data), width, height,
                        xt.tobytes(), out.ctypes.data)
    return out if rc == 0 else None


def orf_decode(data: bytes, width: int, height: int):
    """Decode an Olympus-compressed ORF raster to a (height, width)
    uint16 mosaic, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.orf_decode(data, len(data), width, height,
                        out.ctypes.data)
    return out if rc == 0 else None


def union_find_roots(n: int, ei: np.ndarray, ej: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    ei = np.ascontiguousarray(ei, dtype=np.int64)
    ej = np.ascontiguousarray(ej, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    lib.union_find(n, ei.ctypes.data, ej.ctypes.data, len(ei),
                   parent.ctypes.data)
    return parent

"""HEIC/HEIF decoding via the system libheif (ctypes).

The reference links libheif through the libheif-rs FFI crate
(Cargo.toml:43, SURVEY.md section 2.7); PIL in this image has no HEIF
plugin, so this module binds the C API directly:

  heif_context_alloc / read_from_memory_without_copy
  heif_context_get_primary_image_handle
  heif_decode_image (RGB interleaved, 8-bit)
  heif_image_get_plane_readonly

Orientation note: like libheif-rs, decoded pixels already have the
container's irot/imir transforms applied (scanner.rs:123-128 relies on
the same behavior).  Gated: every entry point returns None when the
library is missing.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_failed = False

# enum values from libheif's public header (stable ABI)
HEIF_COLORSPACE_RGB = 1
HEIF_CHROMA_INTERLEAVED_RGB = 10
HEIF_CHANNEL_INTERLEAVED = 10


class _HeifError(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("subcode", ctypes.c_int),
                ("message", ctypes.c_char_p)]


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL("libheif.so.1")
        except OSError:
            _failed = True
            return None
        lib.heif_context_alloc.restype = ctypes.c_void_p
        lib.heif_context_read_from_memory_without_copy.restype = _HeifError
        lib.heif_context_read_from_memory_without_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p]
        lib.heif_context_get_primary_image_handle.restype = _HeifError
        lib.heif_context_get_primary_image_handle.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.heif_image_handle_get_width.restype = ctypes.c_int
        lib.heif_image_handle_get_width.argtypes = [ctypes.c_void_p]
        lib.heif_image_handle_get_height.restype = ctypes.c_int
        lib.heif_image_handle_get_height.argtypes = [ctypes.c_void_p]
        lib.heif_decode_image.restype = _HeifError
        lib.heif_decode_image.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.heif_image_get_plane_readonly.restype = \
            ctypes.POINTER(ctypes.c_uint8)
        lib.heif_image_get_plane_readonly.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.heif_image_release.argtypes = [ctypes.c_void_p]
        lib.heif_image_handle_release.argtypes = [ctypes.c_void_p]
        lib.heif_context_free.argtypes = [ctypes.c_void_p]
        try:
            lib.heif_get_version.restype = ctypes.c_char_p
        except AttributeError:
            pass
        _lib = lib
        return _lib


def version() -> str | None:
    lib = _load()
    if lib is None:
        return None
    try:
        return lib.heif_get_version().decode()
    except Exception:
        return None


def encode_heif_file(rgb: np.ndarray, path: str) -> bool:
    """Encode an (H, W, 3) uint8 array to a HEIC file.  Test support:
    lets the suite build real HEIC fixtures when an HEVC encoder plugin
    is present.  Returns False when encoding is unavailable."""
    lib = _load()
    if lib is None:
        return False
    try:
        lib.heif_context_get_encoder_for_format.restype = _HeifError
        lib.heif_context_get_encoder_for_format.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        lib.heif_image_create.restype = _HeifError
        lib.heif_image_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.heif_image_add_plane.restype = _HeifError
        lib.heif_image_add_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.heif_image_get_plane.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.heif_image_get_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.heif_context_encode_image.restype = _HeifError
        lib.heif_context_encode_image.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.heif_context_write_to_file.restype = _HeifError
        lib.heif_context_write_to_file.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.heif_encoder_release.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return False

    h, w = rgb.shape[:2]
    ctx = lib.heif_context_alloc()
    enc = ctypes.c_void_p()
    img = ctypes.c_void_p()
    handle = ctypes.c_void_p()
    try:
        if lib.heif_context_get_encoder_for_format(
                ctx, 1, ctypes.byref(enc)).code != 0:  # HEVC
            return False
        if lib.heif_image_create(w, h, HEIF_COLORSPACE_RGB,
                                 HEIF_CHROMA_INTERLEAVED_RGB,
                                 ctypes.byref(img)).code != 0:
            return False
        if lib.heif_image_add_plane(img, HEIF_CHANNEL_INTERLEAVED,
                                    w, h, 24).code != 0:
            return False
        stride = ctypes.c_int()
        plane = lib.heif_image_get_plane(img, HEIF_CHANNEL_INTERLEAVED,
                                         ctypes.byref(stride))
        s = stride.value
        dst = np.ctypeslib.as_array(plane, shape=(h, s))
        src = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(h, w * 3)
        dst[:, :w * 3] = src
        if lib.heif_context_encode_image(ctx, img, enc, None,
                                         ctypes.byref(handle)).code != 0:
            return False
        return lib.heif_context_write_to_file(
            ctx, str(path).encode()).code == 0
    finally:
        if handle:
            lib.heif_image_handle_release(handle)
        if img:
            lib.heif_image_release(img)
        if enc:
            lib.heif_encoder_release(enc)
        lib.heif_context_free(ctx)


def decode_heif(data: bytes) -> np.ndarray | None:
    """Decode HEIC/HEIF/AVIF-in-HEIF bytes to an (H, W, 3) uint8 array,
    or None when libheif is unavailable or the decode fails."""
    lib = _load()
    if lib is None:
        return None
    ctx = lib.heif_context_alloc()
    if not ctx:
        return None
    handle = ctypes.c_void_p()
    img = ctypes.c_void_p()
    try:
        buf = ctypes.create_string_buffer(data, len(data))
        err = lib.heif_context_read_from_memory_without_copy(
            ctx, buf, len(data), None)
        if err.code != 0:
            return None
        err = lib.heif_context_get_primary_image_handle(
            ctx, ctypes.byref(handle))
        if err.code != 0 or not handle:
            return None
        w = lib.heif_image_handle_get_width(handle)
        h = lib.heif_image_handle_get_height(handle)
        if w <= 0 or h <= 0 or w * h > 512_000_000 // 4:
            return None
        err = lib.heif_decode_image(handle, ctypes.byref(img),
                                    HEIF_COLORSPACE_RGB,
                                    HEIF_CHROMA_INTERLEAVED_RGB, None)
        if err.code != 0 or not img:
            return None
        stride = ctypes.c_int()
        plane = lib.heif_image_get_plane_readonly(
            img, HEIF_CHANNEL_INTERLEAVED, ctypes.byref(stride))
        if not plane:
            return None
        s = stride.value
        raw = np.ctypeslib.as_array(plane, shape=(h, s))
        return raw[:, :w * 3].reshape(h, w, 3).copy()
    finally:
        if img:
            lib.heif_image_release(img)
        if handle:
            lib.heif_image_handle_release(handle)
        lib.heif_context_free(ctx)

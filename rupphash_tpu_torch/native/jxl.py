"""JPEG XL decoding via the system libjxl (ctypes).

The reference decodes JXL through the jxl-oxide crate
(scanner.rs:553-581); PIL in this image has no JXL plugin, so this
module binds libjxl's stable C API directly:

  JxlDecoderCreate / SetInput / SubscribeEvents / ProcessInput
  JxlDecoderGetBasicInfo / ImageOutBufferSize / SetImageOutBuffer

An encoder entry point exists purely so the test suite can build real
.jxl fixtures (lossless, so decode round-trips bit-exactly).  Gated:
every entry point returns None/False when the library is missing.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_failed = False

# jxl/decode.h JxlDecoderStatus (stable values)
JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_NEED_MORE_INPUT = 2
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_FULL_IMAGE = 0x1000

# jxl/types.h (libjxl 0.7)
JXL_TYPE_UINT8 = 2
JXL_NATIVE_ENDIAN = 0

JXL_ENC_SUCCESS = 0
JXL_ENC_NEED_MORE_OUTPUT = 2


class _PixelFormat(ctypes.Structure):
    _fields_ = [("num_channels", ctypes.c_uint32),
                ("data_type", ctypes.c_int),
                ("endianness", ctypes.c_int),
                ("align", ctypes.c_size_t)]


class _PreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", ctypes.c_uint32), ("ysize", ctypes.c_uint32)]


class _AnimationHeader(ctypes.Structure):
    _fields_ = [("tps_numerator", ctypes.c_uint32),
                ("tps_denominator", ctypes.c_uint32),
                ("num_loops", ctypes.c_uint32),
                ("have_timecodes", ctypes.c_int32)]


class _BasicInfo(ctypes.Structure):
    # jxl/codestream_header.h (libjxl 0.7 layout; trailing padding keeps
    # this at least as large as the library's struct)
    _fields_ = [
        ("have_container", ctypes.c_int32),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int32),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int32),
        ("have_preview", ctypes.c_int32),
        ("have_animation", ctypes.c_int32),
        ("orientation", ctypes.c_int),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int32),
        ("preview", _PreviewHeader),
        ("animation", _AnimationHeader),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 100),
    ]


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib = None
        # sonames across distro generations, then the linker's own
        # resolution (covers 0.8-0.11 without a -dev symlink)
        import ctypes.util as _cu
        candidates = ["libjxl.so.0.7", "libjxl.so.0.8", "libjxl.so.0.9",
                      "libjxl.so.0.10", "libjxl.so.0.11", "libjxl.so"]
        found = _cu.find_library("jxl")
        if found:
            candidates.insert(0, found)
        for name in candidates:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        if lib is None:
            _failed = True
            return None
        lib.JxlDecoderCreate.restype = ctypes.c_void_p
        lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderSubscribeEvents.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.JxlDecoderSetInput.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.JxlDecoderProcessInput.restype = ctypes.c_int
        lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderGetBasicInfo.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_BasicInfo)]
        lib.JxlDecoderImageOutBufferSize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.JxlDecoderSetImageOutBuffer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
            ctypes.c_void_p, ctypes.c_size_t]
        try:
            lib.JxlDecoderVersion.restype = ctypes.c_uint32
        except AttributeError:
            pass
        _lib = lib
        return _lib


def version() -> str | None:
    lib = _load()
    if lib is None:
        return None
    try:
        v = lib.JxlDecoderVersion()
        return f"{v // 1_000_000}.{v // 1000 % 1000}.{v % 1000}"
    except Exception:
        return None


def decode_jxl(data: bytes) -> np.ndarray | None:
    """Decode JXL bytes to (H, W, 3|4) uint8, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        return None
    try:
        if lib.JxlDecoderSubscribeEvents(
                dec, JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE) != 0:
            return None
        buf = ctypes.create_string_buffer(data, len(data))
        if lib.JxlDecoderSetInput(dec, buf, len(data)) != 0:
            return None
        info = _BasicInfo()
        fmt = _PixelFormat(3, JXL_TYPE_UINT8, JXL_NATIVE_ENDIAN, 0)
        out = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, ctypes.byref(info)) != 0:
                    return None
                if (info.xsize == 0 or info.ysize == 0
                        or info.xsize * info.ysize > 512_000_000 // 4):
                    return None
                if info.alpha_bits:
                    fmt.num_channels = 4
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                size = ctypes.c_size_t()
                if lib.JxlDecoderImageOutBufferSize(
                        dec, ctypes.byref(fmt), ctypes.byref(size)) != 0:
                    return None
                out = np.empty(size.value, dtype=np.uint8)
                if lib.JxlDecoderSetImageOutBuffer(
                        dec, ctypes.byref(fmt),
                        out.ctypes.data_as(ctypes.c_void_p),
                        size.value) != 0:
                    return None
            elif status in (JXL_DEC_FULL_IMAGE, JXL_DEC_SUCCESS):
                if out is None:
                    return None
                return out.reshape(info.ysize, info.xsize,
                                   fmt.num_channels)
            else:  # ERROR / NEED_MORE_INPUT on complete data
                return None
    finally:
        lib.JxlDecoderDestroy(dec)


def encode_jxl(rgb: np.ndarray) -> bytes | None:
    """Losslessly encode (H, W, 3) uint8 to JXL bytes.  Test support
    (fixture generation); returns None when the encoder is missing."""
    lib = _load()
    if lib is None:
        return None
    try:
        lib.JxlEncoderCreate.restype = ctypes.c_void_p
        lib.JxlEncoderCreate.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderDestroy.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderInitBasicInfo.argtypes = [ctypes.POINTER(_BasicInfo)]
        lib.JxlEncoderSetBasicInfo.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_BasicInfo)]
        lib.JxlEncoderCloseInput.argtypes = [ctypes.c_void_p]
        lib.JxlEncoderProcessOutput.restype = ctypes.c_int
        lib.JxlEncoderProcessOutput.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
    except AttributeError:
        return None
    try:
        make_opts = lib.JxlEncoderFrameSettingsCreate
        set_lossless = lib.JxlEncoderSetFrameLossless
    except AttributeError:
        try:
            make_opts = lib.JxlEncoderOptionsCreate
            set_lossless = lib.JxlEncoderOptionsSetLossless
        except AttributeError:
            return None
    make_opts.restype = ctypes.c_void_p
    make_opts.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    set_lossless.argtypes = [ctypes.c_void_p, ctypes.c_int]
    try:
        add_frame = lib.JxlEncoderAddImageFrame
    except AttributeError:
        return None
    add_frame.argtypes = [ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
                          ctypes.c_void_p, ctypes.c_size_t]

    h, w = rgb.shape[:2]
    enc = lib.JxlEncoderCreate(None)
    if not enc:
        return None
    try:
        info = _BasicInfo()
        lib.JxlEncoderInitBasicInfo(ctypes.byref(info))
        info.xsize, info.ysize = w, h
        info.bits_per_sample = 8
        info.num_color_channels = 3
        info.uses_original_profile = 1  # required for lossless
        if lib.JxlEncoderSetBasicInfo(enc, ctypes.byref(info)) != 0:
            return None
        try:
            color = (ctypes.c_uint8 * 256)()  # >= sizeof(JxlColorEncoding)
            lib.JxlColorEncodingSetToSRGB.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            lib.JxlColorEncodingSetToSRGB(ctypes.byref(color), 0)
            lib.JxlEncoderSetColorEncoding.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p]
            if lib.JxlEncoderSetColorEncoding(
                    enc, ctypes.byref(color)) != 0:
                return None
        except AttributeError:
            pass
        opts = make_opts(enc, None)
        if not opts:
            return None
        set_lossless(opts, 1)
        fmt = _PixelFormat(3, JXL_TYPE_UINT8, JXL_NATIVE_ENDIAN, 0)
        pixels = np.ascontiguousarray(rgb, dtype=np.uint8)
        if add_frame(opts, ctypes.byref(fmt),
                     pixels.ctypes.data_as(ctypes.c_void_p),
                     pixels.nbytes) != 0:
            return None
        lib.JxlEncoderCloseInput(enc)
        chunks = []
        while True:
            cap = 1 << 20
            chunk = (ctypes.c_uint8 * cap)()
            next_out = ctypes.cast(chunk,
                                   ctypes.POINTER(ctypes.c_uint8))
            avail = ctypes.c_size_t(cap)
            status = lib.JxlEncoderProcessOutput(
                enc, ctypes.byref(next_out), ctypes.byref(avail))
            chunks.append(bytes(chunk)[:cap - avail.value])
            if status == JXL_ENC_SUCCESS:
                return b"".join(chunks)
            if status != JXL_ENC_NEED_MORE_OUTPUT:
                return None
    finally:
        lib.JxlEncoderDestroy(enc)

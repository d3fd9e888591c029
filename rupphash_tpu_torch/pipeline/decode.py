"""Tiered image decoding for the hash pipeline, with the port's RAW route.

A copy of rupphash_tpu/pipeline/decode.py (PIL with a per-open pixel
budget; a RAW container's largest embedded JPEG preview; HEIF, JXL and
PDF through their own decoders; per-file failures return None), merged
with the port's routing of preview-less raws.  The rendition order is
the reference's: a RAW container's largest embedded preview first, the
full demosaic only for preview-less raws (and for CR3 the preview/full
order of `cr3.decode_cr3`).  The full raw is built from the jax-free
parsers (`dng.parse_dng`, `rawcontainers.parse_raw_container`,
`cr3.parse_cr3`) followed by the port's `ops/demosaic.process_raw` on
the caller's `device`: a spawned decode worker passes "cpu"; the main
process and the GUI's request threads take the default, the process's
device.

Outputs are numpy arrays: RGB (H, W, 3), RGBA (H, W, 4) or L (H, W),
always uint8, plus the original resolution.  This module imports no
torch; the demosaic's module is imported when a preview-less raw first
needs it.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np

from . import cr3, dng, rawcontainers

RAW_EXTS = {"nef", "dng", "cr2", "cr3", "arw", "orf", "rw2", "raf",
            "kdc", "dcr", "pef", "x3f", "srf", "3fr"}  # scanner.rs:43-46

IMAGE_EXTS = {
    "dds", "exr", "ff", "hdr", "ico", "pnm", "qoi", "gif", "jpg", "jpeg",
    "png", "webp", "bmp", "tiff", "tif", "avif", "heic", "heif", "tga",
    "pbm", "jp2", "j2k", "xbm", "xpm", "ora", "otb", "pcx", "sgi", "wbmp",
    "jxl", "pdf",
} | RAW_EXTS  # scanner.rs:2271-2289

MAX_PIXELS = 512_000_000 // 4  # generous per-decode budget


def is_image_ext(path: str | os.PathLike) -> bool:
    ext = Path(path).suffix.lower().lstrip(".")
    return ext in IMAGE_EXTS


def is_raw_ext(path: str | os.PathLike) -> bool:
    return Path(path).suffix.lower().lstrip(".") in RAW_EXTS


def _pil_to_array(im) -> np.ndarray:
    if im.mode in ("RGB", "L"):
        return np.asarray(im)
    if im.mode == "RGBA":
        return np.asarray(im)
    if im.mode in ("P", "PA", "CMYK", "YCbCr", "LAB", "HSV", "1"):
        return np.asarray(im.convert("RGB"))
    if im.mode in ("I;16", "I;16B", "I;16L", "I", "F"):
        arr = np.asarray(im, dtype=np.float32)
        hi = arr.max() if arr.size else 1.0
        scale = 255.0 / hi if hi > 255 else 1.0
        return np.clip(arr * scale, 0, 255).astype(np.uint8)
    if im.mode == "LA":
        return np.asarray(im.convert("RGBA"))
    return np.asarray(im.convert("RGB"))


def decode_bytes(data: bytes) -> np.ndarray | None:
    """Decode an in-memory image with PIL; None on failure."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            if im.width * im.height > MAX_PIXELS:
                return None
            im.load()
            return _pil_to_array(im)
    except Exception:
        return None


def _jpeg_spans(data: bytes, min_bytes: int = 4096):
    """Candidate embedded-JPEG spans [(length, start, end)], longest
    first, capped at 32."""
    # real JPEG streams follow SOI with APPn/DQT/SOF/COM — filtering on
    # the 4th byte discards the FFD8FF triples that occur by chance in
    # compressed raw payloads (~once per 16 MB), so ALL markers can be
    # scanned and the decode-attempt cap spent on plausible spans (a
    # position cap used to miss previews located after the mosaic data)
    _plausible = {0xC0, 0xC2, 0xC4, 0xDB, 0xE0, 0xE1, 0xE2, 0xEE, 0xFE}
    start = 0
    candidates = []
    while True:
        i = data.find(b"\xff\xd8\xff", start)
        if i < 0:
            break
        if i + 3 < len(data) and data[i + 3] in _plausible:
            candidates.append(i)
        start = i + 3
    spans = []
    for i in candidates:
        end = data.rfind(b"\xff\xd9", i)
        if end >= 0 and end - i >= min_bytes:
            spans.append((end - i, i, end))
    spans.sort(reverse=True)  # longest spans first
    return spans[:32]


def _ranked_jpeg_spans(data: bytes, min_bytes: int = 4096):
    """Spans ordered by SOF pixel count (desc, ties keep longest-first
    order), or None when any span's header fails the cheap parse — the
    caller must then fall back to decode-and-compare."""
    from ..native.jpegfast import jpeg_dims

    spans = _jpeg_spans(data, min_bytes)
    if not spans:
        return []
    ranked = []
    for _, i, end in spans:
        # bounded slice: only the marker walk is needed, and headers
        # (EXIF/XMP/MPF APPn runs) fit well inside 256 KiB; a span
        # whose SOF lies deeper parses as None => legacy path
        dims = jpeg_dims(data[i:min(end + 2, i + (256 << 10))])
        if dims is None:
            return None
        ranked.append((dims[0] * dims[1], i, end))
    ranked.sort(key=lambda t: -t[0])  # stable: ties stay longest-first
    return ranked


def extract_largest_jpeg(data: bytes, min_bytes: int = 4096):
    """Carve the largest embedded JPEG stream from a RAW container.

    Scans for SOI (FFD8FF) markers; RAW files typically embed a
    full-size preview JPEG that the reference hashes instead of
    demosaicing (scanner.rs:1353-1380).  Selection is by SOF pixel
    count so only the winning span is decoded; if any header resists
    the cheap parse, every span is decoded and compared.
    """
    ranked = _ranked_jpeg_spans(data, min_bytes)
    if ranked is not None:
        # decode dims == SOF dims, so the first successful decode in
        # pixel order IS the max over all successful decodes
        for _, i, end in ranked:
            img = decode_bytes(data[i:end + 2])
            if img is not None:
                return img
        return None
    best = None
    best_pixels = 0
    for _, i, end in _jpeg_spans(data, min_bytes):
        img = decode_bytes(data[i:end + 2])
        if img is not None:
            px = img.shape[0] * img.shape[1]
            if px > best_pixels:
                best, best_pixels = img, px
    return best


def probe_luma_raw_preview(data: bytes):
    """(luma, (w, h)) for a RAW container's largest embedded preview
    via the fused JPEG probe, or None => take the load_image path.
    Only offered when every candidate span's header parses (so the
    span chosen here is the same one extract_largest_jpeg would pick)
    and the winning span probe-decodes cleanly."""
    from ..native import jpegfast

    if not jpegfast.available():
        return None
    ranked = _ranked_jpeg_spans(data)
    if not ranked:
        return None
    _, i, end = ranked[0]
    return jpegfast.probe_luma(data[i:end + 2])


def prepare_luma_fast(img: np.ndarray):
    """Luma + conditional 512px box downsample via the native library
    when built (bit-exact vs the golden); falls back to
    ops.pdq_ref.prepare_luma."""
    from .. import native
    from ..ops import pdq_ref

    h, w = img.shape[:2]
    if w < pdq_ref.MIN_HASHABLE_DIM or h < pdq_ref.MIN_HASHABLE_DIM:
        return None
    if native.get_lib() is None:
        return pdq_ref.prepare_luma(img)
    luma = native.luma601(img)
    if w > pdq_ref.DOWNSAMPLE_DIMS or h > pdq_ref.DOWNSAMPLE_DIMS:
        new_w, new_h = pdq_ref.calculate_target_dimensions(
            w, h, pdq_ref.DOWNSAMPLE_DIMS)
        luma = native.box_resample_u8(luma, new_w, new_h)
    return luma


# ---------------------------------------------------------------------------
# The port's RAW route: jax-free parsers + ops/demosaic.process_raw(device)
# ---------------------------------------------------------------------------

def _demosaic(raw, device) -> np.ndarray | None:
    if raw is None:
        return None
    from ..ops import demosaic
    return demosaic.process_raw(raw, device)


def _parse_tiff_raw(data: bytes):
    """RawImage of a TIFF-based raw (DNG, else CR2/NEF/RAF/RW2/ORF/
    TIFF-EP), or None.  Malformed containers are per-file failures, as
    in the reference; only the parsing is guarded, so a device error in
    the demosaic raises."""
    try:
        if dng.is_dng(data):
            return dng.parse_dng(data)
        return rawcontainers.parse_raw_container(data)
    except Exception:
        return None


def _decode_cr3(data: bytes, device, prefer_full_raw: bool):
    """cr3.decode_cr3 with the demosaic on `device`: preview first, the
    full raw when preview-less; the other way round when
    prefer_full_raw."""
    try:
        parsed = cr3.parse_cr3(data)
    except Exception:
        return None
    if parsed is None:
        return None

    def full():
        return _demosaic(parsed["raw"], device)

    def preview():
        return decode_bytes(parsed["preview"]) if parsed["preview"] \
            else None

    first, second = (full, preview) if prefer_full_raw else (preview, full)
    img = first()
    return img if img is not None else second()


def full_raw(data: bytes, device) -> np.ndarray | None:
    """The reference's `_full_raw` (its load_image): the native raw
    pipeline; CR3 tries its full raw before its preview."""
    if cr3.is_cr3(data):
        return _decode_cr3(data, device, prefer_full_raw=True)
    return _demosaic(_parse_tiff_raw(data), device)


def sniff_decode_bytes(data: bytes, device) -> np.ndarray | None:
    """Decode bytes of unknown/unreliable extension by content sniffing:
    PIL, JPEG carve, HEIC/JXL, TIFF raws (preview, then full demosaic),
    RAF, CR3, PDF; the reference's order.  Used by the generic
    load_image branch and by the service (bytes with no filename)."""
    img = decode_bytes(data)
    if img is None and len(data) > 8 and data[:2] == b"\xff\xd8":
        img = extract_largest_jpeg(data)
    if img is None and b"ftyp" in data[:32]:
        # any ISO-BMFF brand: HEIC/HEIF/AVIF via libheif, then
        # container-format JXL (00 00 00 0C 'JXL ')
        from ..native import heif, jxl
        img = heif.decode_heif(data)
        if img is None:
            img = jxl.decode_jxl(data)
    if img is None and data[:2] == b"\xff\x0a":
        from ..native import jxl
        img = jxl.decode_jxl(data)
    if img is None and data[:2] in (b"II", b"MM"):
        # TIFF container: embedded preview first (what the scanner
        # indexes), full demosaic only for preview-less raws
        img = extract_largest_jpeg(data)
        if img is None:
            img = _demosaic(_parse_tiff_raw(data), device)
    if img is None and data[:16] == b"FUJIFILMCCD-RAW ":
        img = _demosaic(_parse_tiff_raw(data), device)
    if img is None and cr3.is_cr3(data):
        img = _decode_cr3(data, device, prefer_full_raw=False)
    if img is None and b"%PDF" in data[:1024]:
        # readers tolerate preamble bytes before the header; embedded
        # photo first, else rasterize the vector page
        from . import pdfimg, pdfraster
        pdf = data[data.index(b"%PDF"):]
        img = pdfimg.extract_largest_pdf_image(pdf)
        if img is None:
            img = pdfraster.rasterize_first_page(pdf)
    return img


def load_image(path: str | os.PathLike, data: bytes | None = None,
               prefer_full_raw: bool = False, *, device=None):
    """(array, (width, height)) or (None, None), as the reference's
    load_image: a RAW file's preview first and the full demosaic only
    for preview-less raws, or with `prefer_full_raw` (the GUI's quality
    mode) the full demosaic first.  The demosaic runs on `device`
    (default: the process's device, device.get())."""
    p = Path(path)
    if data is None:
        try:
            data = p.read_bytes()
        except OSError:
            return None, None
    ext = p.suffix.lower().lstrip(".")
    if is_raw_ext(p):
        img = full_raw(data, device) if prefer_full_raw else None
        if img is None:
            img = extract_largest_jpeg(data)
        if img is None and not prefer_full_raw:
            # preview-less raw: parse + the port's demosaic
            img = full_raw(data, device)
        if img is None:
            img = decode_bytes(data)  # DNG sometimes decodes directly
    elif ext in ("heic", "heif"):
        from ..native import heif
        img = heif.decode_heif(data)
        if img is None:
            img = decode_bytes(data)  # PIL may have a plugin
    elif ext == "jxl":
        from ..native import jxl
        img = jxl.decode_jxl(data)
        if img is None:
            img = decode_bytes(data)  # PIL may have a plugin
    elif ext == "pdf":
        from . import pdfimg, pdfraster
        img = pdfimg.extract_largest_pdf_image(data)
        if img is None:
            # vector-only PDF: render page 1 (scanner.rs:583-626)
            img = pdfraster.rasterize_first_page(data)
    else:
        img = sniff_decode_bytes(data, device)
    if img is None:
        return None, None
    h, w = img.shape[:2]
    return img, (w, h)

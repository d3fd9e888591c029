"""Decode routing of the port: RAW files demosaic without jax.

Counterpart of rupphash_tpu/pipeline/decode.py's `load_image` and
`sniff_decode_bytes`.  The rendition order is the reference's: a RAW
container's largest embedded preview first, the full demosaic only for
preview-less raws (and for CR3 the preview/full order of
`cr3.decode_cr3`).  The full raw is built from the reference's jax-free
parsers (`dng.parse_dng`, `rawcontainers.parse_raw_container`,
`cr3.parse_cr3`) followed by the port's `ops/demosaic.process_raw`; the
reference's own `decode_dng`/`decode_raw_container`/`decode_cr3` would
import its jax demosaic.  Every other format is decoded by the
reference module's functions.

`device` is the caller's choice and is passed down to the demosaic: a
spawned decode worker passes "cpu", the main process its own device.
This module imports no torch; the demosaic's module is imported when a
preview-less raw first needs it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from rupphash_tpu.pipeline import cr3, dng, rawcontainers
from rupphash_tpu.pipeline import decode as ref


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
    """cr3.decode_cr3 with the port's demosaic: preview first, the full
    raw when preview-less; the other way round when prefer_full_raw."""
    try:
        parsed = cr3.parse_cr3(data)
    except Exception:
        return None
    if parsed is None:
        return None

    def full():
        return _demosaic(parsed["raw"], device)

    def preview():
        return ref.decode_bytes(parsed["preview"]) if parsed["preview"] \
            else None

    first, second = (full, preview) if prefer_full_raw else (preview, full)
    img = first()
    return img if img is not None else second()


def full_raw(data: bytes, device) -> np.ndarray | None:
    """The reference's `_full_raw` (load_image :276-286): the native
    raw pipeline; CR3 tries its full raw before its preview."""
    if cr3.is_cr3(data):
        return _decode_cr3(data, device, prefer_full_raw=True)
    return _demosaic(_parse_tiff_raw(data), device)


def sniff_decode_bytes(data: bytes, device) -> np.ndarray | None:
    """Decode bytes with no reliable extension by content: PIL, JPEG
    carve, HEIC/JXL, TIFF raws (preview, then full demosaic), RAF, CR3,
    PDF; the reference's order (decode.py:179-233)."""
    img = ref.decode_bytes(data)
    if img is None and len(data) > 8 and data[:2] == b"\xff\xd8":
        img = ref.extract_largest_jpeg(data)
    if img is None and b"ftyp" in data[:32]:
        from rupphash_tpu.native import heif, jxl
        img = heif.decode_heif(data)
        if img is None:
            img = jxl.decode_jxl(data)
    if img is None and data[:2] == b"\xff\x0a":
        from rupphash_tpu.native import jxl
        img = jxl.decode_jxl(data)
    if img is None and data[:2] in (b"II", b"MM"):
        img = ref.extract_largest_jpeg(data)
        if img is None:
            img = _demosaic(_parse_tiff_raw(data), device)
    if img is None and data[:16] == b"FUJIFILMCCD-RAW ":
        img = _demosaic(_parse_tiff_raw(data), device)
    if img is None and cr3.is_cr3(data):
        img = _decode_cr3(data, device, prefer_full_raw=False)
    if img is None and b"%PDF" in data[:1024]:
        from rupphash_tpu.pipeline import pdfimg, pdfraster
        pdf = data[data.index(b"%PDF"):]
        img = pdfimg.extract_largest_pdf_image(pdf)
        if img is None:
            img = pdfraster.rasterize_first_page(pdf)
    return img


def load_image(path: str | os.PathLike, data: bytes | None = None, *,
               device):
    """(array, (width, height)) or (None, None), as the reference's
    load_image with its default rendition (a RAW file's preview first);
    RAW files go through the port's full-raw route, HEIF, JXL and PDF
    files through the reference's own branches."""
    p = Path(path)
    if data is None:
        try:
            data = p.read_bytes()
        except OSError:
            return None, None
    ext = p.suffix.lower().lstrip(".")
    if ext in ("heic", "heif", "jxl", "pdf"):
        return ref.load_image(p, data=data)
    if ref.is_raw_ext(p):
        img = ref.extract_largest_jpeg(data)
        if img is None:
            # preview-less raw: parse + the port's demosaic
            img = full_raw(data, device)
        if img is None:
            img = ref.decode_bytes(data)  # DNG sometimes decodes directly
    else:
        img = sniff_decode_bytes(data, device)
    if img is None:
        return None, None
    h, w = img.shape[:2]
    return img, (w, h)

"""PDF image extraction for the hash pipeline.

The reference rasterizes the first PDF page at 2x on a white background
with the hayro crate (scanner.rs:583-626).  No PDF rasterizer exists in
this image (no poppler-glib/cpp, no mupdf, no ghostscript), so this
module recovers the *largest embedded raster image* instead — for the
duplicate-detection use case (photo scans, image-wrapped PDFs) that is
the content the page renders anyway.  Pure-vector PDFs yield None and
are skipped per-file like any other undecodable input
(scanner.rs:1488-1492).

Supported XObject streams: DCTDecode (JPEG), JPXDecode (JPEG 2000 via
PIL/openjpeg), FlateDecode with optional PNG predictors for 8-bit
DeviceGray/DeviceRGB rasters.  Image streams are always top-level PDF
objects (streams cannot live inside object streams, PDF 32000-1 §7.5.7)
so a raw byte scan finds them even in xref-compressed files.
"""

from __future__ import annotations

import re
import zlib

import numpy as np

_OBJ_RE = re.compile(rb"\bobj\b(.{0,2048}?)stream(?:\r\n|\n|\r)", re.DOTALL)
_NUM_KEY = {
    b"Width": re.compile(rb"/Width\s+(\d+)"),
    b"Height": re.compile(rb"/Height\s+(\d+)"),
    b"Bits": re.compile(rb"/BitsPerComponent\s+(\d+)"),
    b"Predictor": re.compile(rb"/Predictor\s+(\d+)"),
    b"Colors": re.compile(rb"/Colors\s+(\d+)"),
    b"Columns": re.compile(rb"/Columns\s+(\d+)"),
    b"Length": re.compile(rb"/Length\s+(\d+)\b(?!\s+\d+\s+R)"),
}


def _png_unpredict(raw: bytes, columns: int, colors: int) -> bytes | None:
    """Reverse PNG row predictors (PDF 32000-1 §7.4.4.4, 8-bit only)."""
    stride = columns * colors
    if stride <= 0 or len(raw) % (stride + 1):
        return None
    rows = len(raw) // (stride + 1)
    out = np.zeros((rows, stride), dtype=np.uint8)
    raw_arr = np.frombuffer(raw, dtype=np.uint8).reshape(rows, stride + 1)
    prev = np.zeros(stride, dtype=np.uint8)
    bpp = colors
    for r in range(rows):
        ftype = raw_arr[r, 0]
        line = raw_arr[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (
                    b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            return None
        out[r] = cur.astype(np.uint8)
        prev = out[r]
    return out.tobytes()


def _decode_stream(d: dict, filters: list[bytes],
                   stream: bytes) -> np.ndarray | None:
    from .decode import decode_bytes

    w, h = d.get(b"Width", 0), d.get(b"Height", 0)
    for idx, f in enumerate(filters):
        if f == b"DCTDecode":
            return decode_bytes(stream)
        if f == b"JPXDecode":
            return decode_bytes(stream)  # PIL/openjpeg reads jp2/j2k
        if f == b"FlateDecode":
            try:
                stream = zlib.decompress(stream)
            except zlib.error:
                return None
            if idx + 1 < len(filters):
                continue  # e.g. [/FlateDecode /DCTDecode]
            break
        return None  # unsupported filter (LZW, CCITT, JBIG2, ...)
    # raw (possibly predicted) raster
    if w <= 0 or h <= 0 or d.get(b"Bits", 8) != 8:
        return None
    colors = d.get(b"Colors", d.get(b"_ncomp", 3))
    if d.get(b"Predictor", 1) >= 10:
        stream = _png_unpredict(stream, d.get(b"Columns", w), colors)
        if stream is None:
            return None
    ncomp = d.get(b"_ncomp", colors)
    if len(stream) < w * h * ncomp:
        return None
    arr = np.frombuffer(stream[:w * h * ncomp], dtype=np.uint8)
    if ncomp == 1:
        return arr.reshape(h, w)
    return arr.reshape(h, w, ncomp)[..., :3]


def extract_largest_pdf_image(data: bytes,
                              max_objects: int = 256) -> np.ndarray | None:
    """Return the largest embedded raster in a PDF, or None."""
    if not data.startswith(b"%PDF"):
        return None
    best, best_px = None, 0
    count = 0
    for m in _OBJ_RE.finditer(data):
        head = m.group(1)
        if b"/Image" not in head or b"/Subtype" not in head:
            continue
        count += 1
        if count > max_objects:
            break
        d = {}
        for key, rx in _NUM_KEY.items():
            km = rx.search(head)
            if km:
                d[key] = int(km.group(1))
        if d.get(b"Width", 0) * d.get(b"Height", 0) <= best_px:
            continue
        if b"/DeviceGray" in head:
            d[b"_ncomp"] = 1
        elif b"/DeviceRGB" in head:
            d[b"_ncomp"] = 3
        elif b"/Indexed" in head or b"/DeviceCMYK" in head:
            if b"/DCTDecode" not in head and b"/JPXDecode" not in head:
                continue
        filters = re.findall(
            rb"/(DCTDecode|JPXDecode|FlateDecode|LZWDecode|CCITTFaxDecode"
            rb"|JBIG2Decode|ASCIIHexDecode|ASCII85Decode|RunLengthDecode)",
            head)
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        # a direct /Length delimits the stream exactly; the rstrip
        # fallback corrupts ~1/128 of flate streams whose compressed
        # payload happens to end in \n or \r
        length = d.get(b"Length")
        if length is not None and 0 < length <= end - start \
                and not data[start + length:end].strip(b"\r\n "):
            stream = data[start:start + length]
        else:
            stream = data[start:end].rstrip(b"\r\n")
        try:
            img = _decode_stream(d, filters or [], stream)
        except Exception:
            img = None
        if img is not None:
            px = img.shape[0] * img.shape[1]
            if px > best_px:
                best, best_px = img, px
    return best

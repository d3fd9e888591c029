"""Heavy per-file scan work of the port, run in decode workers.

A copy of rupphash_tpu/pipeline/heavy.py (`heavy_prepare` :19-84) whose
decode takes the caller's `device`, so a preview-less RAW file is
demosaiced by the port where the caller says.  The fused JPEG/PNG/WebP/
RAW-preview probes are the reference's, in the port's own native/.
Imports no torch: spawned workers import it fresh, and torch is
imported only if a preview-less raw needs the demosaic.
"""

from __future__ import annotations

from pathlib import Path

from ..utils import hashes as H
from . import decode, exif


def heavy_prepare(path, content_key: bytes | None, want_pixel_hash: bool,
                  device: str):
    """Read + keyed hash + EXIF + decode + luma of one file; store-free
    and picklable.  `device` ("cpu" in a spawned worker, the main
    process's device otherwise) is where a preview-less raw is
    demosaiced."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError:
        return None
    out: dict = {}
    out["content_hash"] = H.content_hash(
        content_key if content_key is not None else b"\x00" * 32, data)

    feats = exif.extract(path, data=data)
    out["features"] = feats

    # fused probes: decode scanlines straight into the <=512 luma
    # (bit-identical to the load_image route); skipped when the full
    # RGB is needed (--pixel-hash) or the suffix routes elsewhere (RAW
    # containers hash their embedded preview)
    fast = None
    if not want_pixel_hash:
        special = decode.is_raw_ext(path) or \
            path.suffix.lower().lstrip(".") in ("heic", "heif", "jxl",
                                                "pdf")
        if data[:3] == b"\xff\xd8\xff" and not special:
            from ..native import jpegfast
            fast = jpegfast.probe_luma(data)
        elif data[:8] == b"\x89PNG\r\n\x1a\n" and not special:
            from ..native import pngfast
            fast = pngfast.probe_luma(data)
        elif (data[:4] == b"RIFF" and data[8:12] == b"WEBP"
              and not special):
            from ..native import webpfast
            fast = webpfast.probe_luma(data)
        elif decode.is_raw_ext(path):
            fast = decode.probe_luma_raw_preview(data)
    if fast is not None:
        luma, res = fast
        out["res"] = res
        feats["width"], feats["height"] = res
        out["luma"] = luma
        return out

    img, res = decode.load_image(path, data=data, device=device)
    if img is None:
        out["decode_failed"] = True
        return out
    out["res"] = res
    feats["width"], feats["height"] = res
    if want_pixel_hash:
        out["pixel_hash"] = H.pixel_hash_rgba16(
            content_key if content_key is not None else b"\x00" * 32,
            img)
    out["luma"] = decode.prepare_luma_fast(img)
    return out

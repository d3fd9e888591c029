"""Animated image probing and frame decoding.

Mirrors the reference's animation handling (gui/image.rs:1602-1800):

  * cheap containment probes without a full decode — WebP by scanning
    RIFF chunks for ANIM/ANMF, GIF by a two-frame header walk, APNG by
    the acTL chunk (:1602-1640)
  * full frame decode with per-frame delay normalization: delays are
    clamped to the 240 fps floor and unspecified/zero delays default to
    100 ms (:1641-1722)

The hashing pipeline always uses frame 0 (scanner parity); the web GUI
serves animated originals to the browser, which plays GIF/WebP/APNG
natively — the equivalent of the reference's AnimationState playback.
"""

from __future__ import annotations

import io
import struct

import numpy as np

MIN_FRAME_DELAY_S = 1.0 / 240.0   # 240 fps cap (gui/image.rs:1666)
DEFAULT_FRAME_DELAY_S = 0.10      # unspecified delay (gui/image.rs:1668)


def is_animated_webp(data: bytes) -> bool:
    """RIFF chunk scan for an ANIM chunk (gui/image.rs:1602-1616)."""
    if len(data) < 16 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return False
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if tag in (b"ANIM", b"ANMF"):
            return True
        pos += 8 + size + (size & 1)
    return False


def is_animated_gif(data: bytes) -> bool:
    """Two-image-descriptor byte walk (gui/image.rs:1618-1640):
    animated iff a second image block exists.  Answers after the
    second descriptor without decoding — PIL's n_frames seeks through
    every frame's data, O(file) on the GUI's per-request hot path."""
    if not data.startswith((b"GIF87a", b"GIF89a")):
        return False
    try:
        # logical screen descriptor + optional global color table
        p = 10
        packed = data[p]
        p = 13
        if packed & 0x80:
            p += 3 * (2 << (packed & 0x07))
        images = 0
        n = len(data)
        while p < n:
            b = data[p]
            if b == 0x3B:          # trailer
                break
            if b == 0x21:          # extension: label + sub-blocks
                p += 2
                while p < n and data[p] != 0:
                    p += 1 + data[p]
                p += 1
            elif b == 0x2C:        # image descriptor
                images += 1
                if images >= 2:
                    return True
                p += 10
                lp = data[p - 1]
                if lp & 0x80:      # local color table
                    p += 3 * (2 << (lp & 0x07))
                p += 1             # LZW min code size
                while p < n and data[p] != 0:
                    p += 1 + data[p]
                p += 1
            else:
                break              # corrupt block stream
        return False
    except IndexError:
        return False


def is_animated_png(data: bytes) -> bool:
    """APNG acTL chunk before IDAT."""
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        return False
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        (size,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        if tag == b"acTL":
            return True
        if tag == b"IDAT":
            return False
        pos += 12 + size
    return False


def probe(data: bytes) -> str | None:
    """'gif' | 'webp' | 'apng' when animated, else None."""
    if is_animated_gif(data):
        return "gif"
    if is_animated_webp(data):
        return "webp"
    if is_animated_png(data):
        return "apng"
    return None


def sniff_animatable(head: bytes) -> bool:
    """True when the first bytes identify a container type that *can*
    animate (GIF / RIFF-WebP / PNG) — the cheap 16-byte gate before the
    O(file) read that probe() needs.  Magic bytes, not extensions: an
    animated GIF named .jpg must still stream as an animation, while a
    large RAW/TIFF must not pay a full read per request."""
    return (head.startswith((b"GIF87a", b"GIF89a"))
            or (head[:4] == b"RIFF" and head[8:12] == b"WEBP")
            or head.startswith(b"\x89PNG\r\n\x1a\n"))


def decode_frames(data: bytes, max_frames: int = 512,
                  max_side: int = 8192):
    """All frames + normalized delays: (frames [(H,W,3|4) u8], delays s).
    Returns (None, None) when not decodable as a multi-frame image."""
    from PIL import Image, ImageSequence

    try:
        im = Image.open(io.BytesIO(data))
    except Exception:
        return None, None
    frames, delays = [], []
    try:
        for frame in ImageSequence.Iterator(im):
            if len(frames) >= max_frames:
                break
            f = frame.convert("RGBA" if frame.mode in ("P", "RGBA", "LA")
                              else "RGB")
            if max(f.size) > max_side:
                scale = max_side / max(f.size)
                f = f.resize((max(1, int(f.width * scale)),
                              max(1, int(f.height * scale))))
            frames.append(np.asarray(f))
            ms = frame.info.get("duration", 0) or 0
            d = ms / 1000.0
            if d <= 0:
                d = DEFAULT_FRAME_DELAY_S  # gui/image.rs:1668
            delays.append(max(d, MIN_FRAME_DELAY_S))
    except Exception:
        pass
    finally:
        im.close()
    if len(frames) < 2:
        return None, None
    return frames, delays


MIME = {"gif": "image/gif", "webp": "image/webp", "apng": "image/png"}

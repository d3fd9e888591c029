"""Viewer image engine: decode -> HDR finish -> orient -> LUT -> encode.

The web analogue of the reference's load_and_process_image_from_bytes
(gui/image.rs:1829-1962) and render_image_texture orientation handling
(gui/image.rs:2325-2428):

  * tiered decode (pipeline/decode.py — JPEG/PNG/WebP/AVIF/HEIC/JXL/
    RAW preview/DNG demosaic/PDF raster)
  * HDR->SDR finishing when cICP marks a PQ/HLG/BT.2020 source
    (pipeline/hdr.py: BT.2390 MaxRGB tone map, gamut matrices,
    dithered 8-bit encode — gui/image.rs:1429 finish_dynamic analogue)
  * EXIF orientation decomposed into quarter-turns + mirror, composed
    with the per-file manual FileTransform (gui/image.rs:2325-2428)
  * optional 3D LUT (tetrahedral, gui/lut.py)
  * downscale to the requested max side (MAX_TEXTURE_SIDE guard,
    gui/image.rs:1357) and JPEG/PNG encode for the browser

A small LRU keyed on (file id, mtime, transform, lut, size) mirrors the
reference's preload-window texture caches (gui/app.rs:1686-1845).
"""

from __future__ import annotations

import io
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

MAX_TEXTURE_SIDE = 8192  # gui/image.rs:1357


def exif_orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply EXIF orientation 1-8 (decomposition per gui/image.rs:2325)."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return np.swapaxes(img, 0, 1)
    if orientation == 6:
        return np.rot90(img, k=3)
    if orientation == 7:
        return np.swapaxes(img[::-1, ::-1], 0, 1)
    if orientation == 8:
        return np.rot90(img, k=1)
    return img


def apply_transform(img: np.ndarray, quarter_turns: int = 0,
                    flip_h: bool = False, flip_v: bool = False):
    """Per-file manual transform (state.rs FileTransform semantics)."""
    if flip_h:
        img = img[:, ::-1]
    if flip_v:
        img = img[::-1]
    if quarter_turns % 4:
        img = np.rot90(img, k=(-quarter_turns) % 4)
    return img


def hdr_finish(data: bytes, img: np.ndarray,
               peak_nits: float = 203.0) -> np.ndarray:
    """If the container carries cICP marking an HDR/wide-gamut encode,
    tone-map to SDR (finish_dynamic analogue).  8-bit passthrough
    otherwise."""
    from ..pipeline import hdr

    try:
        cicp = hdr.detect_cicp(data)
    except Exception:
        cicp = None
    if cicp is None or img.ndim != 3:
        return img
    try:
        if not cicp.needs_conversion:
            return img
        lin = hdr.hdr_to_sdr(img[..., :3].astype(np.float32) / 255.0,
                             cicp, peak_nits=peak_nits)
        return hdr.encode_srgb_u8_dithered(lin)
    except Exception:
        return img


def hdr_finish_deep(data: bytes, img: np.ndarray,
                    peak_nits: float = 203.0) -> np.ndarray:
    """Deep-color finish: the same HDR->SDR pipeline kept at 16 bits
    (no dither/quantize to u8) — the web analogue of the reference's
    Rgba16/Rgb10a2 output stage (hdr.rs:789-811, 998-1019); browsers
    are 8-bit, so this feeds the /api/image?deep=1 PNG endpoint for
    deep-display clients."""
    from ..pipeline import hdr

    try:
        cicp = hdr.detect_cicp(data)
    except Exception:
        cicp = None
    if cicp is not None and img.ndim == 3 and cicp.needs_conversion:
        try:
            lin = hdr.hdr_to_sdr(img[..., :3].astype(np.float32) / 255.0,
                                 cicp, peak_nits=peak_nits)
            return hdr.encode_u16(lin)
        except Exception:
            pass
    if img.dtype == np.uint16:
        return img[..., :3] if img.ndim == 3 else \
            np.stack([img] * 3, axis=-1)
    arr = img[..., :3] if img.ndim == 3 else np.stack([img] * 3, axis=-1)
    return arr.astype(np.uint16) * 257  # 0xFF -> 0xFFFF exactly


def encode_png16(arr: np.ndarray) -> bytes:
    """(H, W, 3) uint16 -> 48-bit RGB PNG (PIL cannot write these)."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    raw = np.ascontiguousarray(arr[..., :3]).astype(">u2").tobytes()
    stride = w * 6
    rows = b"".join(b"\x00" + raw[y * stride:(y + 1) * stride]
                    for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows, 6))
            + chunk(b"IEND", b""))


def _downscale_u16(img: np.ndarray, max_side: int) -> np.ndarray:
    h, w = img.shape[:2]
    side = max(h, w)
    if side <= max_side:
        return img
    from PIL import Image
    scale = max_side / side
    nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
    chans = [np.asarray(Image.fromarray(
        img[..., c].astype(np.float32), mode="F").resize(
            (nw, nh), Image.BILINEAR)) for c in range(img.shape[2])]
    return np.clip(np.round(np.stack(chans, axis=-1)), 0,
                   65535).astype(np.uint16)


def _downscale(img: np.ndarray, max_side: int) -> np.ndarray:
    h, w = img.shape[:2]
    side = max(h, w)
    if side <= max_side:
        return img
    from PIL import Image
    scale = max_side / side
    im = Image.fromarray(img)
    return np.asarray(im.resize((max(1, int(w * scale)),
                                 max(1, int(h * scale))),
                                Image.BILINEAR))


class ImageEngine:
    def __init__(self, luts=None, cache_items: int = 48,
                 raw_thumbnails: bool = False):
        self.luts = luts or []          # list[Lut3D]
        # --raw-thumbnails: view RAW files from their embedded preview
        # instead of the full demosaic (gui/image.rs:1839-1962 thumbnail
        # mode vs unpack()+process())
        self.raw_thumbnails = raw_thumbnails
        self.active_lut = -1            # -1 = off; cycles like the ref
        self._cache: OrderedDict = OrderedDict()
        self._cache_items = cache_items
        # decoded-raster LRU: transform/LUT/size changes re-encode but
        # never re-decode (the expensive step, esp. full DNG demosaic)
        self._raster_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def cycle_lut(self) -> str:
        if not self.luts:
            return "no LUTs loaded"
        self.active_lut += 1
        if self.active_lut >= len(self.luts):
            self.active_lut = -1
            return "LUT off"
        lut = self.luts[self.active_lut]
        return f"LUT: {lut.title or Path(lut.path).name}"

    def render(self, path: Path, orientation: int = 1, transform=None,
               max_side: int = 2048, fmt: str = "jpeg",
               peak_nits: float = 203.0) -> bytes | None:
        """Processed image bytes for the browser, or None."""
        try:
            st = path.stat()
        except OSError:
            return None
        tkey = (transform.quarter_turns, transform.flip_h,
                transform.flip_v) if transform else (0, False, False)
        key = (str(path), st.st_mtime_ns, st.st_size, orientation, tkey,
               self.active_lut, max_side, fmt)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]

        from ..pipeline import decode

        deep = fmt == "png16"
        rkey = (str(path), st.st_mtime_ns, st.st_size,
                self.raw_thumbnails, peak_nits, deep)
        with self._lock:
            cached = self._raster_cache.get(rkey)
            if cached is not None:
                self._raster_cache.move_to_end(rkey)
        if cached is not None:
            img = cached
        else:
            try:
                data = path.read_bytes()
            except OSError:
                return None
            img, _ = decode.load_image(
                path, data=data,
                prefer_full_raw=not self.raw_thumbnails)
            if img is None:
                return None
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            img = (hdr_finish_deep(data, img, peak_nits) if deep
                   else hdr_finish(data, img, peak_nits))
            with self._lock:
                self._raster_cache[rkey] = img
                while len(self._raster_cache) > 8:
                    self._raster_cache.popitem(last=False)
        img = exif_orient(img, orientation)
        if transform is not None:
            img = apply_transform(img, transform.quarter_turns,
                                  transform.flip_h, transform.flip_v)
        img = (_downscale_u16 if deep else _downscale)(
            img, min(max_side, MAX_TEXTURE_SIDE))
        if 0 <= self.active_lut < len(self.luts):
            from . import lut as lutmod
            active = self.luts[self.active_lut]
            if deep:
                out01 = lutmod.apply_lut_f32(
                    img[..., :3].astype(np.float32) / 65535.0, active)
                img = np.clip(np.round(out01 * 65535.0), 0,
                              65535).astype(np.uint16)
            else:
                img = lutmod.apply_lut_u8(
                    np.ascontiguousarray(img[..., :3]), active)
        buf = io.BytesIO()
        arr = np.ascontiguousarray(img)
        if deep:
            out = encode_png16(arr)
        else:
            from PIL import Image
            if fmt == "png":
                Image.fromarray(arr).save(buf, format="PNG")
            else:
                if arr.ndim == 3 and arr.shape[2] == 4:
                    arr = arr[..., :3]
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            out = buf.getvalue()
        with self._lock:
            self._cache[key] = out
            while len(self._cache) > self._cache_items:
                self._cache.popitem(last=False)
        return out

    def render_animated(self, path: Path, orientation: int = 1,
                        transform=None, max_side: int = 2048,
                        max_frames: int = 96) -> bytes | None:
        """Animated original with the per-file transform + active LUT
        applied to EVERY frame server-side, re-encoded as APNG (which
        browsers play natively).  This is the web analogue of the
        reference viewer running its animation frames through the same
        orientation/LUT path as stills (gui/image.rs:1602-1800); the
        frame count is bounded so worst-case work stays predictable.
        Returns None when the file is not animated (caller falls back
        to the still path)."""
        try:
            st = path.stat()
        except OSError:
            return None
        tkey = (transform.quarter_turns, transform.flip_h,
                transform.flip_v) if transform else (0, False, False)
        key = ("anim", str(path), st.st_mtime_ns, st.st_size,
               orientation, tkey, self.active_lut, max_side, max_frames)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]

        from ..pipeline import animated

        try:
            data = path.read_bytes()
        except OSError:
            return None
        if animated.probe(data) is None:
            return None
        frames, delays = animated.decode_frames(data,
                                                max_frames=max_frames)
        if frames is None:
            return None
        from PIL import Image

        lut = (self.luts[self.active_lut]
               if 0 <= self.active_lut < len(self.luts) else None)
        out = []
        for f in frames:
            img = exif_orient(f, orientation)
            if transform is not None:
                img = apply_transform(img, transform.quarter_turns,
                                      transform.flip_h,
                                      transform.flip_v)
            img = _downscale(img, min(max_side, MAX_TEXTURE_SIDE))
            if lut is not None:
                from . import lut as lutmod
                rgb = lutmod.apply_lut_u8(
                    np.ascontiguousarray(img[..., :3]), lut)
                img = (np.concatenate([rgb, img[..., 3:]], axis=-1)
                       if img.shape[-1] == 4 else rgb)
            out.append(Image.fromarray(np.ascontiguousarray(img)))
        buf = io.BytesIO()
        out[0].save(buf, format="PNG", save_all=True,
                    append_images=out[1:],
                    duration=[max(int(d * 1000), 10) for d in delays],
                    loop=0)
        body = buf.getvalue()
        with self._lock:
            self._cache[key] = body
            while len(self._cache) > self._cache_items:
                self._cache.popitem(last=False)
        return body

    def analyze(self, path: Path, palette_config=None) -> dict | None:
        """Histograms + palette for the overlay (gui/image.rs:2561-3255
        analysis path, downsampled).  palette_config: PaletteConfig from
        the [gui] section (dominant_colors/saturation_bias/palette_sort,
        db.rs:75-90)."""
        from ..pipeline import decode, palette

        img, _ = decode.load_image(path)
        if img is None:
            return None
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img[..., :3]
        small = palette.analysis_downsample(img)
        hl, ha, hb = palette.oklab_histograms(small)
        luma = palette.luma_histogram(small)
        pal = palette.kmeans_palette(small, config=palette_config)
        return {
            "luma": [int(v) for v in luma],
            "okl": [int(v) for v in hl],
            "oka": [int(v) for v in ha],
            "okb": [int(v) for v in hb],
            "palette": [[int(c) for c in row] for row in pal],
        }

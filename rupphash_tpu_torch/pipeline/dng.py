"""DNG raw decoding: TIFF/EP container parse + CFA raster extraction.

The reference delegates RAW handling to LibRaw (rsraw FFI,
scanner.rs:1303-1380, gui/image.rs:1839-1962).  LibRaw is not in this
image, so preview-less DNGs are handled natively: this module parses
the TIFF 6.0 / DNG 1.4 container, extracts the CFA mosaic (uncompressed
or lossless-JPEG tiles/strips via the C++ LJ92 decoder in
native/ruppnative.cpp), and hands calibration metadata to the TPU
demosaic pipeline in ops/demosaic.py.

Scope: DNG is the *standard* raw container (and what `dnglab`/Adobe
convert proprietary raws into).  Proprietary compressed formats
(NEF/CR2/ARW...) still go through the embedded-preview carver tier
(pipeline/decode.py), same as the reference's hashing path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# TIFF tag ids
_T_NEW_SUBFILE = 254
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_ORIENTATION = 274
_T_ROWS_PER_STRIP = 278
_T_STRIP_COUNTS = 279
_T_SUB_IFDS = 330
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_COUNTS = 325
_T_CFA_DIM = 33421
_T_CFA_PATTERN = 33422
_T_DNG_VERSION = 50706
_T_BLACK_LEVEL = 50714
_T_WHITE_LEVEL = 50717
_T_COLOR_MATRIX1 = 50721
_T_COLOR_MATRIX2 = 50722
_T_AS_SHOT_NEUTRAL = 50728
_T_ACTIVE_AREA = 50829

_PHOTO_CFA = 32803
_PHOTO_LINEAR_RAW = 34892

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8}


@dataclass
class RawImage:
    mosaic: np.ndarray           # (H, W) uint16 (active area cropped)
    cfa: np.ndarray              # (2, 2) int, 0=R 1=G 2=B
    black: float
    white: float
    as_shot_neutral: np.ndarray | None = None   # camera WB (R,G,B)
    color_matrix: np.ndarray | None = None      # 3x3 XYZ->camera
    orientation: int = 1
    linear: bool = False         # LinearRaw: mosaic is already RGB-ish
    extra: dict = field(default_factory=dict)


def _read_ifd(data: bytes, off: int, endian: str) -> tuple[dict, int]:
    """One IFD -> ({tag: value}, next_ifd_offset)."""
    if off + 2 > len(data):
        return {}, 0
    (n,) = struct.unpack_from(endian + "H", data, off)
    entries = {}
    pos = off + 2
    for _ in range(n):
        if pos + 12 > len(data):
            break
        tag, typ, cnt = struct.unpack_from(endian + "HHI", data, pos)
        size = _TYPE_SIZE.get(typ, 1) * cnt
        if size <= 4:
            voff = pos + 8
        else:
            (voff,) = struct.unpack_from(endian + "I", data, pos + 8)
        if voff + size > len(data):
            pos += 12
            continue
        raw = data[voff:voff + size]
        if typ in (1, 6, 7):
            val = np.frombuffer(raw, dtype=np.uint8)
        elif typ == 2:
            val = raw.rstrip(b"\x00")
        elif typ == 3:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.uint16).newbyteorder(endian))
        elif typ == 4:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.uint32).newbyteorder(endian))
        elif typ == 8:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.int16).newbyteorder(endian))
        elif typ == 9:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.int32).newbyteorder(endian))
        elif typ in (5, 10):
            ints = np.frombuffer(raw, dtype=np.dtype(
                np.uint32 if typ == 5 else np.int32).newbyteorder(endian))
            num, den = ints[0::2].astype(np.float64), ints[1::2]
            val = np.where(den != 0, num / np.where(den == 0, 1, den), 0.0)
        elif typ == 11:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.float32).newbyteorder(endian))
        elif typ == 12:
            val = np.frombuffer(
                raw, dtype=np.dtype(np.float64).newbyteorder(endian))
        else:
            val = raw
        entries[tag] = val
        pos += 12
    nxt = 0
    if pos + 4 <= len(data):
        (nxt,) = struct.unpack_from(endian + "I", data, pos)
    return entries, nxt


def _all_ifds(data: bytes, endian: str, first: int):
    """IFD0, chained IFDs, and (recursively) SubIFDs."""
    seen = set()
    stack = [first]
    while stack:
        off = stack.pop()
        if not off or off in seen or off >= len(data):
            continue
        seen.add(off)
        ifd, nxt = _read_ifd(data, off, endian)
        if not ifd:
            continue
        yield ifd
        if nxt:
            stack.append(nxt)
        subs = ifd.get(_T_SUB_IFDS)
        if subs is not None:
            stack.extend(int(s) for s in np.atleast_1d(subs))


def _scalar(ifd, tag, default=None):
    v = ifd.get(tag)
    if v is None:
        return default
    arr = np.atleast_1d(v)
    return arr.flat[0] if arr.size else default


def _raster(data: bytes, ifd: dict, endian: str) -> np.ndarray | None:
    """The (H, W) uint16 sensor raster from strips or tiles."""
    from .. import native

    w = int(_scalar(ifd, _T_WIDTH, 0))
    h = int(_scalar(ifd, _T_LENGTH, 0))
    bits = int(_scalar(ifd, _T_BITS, 16))
    comp = int(_scalar(ifd, _T_COMPRESSION, 1))
    if w <= 0 or h <= 0 or w * h > 512_000_000 // 4:
        return None
    out = np.zeros((h, w), dtype=np.uint16)

    def _unpack(raw: bytes, rows: int, width: int):
        if bits == 16:
            if len(raw) < rows * width * 2:
                return None  # truncated strip / lying byte counts
            arr = np.frombuffer(raw, dtype=np.dtype(
                np.uint16).newbyteorder(endian),
                count=rows * width)
            return arr.reshape(rows, width)
        if bits == 8:
            if len(raw) < rows * width:
                return None
            return np.frombuffer(raw, dtype=np.uint8,
                                 count=rows * width).reshape(
                rows, width).astype(np.uint16)
        if bits in (10, 12, 14):
            # MSB-first packed (TIFF fill order 1) — the uncompressed
            # NEF/CR2-class sensor packing as well as DNG's.  Work in
            # bounded chunks with uint16 shift-accumulate: a whole-strip
            # (n, bits) int64 matrix costs ~15x the payload (gigabytes
            # for a 24MP raw) and would blow the scan's memory budget.
            n = rows * width
            need = (n * bits + 7) // 8
            if len(raw) < need:
                return None
            b = np.frombuffer(raw, dtype=np.uint8, count=need)
            out_flat = np.empty(n, dtype=np.uint16)
            # chunk on a byte boundary: lcm(bits, 8)/bits samples per
            # aligned unit (4 for 10/14-bit, 2 for 12-bit)
            import math as _math
            unit = 8 // _math.gcd(bits, 8)
            smp_chunk = max(unit, (1 << 20) // unit * unit)
            for s0 in range(0, n, smp_chunk):
                s1 = min(n, s0 + smp_chunk)
                b0 = s0 * bits // 8
                b1 = (s1 * bits + 7) // 8
                allbits = np.unpackbits(b[b0:b1])[:(s1 - s0) * bits]
                cols = allbits.reshape(s1 - s0, bits)
                acc = np.zeros(s1 - s0, dtype=np.uint16)
                for k in range(bits):
                    acc = (acc << 1) | cols[:, k]
                out_flat[s0:s1] = acc
            return out_flat.reshape(rows, width)
        return None

    if _T_TILE_OFFSETS in ifd:
        tw = int(_scalar(ifd, _T_TILE_WIDTH, 0))
        tl = int(_scalar(ifd, _T_TILE_LENGTH, 0))
        offs = np.atleast_1d(ifd[_T_TILE_OFFSETS]).astype(np.int64)
        cnts = np.atleast_1d(ifd[_T_TILE_COUNTS]).astype(np.int64)
        if tw <= 0 or tl <= 0:
            return None
        tiles_x = (w + tw - 1) // tw
        for i, (o, c) in enumerate(zip(offs, cnts)):
            ty, tx = divmod(i, tiles_x)
            raw = data[o:o + c]
            if comp == 1:
                tile = _unpack(raw, tl, tw)
            elif comp == 7:
                dec = native.lj92_decode(bytes(raw))
                if dec is None or dec.size != tl * tw:
                    return None
                tile = dec.reshape(tl, tw)
            else:
                return None
            if tile is None:
                return None
            y0, x0 = ty * tl, tx * tw
            ys, xs = min(tl, h - y0), min(tw, w - x0)
            if ys <= 0 or xs <= 0:
                continue
            out[y0:y0 + ys, x0:x0 + xs] = tile[:ys, :xs]
        return out

    if _T_STRIP_OFFSETS in ifd:
        offs = np.atleast_1d(ifd[_T_STRIP_OFFSETS]).astype(np.int64)
        cnts = np.atleast_1d(ifd.get(_T_STRIP_COUNTS,
                                     np.array([len(data)]))).astype(
            np.int64)
        rps = int(_scalar(ifd, _T_ROWS_PER_STRIP, h))
        y = 0
        for o, c in zip(offs, cnts):
            rows = min(rps, h - y)
            if rows <= 0:
                break
            raw = data[o:o + c]
            if comp == 1:
                strip = _unpack(raw, rows, w)
            elif comp == 7:
                dec = native.lj92_decode(bytes(raw))
                if dec is None or dec.size != rows * w:
                    return None
                strip = dec.reshape(rows, w)
            else:
                return None
            if strip is None:
                return None
            out[y:y + rows] = strip
            y += rows
        return out
    return None


def parse_dng(data: bytes) -> RawImage | None:
    """Parse a DNG/TIFF byte buffer into a RawImage, or None."""
    if len(data) < 8:
        return None
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        return None
    magic, first = struct.unpack_from(endian + "HI", data, 2)
    if magic != 42:
        return None

    ifds = list(_all_ifds(data, endian, first))
    if not ifds:
        return None
    ifd0 = ifds[0]
    raw_ifd = None
    for ifd in ifds:
        photo = _scalar(ifd, _T_PHOTOMETRIC)
        if photo is not None and int(photo) in (_PHOTO_CFA,
                                                _PHOTO_LINEAR_RAW):
            raw_ifd = ifd
            break
    if raw_ifd is None:
        return None

    mosaic = _raster(data, raw_ifd, endian)
    if mosaic is None:
        return None

    # active-area crop (50829: top, left, bottom, right)
    aa = raw_ifd.get(_T_ACTIVE_AREA)
    if aa is not None and np.atleast_1d(aa).size == 4:
        t, l, b, r = (int(x) for x in np.atleast_1d(aa))
        if 0 <= t < b <= mosaic.shape[0] and 0 <= l < r <= mosaic.shape[1]:
            mosaic = mosaic[t:b, l:r]

    # CFA pattern
    linear = int(_scalar(raw_ifd, _T_PHOTOMETRIC)) == _PHOTO_LINEAR_RAW
    cfa = np.array([[0, 1], [1, 2]], dtype=np.int32)  # RGGB default
    pat = raw_ifd.get(_T_CFA_PATTERN)
    dim = raw_ifd.get(_T_CFA_DIM)
    if pat is not None:
        p = np.atleast_1d(pat).astype(np.int32)
        if dim is not None and np.atleast_1d(dim).size == 2:
            rows, cols = (int(x) for x in np.atleast_1d(dim))
        else:
            rows = cols = int(np.sqrt(p.size))
        if rows == 2 and cols == 2 and p.size == 4:
            cfa = p.reshape(2, 2)
        elif p.size >= 4:
            cfa = p[:4].reshape(2, 2)

    bl = raw_ifd.get(_T_BLACK_LEVEL)
    black = float(np.mean(np.atleast_1d(bl))) if bl is not None else 0.0
    bits = int(_scalar(raw_ifd, _T_BITS, 16))
    white = float(_scalar(raw_ifd, _T_WHITE_LEVEL,
                          (1 << bits) - 1))

    def _from_either(tag):
        v = raw_ifd.get(tag)
        return v if v is not None else ifd0.get(tag)

    asn = _from_either(_T_AS_SHOT_NEUTRAL)
    if asn is not None:
        asn = np.atleast_1d(asn).astype(np.float64)
        asn = asn if asn.size == 3 and np.all(asn > 0) else None
    cm = _from_either(_T_COLOR_MATRIX2)
    if cm is None:
        cm = _from_either(_T_COLOR_MATRIX1)
    if cm is not None:
        cm = np.atleast_1d(cm).astype(np.float64)
        cm = cm.reshape(3, 3) if cm.size == 9 else None

    orient = int(_scalar(ifd0, _T_ORIENTATION, 1))
    return RawImage(mosaic=mosaic, cfa=cfa, black=black, white=white,
                    as_shot_neutral=asn, color_matrix=cm,
                    orientation=orient, linear=linear)


def is_dng(data: bytes) -> bool:
    """Cheap sniff: TIFF container with a DNGVersion tag in IFD0."""
    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        return False
    endian = "<" if data[:2] == b"II" else ">"
    try:
        magic, first = struct.unpack_from(endian + "HI", data, 2)
        if magic != 42:
            return False
        ifd0, _ = _read_ifd(data, first, endian)
        return _T_DNG_VERSION in ifd0
    except struct.error:
        return False


def decode_dng(data: bytes) -> np.ndarray | None:
    """Full raw pipeline: parse -> TPU demosaic/color -> (H, W, 3) u8."""
    raw = parse_dng(data)
    if raw is None:
        return None
    from ..ops import demosaic
    return demosaic.process_raw(raw)

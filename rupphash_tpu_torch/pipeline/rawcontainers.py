"""Proprietary raw container decode: CR2, NEF, and generic TIFF-EP.

The reference's viewer does a full LibRaw unpack+process with camera WB
(gui/image.rs:1886-1945, raw_exif.rs:40-111); LibRaw is absent from this
image, so the mainstream layouts are parsed natively and fed to the same
TPU demosaic pipeline the DNG path uses (pipeline/dng.py RawImage ->
ops/demosaic.py):

* **CR2** (Canon): TIFF with a ``CR\\x02`` signature at offset 8 whose
  trailing u32 points at the RAW IFD; the sensor mosaic is one
  lossless-JPEG (SOF3) strip decoded by the native LJ92 core
  (native/ruppnative.cpp), stored as vertical slices described by tag
  0xC640; camera WB comes from the Canon MakerNote ColorData block
  (tag 0x4001, WB_RGGBLevelsAsShot).
* **NEF** (Nikon): TIFF whose raw SubIFD is photometric CFA.
  Uncompressed 12/14-bit packed and 16-bit rasters (and lossless-JPEG
  ones) decode natively; Nikon's proprietary Huffman compression
  (34713 — all six published tree variants, lossless and lossy with
  split-row tree switch, MakerNote 0x0096 linearization curve) decodes
  through the native nef_decode core (ruppnative.cpp) with a
  pure-Python fallback.  WB from MakerNote WB_RBLevels (tag 0x000C).
* **ARW** (Sony): compression 32767 — ARW2 packed 16-pixel blocks
  (1 byte/px) and plain u16 strips both decode natively; the SR2
  private block (tags 0x7200/0x7201/0x7221) is stream-decrypted for
  the tone curve (0x7010), black level (0x7310) and WB (0x7313).
* **RAF** (Fujifilm): big-endian offset table at 0x54, tagged CFA
  header records, u16-LE / LSB-packed 12/14-bit rasters, X-Trans 6x6
  pattern (record 0x0131) through the generic normalized-conv
  demosaic; WB record 0x2ff0.
* **RW2** (Panasonic): TIFF magic 0x55, PanasonicRaw IFD (sensor
  borders crop, CFA tag, WB levels, black), classic 12-bit predictive
  bitstream (native rw2_decode + Python oracle).
* **ORF** (Olympus): 'IIRO'/'IIRS'/'MMOR' magic, u16/packed-12 or the
  Olympus-compressed raster (native orf_decode + Python oracle),
  MakerNote Red/BlueBalance WB.
* **generic TIFF-EP**: any other maker whose raw IFD uses a supported
  compression takes the same path (covers uncompressed PEF-class
  files).

CR3 lives in pipeline/cr3.py (ISOBMFF, not TIFF).

Black/white levels: CR2/NEF carry no TIFF-level black/white tags (LibRaw
uses per-camera tables).  White defaults to the stream's sample
precision (SOF3 header / BitsPerSample); black to 0.  Synthetic
fixtures (tests/test_rawcontainers.py) bake that convention in.
"""

from __future__ import annotations

import struct

import numpy as np

from .dng import (RawImage, _all_ifds, _raster, _read_ifd, _scalar,
                  _T_BITS, _T_COMPRESSION, _T_LENGTH, _T_ORIENTATION,
                  _T_PHOTOMETRIC, _T_STRIP_COUNTS, _T_STRIP_OFFSETS,
                  _T_WIDTH, _T_CFA_PATTERN, _T_CFA_DIM, _PHOTO_CFA)

_T_MAKE = 271
_T_EXIF_IFD = 34665
_T_MAKERNOTE = 37500
_T_CR2_SLICES = 0xC640
_T_CANON_COLORDATA = 0x4001
_T_NIKON_WB_RB = 0x000C
_T_NIKON_LINEARIZATION = 0x0096
_T_SONY_SR2_OFFSET = 0x7200
_T_SONY_SR2_LENGTH = 0x7201
_T_SONY_SR2_KEY = 0x7221
_T_SONY_CURVE = 0x7010
_T_SONY_BLACK = 0x7310
_T_SONY_WB_RGGB = 0x7313

_COMP_NIKON = 34713
_COMP_SONY = 32767

_RGGB = np.array([[0, 1], [1, 2]], dtype=np.int32)

# Nikon 34713 Huffman trees (format constants; counts for code lengths
# 1..16 then canonical-order leaf values, rows zero-padded — tree 0's
# 14th leaf is the pad byte).  Shared by the pure-Python fallback
# decoder and the synthetic encoder in tests; the C++ decoder
# (native/ruppnative.cpp nef_decode) carries its own copy.
NIKON_TREES = (
    # 12-bit lossy
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12, 0, 0, 0),
    # 12-bit lossy, after the split row
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12, 0, 0),
    # 12-bit lossless
    (0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12, 0, 0, 0),
    # 14-bit lossy
    (0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14, 0),
    # 14-bit lossy, after the split row
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,
     8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14, 0),
    # 14-bit lossless
    (0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14, 0),
)


def nikon_huff_codes(tree: int) -> dict:
    """Canonical (bitlength, code) -> leaf value map for NIKON_TREES[tree]."""
    row = NIKON_TREES[tree]
    counts, values = row[:16], row[16:]
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[(length, code)] = values[k]
            code += 1
            k += 1
        code <<= 1
    return out


def _tiff_endian(data: bytes) -> str | None:
    if len(data) < 8:
        return None
    if data[:2] == b"II":
        return "<"
    if data[:2] == b"MM":
        return ">"
    return None


def is_cr2(data: bytes) -> bool:
    """CR2 signature: TIFF header immediately followed by 'CR' v2
    (bytes 8-10) and the raw-IFD offset (bytes 12-16)."""
    return (len(data) >= 16 and data[:2] == b"II"
            and data[8:10] == b"CR" and data[10] == 2)


def _ifd_entry_offsets(data: bytes, off: int, endian: str):
    """Raw IFD scan -> {tag: (type, count, value_offset)} with the
    *file offset* of each value (the parsed _read_ifd drops offsets,
    but MakerNote needs its own absolute position)."""
    out = {}
    if off + 2 > len(data):
        return out
    (n,) = struct.unpack_from(endian + "H", data, off)
    pos = off + 2
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
             10: 8, 11: 4, 12: 8}
    for _ in range(n):
        if pos + 12 > len(data):
            break
        tag, typ, cnt = struct.unpack_from(endian + "HHI", data, pos)
        size = sizes.get(typ, 1) * cnt
        if size <= 4:
            voff = pos + 8
        else:
            (voff,) = struct.unpack_from(endian + "I", data, pos + 8)
        out[tag] = (typ, cnt, voff)
        pos += 12
    return out


def _sof3_precision(stream: bytes) -> int | None:
    """Sample precision from the lossless-JPEG SOF3 header."""
    p = 2
    while p + 4 <= len(stream):
        if stream[p] != 0xFF:
            return None
        marker = stream[p + 1]
        p += 2
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = (stream[p] << 8) | stream[p + 1]
        if marker == 0xC3:
            return stream[p + 2]
        if marker == 0xDA:
            return None
        p += seglen
    return None


def _plausible_wb4(vals) -> bool:
    """(R, G1, G2, B) gains: positive, bounded, G1 ~ G2."""
    v = np.asarray(vals, dtype=np.float64)
    if v.size != 4 or np.any(v <= 0) or np.any(v > 65535):
        return False
    g1, g2 = v[1], v[2]
    return 0.5 < g1 / g2 < 2.0 and max(v) / min(v) < 16.0


def _canon_wb(data: bytes, endian: str, exif_off: int):
    """AsShotNeutral from the Canon MakerNote ColorData block.

    The Canon MakerNote is a bare IFD whose value offsets are relative
    to the TIFF base; tag 0x4001 holds a SHORT ColorData array with
    WB_RGGBLevelsAsShot at a version-dependent word offset (25 for
    ColorData1, 24 for ColorData2, 63 or 71 for later versions —
    validated by plausibility instead of a full version table).
    """
    exif_entries = _ifd_entry_offsets(data, exif_off, endian)
    mn = exif_entries.get(_T_MAKERNOTE)
    if mn is None:
        return None
    _, _, mn_off = mn
    mn_ifd, _ = _read_ifd(data, mn_off, endian)
    return wb_from_colordata(mn_ifd.get(_T_CANON_COLORDATA))


def wb_from_colordata(cd):
    """AsShotNeutral from a Canon ColorData SHORT array (tag 0x4001):
    WB_RGGBLevelsAsShot at a version-dependent word offset (25 for
    ColorData1, 24 for ColorData2, 63 or 71 for later versions —
    validated by plausibility instead of a full version table).
    Shared by the CR2 MakerNote path and the CR3 CMT3 path."""
    if cd is None:
        return None
    cd = np.atleast_1d(cd)
    offsets = {582: (25,), 653: (24,)}.get(cd.size, (63, 71))
    for off in offsets:
        if off + 4 <= cd.size and _plausible_wb4(cd[off:off + 4]):
            r, g1, g2, b = (float(x) for x in cd[off:off + 4])
            g = (g1 + g2) / 2.0
            # gains -> raw response of a neutral (G-normalized)
            return np.array([g / r, 1.0, g / b])
    return None


def _nikon_makernote(data: bytes, endian: str, exif_off: int):
    """The Nikon MakerNote is a 'Nikon\\x00' header followed by an
    embedded TIFF; returns (embedded bytes, embedded endian, first IFD
    offset) or None."""
    exif_entries = _ifd_entry_offsets(data, exif_off, endian)
    mn = exif_entries.get(_T_MAKERNOTE)
    if mn is None:
        return None
    _, cnt, mn_off = mn
    blob = data[mn_off:mn_off + cnt]
    if not blob.startswith(b"Nikon\x00"):
        return None
    emb = blob[10:]
    e2 = _tiff_endian(emb)
    if e2 is None:
        return None
    (first,) = struct.unpack_from(e2 + "I", emb, 4)
    return emb, e2, first


def _nikon_wb(data: bytes, endian: str, exif_off: int):
    """AsShotNeutral from the Nikon MakerNote WB_RBLevels (tag 0x000C,
    four RATIONALs R, B, G, G as G-relative multipliers)."""
    mn = _nikon_makernote(data, endian, exif_off)
    if mn is None:
        return None
    emb, e2, first = mn
    ifd, _ = _read_ifd(emb, first, e2)
    wb = ifd.get(_T_NIKON_WB_RB)
    if wb is None:
        return None
    wb = np.atleast_1d(wb).astype(np.float64)
    if wb.size < 2 or np.any(wb[:2] <= 0):
        return None
    r, b = wb[0], wb[1]
    return np.array([1.0 / r, 1.0, 1.0 / b])


def parse_nikon_linearization(meta: bytes, endian: str, bps: int):
    """Parse a Nikon MakerNote 0x0096 linearization block.

    Published layout (dcraw/LibRaw/exiftool): version bytes ver0/ver1
    (0x49/0x58 prepend a 2110-byte section skipped here), 4 u16
    vertical-predictor seeds, a u16 curve size, then either sparse
    curve anchors every `step = (1 << bps) / (csize - 1)` values that
    are integer-interpolated (lossy streams, which also carry a u16
    tree-split row at block offset 562) or a dense curve (non-lossless
    variants with csize <= 0x4001); lossless streams (ver0 0x46) keep
    the identity curve.  Returns (vpred[4] u16, curve LUT 0x4000 u16,
    base tree index, split row) or None.
    """
    if len(meta) < 12:  # ver(2) + vpred(8) + csize(2)
        return None
    ver0, ver1 = meta[0], meta[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110
    tree = 0
    if ver0 == 0x46:
        tree = 2
    if bps == 14:
        tree += 3
    if pos + 10 > len(meta):
        return None
    vpred = np.frombuffer(meta, dtype=endian + "u2", count=4,
                          offset=pos).copy()
    pos += 8
    max_ = 1 << bps
    (csize,) = struct.unpack_from(endian + "H", meta, pos)
    pos += 2
    step = max_ // (csize - 1) if csize > 1 else 0

    # identity with headroom for the interpolation's right anchor
    curve = np.arange(max_ + step + 1, dtype=np.int64)
    split = 0
    lossy = (ver0 == 0x44 and (ver1 == 0x20 or (ver1 == 0x40 and step > 3))
             and step > 0)
    if lossy:
        if pos + 2 * csize > len(meta) or len(meta) < 564:
            return None
        anchors = curve.copy()
        pts = np.frombuffer(meta, dtype=endian + "u2", count=csize,
                            offset=pos).astype(np.int64)
        anchors[np.arange(csize) * step] = pts
        i = np.arange(max_, dtype=np.int64)
        r = i % step
        base = i - r
        curve[:max_] = (anchors[base] * (step - r)
                        + anchors[base + step] * r) // step
        (split,) = struct.unpack_from(endian + "H", meta, 562)
    elif ver0 != 0x46 and csize <= 0x4001:
        if pos + 2 * csize > len(meta):
            return None
        curve[:csize] = np.frombuffer(meta, dtype=endian + "u2",
                                      count=csize, offset=pos)
    lut = np.clip(curve[:0x4000], 0, 65535).astype(np.uint16)
    if lut.size < 0x4000:  # bps 12: pad the clamp range with identity top
        lut = np.concatenate([
            lut, np.arange(lut.size, 0x4000, dtype=np.uint16)])
    return vpred, lut, tree, int(split)


class _BitReader:
    """MSB-first bit reader, zero-fed past end (test/fallback use)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def get(self, k: int) -> int:
        if k <= 0:
            return 0
        while self.n < k:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.n += 8
        v = (self.acc >> (self.n - k)) & ((1 << k) - 1)
        self.n -= k
        self.acc &= (1 << self.n) - 1
        return v


def _nef_decode_py(data: bytes, vpred, curve, width: int, height: int,
                   tree: int, split: int = 0):
    """Pure-Python mirror of ruppnative nef_decode (fallback + oracle)."""
    codes = nikon_huff_codes(tree)
    br = _BitReader(data)

    def gethuff():
        length, code = 0, 0
        while length < 16:
            code = (code << 1) | br.get(1)
            length += 1
            v = codes.get((length, code))
            if v is not None:
                return v
        return None

    vp = [[int(vpred[0]), int(vpred[1])], [int(vpred[2]), int(vpred[3])]]
    hp = [0, 0]
    out = np.zeros((height, width), dtype=np.uint16)
    for row in range(height):
        if split and row == split:
            codes = nikon_huff_codes(tree + 1)
        for col in range(width):
            leaf = gethuff()
            if leaf is None:
                return None
            lenb, shl = leaf & 15, leaf >> 4
            b = br.get(lenb - shl)
            diff = (((b << 1) + 1) << shl) >> 1
            if lenb > 0 and (diff & (1 << (lenb - 1))) == 0:
                diff -= (1 << lenb) - (0 if shl else 1)
            if col < 2:
                vp[row & 1][col] = (vp[row & 1][col] + diff) & 0xFFFF
                hp[col] = vp[row & 1][col]
                v = hp[col]
            else:
                hp[col & 1] = (hp[col & 1] + diff) & 0xFFFF
                v = hp[col & 1]
            sv = v - 0x10000 if v >= 0x8000 else v
            out[row, col] = curve[min(max(sv, 0), 0x3FFF)]
    return out


def _nikon_raster(data: bytes, raw_ifd: dict, ifd0: dict, endian: str):
    """Decode a Nikon 34713 compressed CFA strip via the MakerNote
    0x0096 linearization block.  Reference semantics: LibRaw's NEF
    path as used by gui/image.rs:1886-1945."""
    from .. import native

    exif_ptr = ifd0.get(_T_EXIF_IFD)
    if exif_ptr is None:
        return None
    mn = _nikon_makernote(data, endian, int(np.atleast_1d(exif_ptr)[0]))
    if mn is None:
        return None
    emb, e2, first = mn
    entries = _ifd_entry_offsets(emb, first, e2)
    lin = entries.get(_T_NIKON_LINEARIZATION)
    if lin is None:
        return None
    _, cnt, voff = lin
    meta = emb[voff:voff + cnt]
    bps = int(_scalar(raw_ifd, _T_BITS, 12))
    if bps not in (12, 14):  # the only 34713 precisions; also bounds
        return None          # the 1 << bps curve allocation
    parsed = parse_nikon_linearization(meta, e2, bps)
    if parsed is None:
        return None
    vpred, curve, tree, split = parsed
    w = int(_scalar(raw_ifd, _T_WIDTH, 0))
    h = int(_scalar(raw_ifd, _T_LENGTH, 0))
    if w <= 0 or h <= 0 or w * h > 512_000_000 // 2:
        return None
    offs = np.atleast_1d(raw_ifd.get(_T_STRIP_OFFSETS, [])).astype(np.int64)
    if offs.size == 0:
        return None
    cnts = np.atleast_1d(raw_ifd.get(
        _T_STRIP_COUNTS, np.array([len(data) - offs[0]]))).astype(np.int64)
    stream = b"".join(bytes(data[o:o + c]) for o, c in zip(offs, cnts))
    return native.with_py_fallback(
        native.nef_huff_decode, _nef_decode_py,
        stream, vpred, curve, w, h, tree, split)


def sony_decrypt(buf: bytes, key: int) -> bytes:
    """Sony SR2-private-block stream cipher (published by dcraw/LibRaw:
    a 128-word LFSR seeded by key * 5^11 + 1 iterates, byte-swapped
    against the file's little-endian words).  XOR symmetric, so this
    both decrypts camera files and encrypts synthetic fixtures."""
    pad = [0] * 128
    k = key & 0xFFFFFFFF
    for p in range(4):
        k = (k * 48828125 + 1) & 0xFFFFFFFF
        pad[p] = k
    pad[3] = (pad[3] << 1 | (pad[0] ^ pad[2]) >> 31) & 0xFFFFFFFF
    for p in range(4, 127):
        pad[p] = ((pad[p - 4] ^ pad[p - 2]) << 1
                  | (pad[p - 3] ^ pad[p - 1]) >> 31) & 0xFFFFFFFF
    swap = np.array(pad, dtype=">u4").view(np.uint8)
    pad = list(np.frombuffer(swap.tobytes(), dtype="<u4").astype(np.int64))
    nwords = len(buf) // 4
    words = struct.unpack(f"<{nwords}I", buf[:nwords * 4])
    out = []
    p = 127
    for w in words:
        p += 1
        pad[(p - 1) & 127] = pad[p & 127] ^ pad[(p + 64) & 127]
        out.append(w ^ pad[(p - 1) & 127])
    return struct.pack(f"<{nwords}I", *out) + buf[nwords * 4:]


def sony_curve_lut(knees=None) -> np.ndarray:
    """Sony ARW2 tone-curve LUT: five segments with slopes 1,2,4,8,16
    between knee points from the decrypted SR2 tag 0x7010 (defaults to
    a single slope-16 ramp when the tag is absent).  The decoder maps
    an 11-bit value v to curve[v << 1] >> 2, so the LUT spans 0x1000."""
    kn = [0, 0, 0, 0, 0, 4095]
    if knees is not None:
        kv = [int(x) for x in np.atleast_1d(knees)[:4]]
        kn = [0] + [(v >> 2) & 0xFFF for v in kv] + [4095]
    curve = np.arange(0x1000, dtype=np.int64)
    for i in range(5):
        lo, hi = kn[i], kn[i + 1]
        if hi <= lo:
            continue
        j = np.arange(lo + 1, hi + 1, dtype=np.int64)
        curve[lo + 1:hi + 1] = curve[lo] + (j - lo) * (1 << i)
    return np.clip(curve, 0, 65535).astype(np.uint16)


def _sony_sr2(data: bytes, endian: str, ifd0: dict):
    """Decrypt and parse the SR2 private block (IFD0 tags 0x7200 offset /
    0x7201 length / 0x7221 key); returns the private IFD's tag dict with
    value offsets resolved against a spliced decrypted copy, or None."""
    try:
        off = int(_scalar(ifd0, _T_SONY_SR2_OFFSET, 0))
        length = int(_scalar(ifd0, _T_SONY_SR2_LENGTH, 0))
        key = int(_scalar(ifd0, _T_SONY_SR2_KEY, 0))
    except (TypeError, ValueError):
        return None
    if off <= 0 or length <= 0 or off + length > len(data):
        return None
    plain = sony_decrypt(bytes(data[off:off + length]), key)
    # the private block is a bare IFD whose value offsets are absolute
    # file offsets into the (decrypted) region
    patched = bytes(data[:off]) + plain + bytes(data[off + length:])
    ifd, _ = _read_ifd(patched, off, endian)
    return ifd or None


def _arw2_decode_py(data: bytes, curve, width: int, height: int,
                    row_stride: int | None = None):
    """Pure-Python mirror of ruppnative arw2_decode (fallback + oracle)."""
    stride = row_stride if row_stride is not None else width
    if width < 32 or height <= 0 or stride * height > len(data):
        return None
    out = np.zeros((height, width), dtype=np.uint16)
    for row in range(height):
        rp = row * stride
        col = 0
        dp = rp
        while col < width - 30:
            (val,) = struct.unpack_from("<I", data, dp)
            mx = val & 0x7FF
            mn = (val >> 11) & 0x7FF
            imax = (val >> 22) & 0x0F
            imin = (val >> 26) & 0x0F
            sh = 0
            while sh < 4 and (0x80 << sh) <= mx - mn:
                sh += 1
            bit = 30
            pix = [0] * 16
            for i in range(16):
                if i == imax:
                    pix[i] = mx
                elif i == imin:
                    pix[i] = mn
                else:
                    lo = data[dp + (bit >> 3)]
                    hi = data[dp + (bit >> 3) + 1] \
                        if dp + (bit >> 3) + 1 < len(data) else 0
                    word = lo | hi << 8
                    p = (((word >> (bit & 7)) & 0x7F) << sh) + mn
                    pix[i] = min(p, 0x7FF)
                    bit += 7
            for i in range(16):
                out[row, col] = curve[pix[i] << 1] >> 2
                col += 2
            col -= 1 if col & 1 else 31
            dp += 16
    return out


def _sony_levels(sr2: dict):
    """(black, wb_neutral|None) from the decrypted SR2 private block
    (black 0x7310, WB 0x7313) — shared by the ARW2 and lossless paths."""
    black = 0.0
    blk = sr2.get(_T_SONY_BLACK)
    if blk is not None:
        bv = np.atleast_1d(blk).astype(np.float64)
        if bv.size >= 1 and np.all((bv >= 0) & (bv < 65536)):
            black = float(bv.mean())
    wb = None
    wbv = sr2.get(_T_SONY_WB_RGGB)
    if wbv is not None and _plausible_wb4(np.atleast_1d(wbv)[:4]):
        r, g1, g2, b = (float(x) for x in np.atleast_1d(wbv)[:4])
        g = (g1 + g2) / 2.0
        wb = np.array([g / r, 1.0, g / b])
    return black, wb


def _sony_lossless_raster(data: bytes, raw_ifd: dict, ifd0: dict,
                          endian: str):
    """Sony lossless-compressed ARW (the ARW4 class): the raster is a
    standard lossless-JPEG (SOF3, ITU-T T.81 process 14) stream whose
    samples are 4-component 2x2 Bayer quads at half spatial resolution
    — LibRaw decodes these with its ljpeg core the same way (the
    reference reaches it through FFI, gui/image.rs:1839-1962).  The
    existing LJ92 core (native/ruppnative.cpp) is the codec; this
    wrapper re-interleaves the quads onto the full-resolution mosaic
    and pulls black/WB from the SR2 private block like the ARW2 path.
    Returns (mosaic, black, wb, white|None) or None."""
    from .. import native

    w = int(_scalar(raw_ifd, _T_WIDTH, 0))
    h = int(_scalar(raw_ifd, _T_LENGTH, 0))
    if w <= 0 or h <= 0 or w % 2 or h % 2 \
            or w * h > 512_000_000 // 2:
        return None
    offs = np.atleast_1d(raw_ifd.get(_T_STRIP_OFFSETS, [])).astype(
        np.int64)
    if offs.size == 0:
        return None                 # tiled (0x0144) layouts: fail closed
    cnts = np.atleast_1d(raw_ifd.get(
        _T_STRIP_COUNTS, np.array([len(data) - offs[0]]))).astype(
        np.int64)
    if cnts.size != offs.size:
        return None
    # each strip is an independent LJ92 stream (standard TIFF strip
    # semantics); decode per strip and stack — a single concatenated
    # decode would return only the first strip's rows
    parts = []
    stride = None
    for o, c in zip(offs, cnts):
        dec = native.lj92_decode(bytes(data[o:o + c]))
        if dec is None:
            return None
        if stride is None:
            stride = dec.shape[1]
        elif dec.shape[1] != stride:
            return None
        parts.append(dec)
    dec = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    hj = dec.shape[0]
    if hj == h and stride == w:
        mosaic = dec.copy()                 # 1-component variant
    elif hj * 2 == h and stride == w * 2:
        quad = dec.reshape(hj, w // 2, 4)
        mosaic = np.zeros((h, w), np.uint16)
        mosaic[0::2, 0::2] = quad[:, :, 0]
        mosaic[0::2, 1::2] = quad[:, :, 1]
        mosaic[1::2, 0::2] = quad[:, :, 2]
        mosaic[1::2, 1::2] = quad[:, :, 3]
    else:
        return None
    sr2 = _sony_sr2(data, endian, ifd0) or {}
    black, wb = _sony_levels(sr2)
    return mosaic, black, wb, None


def _sony_raster(data: bytes, raw_ifd: dict, ifd0: dict, endian: str):
    """Decode a Sony compression-32767 CFA raster: ARW2 packed blocks
    when the strip is 1 byte/pixel, plain little-endian u16 when it is
    2 bytes/pixel.  Returns (mosaic, black, wb_neutral, white|None)
    or None (white is None when the IFD's BitsPerSample governs)."""
    from .. import native

    w = int(_scalar(raw_ifd, _T_WIDTH, 0))
    h = int(_scalar(raw_ifd, _T_LENGTH, 0))
    if w <= 0 or h <= 0 or w * h > 512_000_000 // 2:
        return None
    offs = np.atleast_1d(raw_ifd.get(_T_STRIP_OFFSETS, [])).astype(np.int64)
    if offs.size == 0:
        return None
    cnts = np.atleast_1d(raw_ifd.get(
        _T_STRIP_COUNTS, np.array([len(data) - offs[0]]))).astype(np.int64)
    stream = b"".join(bytes(data[o:o + c]) for o, c in zip(offs, cnts))

    sr2 = _sony_sr2(data, endian, ifd0) or {}
    black, wb = _sony_levels(sr2)

    # BitsPerSample governs the strip layout (8 -> ARW2 packed blocks;
    # anything else with a 2-byte/pixel strip -> plain little-endian
    # u16 — ARW writers declare 12/14/16 for uncompressed rasters); the
    # strip-length check is a consistency guard — some ARW2 writers pad
    # strip byte counts, so length alone would misread a packed raster
    # as u16 garbage.
    bps = int(_scalar(raw_ifd, _T_BITS, 0))
    if bps != 8 and len(stream) >= 2 * w * h:
        mosaic = np.frombuffer(stream, dtype="<u2",
                               count=w * h).reshape(h, w).copy()
        return mosaic, black, wb, None
    if len(stream) >= w * h:
        curve = sony_curve_lut(sr2.get(_T_SONY_CURVE))
        mosaic = native.with_py_fallback(
            native.arw2_decode, _arw2_decode_py, stream, curve, w, h)
        if mosaic is None:
            return None
        # black (SR2 0x7310) is quoted in the post-curve domain already;
        # white is the largest value the curve can emit
        white = float(curve[0x7FF << 1] >> 2)
        return mosaic, black, wb, white
    return None


def _white_for_bits(bits: int | None, mosaic: np.ndarray) -> float:
    if bits and 2 <= bits <= 16:
        return float((1 << bits) - 1)
    mx = int(mosaic.max()) if mosaic.size else 0
    for cand in (4095, 16383, 65535):
        if mx <= cand:
            return float(cand)
    return 65535.0


def parse_cr2(data: bytes) -> RawImage | None:
    """Canon CR2 -> RawImage (mosaic + CFA + WB), or None."""
    from .. import native

    if not is_cr2(data):
        return None
    endian = "<"
    (raw_ifd_off,) = struct.unpack_from("<I", data, 12)
    raw_ifd, _ = _read_ifd(data, raw_ifd_off, endian)
    if not raw_ifd or _T_STRIP_OFFSETS not in raw_ifd:
        return None
    comp = int(_scalar(raw_ifd, _T_COMPRESSION, 0))
    if comp not in (6, 7):  # old-jpeg marker Canon uses for SOF3 / new
        return None
    offs = np.atleast_1d(raw_ifd[_T_STRIP_OFFSETS]).astype(np.int64)
    cnts = np.atleast_1d(raw_ifd.get(
        _T_STRIP_COUNTS, np.array([len(data)]))).astype(np.int64)
    stream = bytes(data[offs[0]:offs[0] + cnts[0]])
    decoded = native.lj92_decode(stream)
    if decoded is None:
        return None
    precision = _sof3_precision(stream)

    h = int(_scalar(raw_ifd, _T_LENGTH, decoded.shape[0]))
    w = int(_scalar(raw_ifd, _T_WIDTH, decoded.shape[1]))
    if h <= 0 or w <= 0 or h * w > 512_000_000 // 2:
        return None
    if decoded.size != h * w:
        # fall back to the stream's own geometry
        h, w = decoded.shape
    flat = decoded.reshape(-1)
    mosaic = np.zeros((h, w), dtype=np.uint16)
    slices = raw_ifd.get(_T_CR2_SLICES)
    if slices is not None and np.atleast_1d(slices).size == 3:
        # vertical slices: n full slices of width sw, then the last one;
        # the decoded sample sequence fills slice 0 top-to-bottom, then
        # slice 1, ... (Canon CR2 layout)
        n_s, sw, last = (int(x) for x in np.atleast_1d(slices))
        widths = [sw] * n_s + [last]
        if sum(widths) != w or any(x <= 0 for x in widths):
            return None
        pos = 0
        x0 = 0
        for ws in widths:
            count = h * ws
            if pos + count > flat.size:
                return None
            mosaic[:, x0:x0 + ws] = flat[pos:pos + count].reshape(h, ws)
            pos += count
            x0 += ws
    else:
        mosaic[:] = flat[:h * w].reshape(h, w)

    ifds = list(_all_ifds(data, endian, struct.unpack_from("<I", data,
                                                           4)[0]))
    ifd0 = ifds[0] if ifds else {}
    exif_ptr = ifd0.get(_T_EXIF_IFD)
    wb = None
    if exif_ptr is not None:
        try:
            wb = _canon_wb(data, endian, int(np.atleast_1d(exif_ptr)[0]))
        except Exception:
            wb = None
    return RawImage(
        mosaic=mosaic, cfa=_RGGB.copy(), black=0.0,
        white=_white_for_bits(precision, mosaic),
        as_shot_neutral=wb, color_matrix=None,
        orientation=int(_scalar(ifd0, _T_ORIENTATION, 1)))


def parse_tiff_cfa(data: bytes) -> RawImage | None:
    """Generic TIFF-EP raw (NEF/uncompressed ARW/PEF class): find the
    CFA-photometric IFD and decode its raster with the shared DNG
    machinery (strips/tiles, uncompressed or LJ92)."""
    endian = _tiff_endian(data)
    if endian is None:
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
        if photo is not None and int(photo) == _PHOTO_CFA:
            raw_ifd = ifd
            break
    if raw_ifd is None:
        return None

    make = ifd0.get(_T_MAKE, b"")
    make = make.decode("ascii", "replace") if isinstance(make, bytes) \
        else str(make)
    comp = int(_scalar(raw_ifd, _T_COMPRESSION, 1))
    black = 0.0
    white = None
    wb = None

    mosaic = None
    if comp == 7 and make.upper().startswith("SONY"):
        # ARW4-class lossless: the LJ92 stream carries half-res
        # 4-component Bayer quads — the generic single-component
        # reshape in _raster would silently scramble it, and the quad
        # sizes satisfy its dec.size == h*w check exactly, so this
        # path FAILS CLOSED: any layout _sony_lossless_raster does not
        # recognize (tiled rasters, inconsistent strips) hashes the
        # embedded preview instead of garbage pixels.
        try:
            sony4 = _sony_lossless_raster(data, raw_ifd, ifd0, endian)
        except Exception:
            sony4 = None
        if sony4 is None:
            return None
        mosaic, black, wb, white = sony4
    if mosaic is None:
        mosaic = _raster(data, raw_ifd, endian)
    if mosaic is None and comp == _COMP_NIKON:
        try:
            mosaic = _nikon_raster(data, raw_ifd, ifd0, endian)
        except Exception:
            mosaic = None
    if mosaic is None and comp == _COMP_SONY:
        try:
            sony = _sony_raster(data, raw_ifd, ifd0, endian)
        except Exception:
            sony = None
        if sony is not None:
            mosaic, black, wb, white = sony
    if mosaic is None:
        return None

    cfa = _RGGB.copy()
    pat = raw_ifd.get(_T_CFA_PATTERN)
    if pat is not None:
        p = np.atleast_1d(pat).astype(np.int32)
        if p.size >= 4:
            cfa = p[:4].reshape(2, 2)

    exif_ptr = ifd0.get(_T_EXIF_IFD)
    if wb is None and exif_ptr is not None \
            and make.upper().startswith("NIKON"):
        try:
            wb = _nikon_wb(data, endian, int(np.atleast_1d(exif_ptr)[0]))
        except Exception:
            wb = None
    bits = int(_scalar(raw_ifd, _T_BITS, 16))
    if white is None:
        white = _white_for_bits(bits, mosaic)
    return RawImage(
        mosaic=mosaic, cfa=cfa, black=black, white=white,
        as_shot_neutral=wb, color_matrix=None,
        orientation=int(_scalar(ifd0, _T_ORIENTATION, 1)))


# --------------------------------------------------------------------------
# Fujifilm RAF (gui/image.rs:1886-1945 decodes it via LibRaw; the RAF
# container layout — big-endian offset table at 0x54, tagged CFA meta
# records, packed/u16 raster — is published format knowledge carried by
# exiftool's RAF.pm and dcraw's parse_fuji)
# --------------------------------------------------------------------------

_RAF_MAGIC = b"FUJIFILMCCD-RAW "
_RAF_T_DIMS = 0x0100        # raw height u16be, width u16be
_RAF_T_LAYOUT = 0x0130      # fuji layout byte
_RAF_T_XTRANS = 0x0131      # 6x6 CFA pattern, 36 bytes (&3: 0=R 1=G 2=B)
_RAF_T_WB = 0x2FF0          # WB levels u16be x4, order (G, R, G2, B)
_RAF_T_BITS = 0x0121        # sample bits (not always present)


def is_raf(data: bytes) -> bool:
    return data[:16] == _RAF_MAGIC


def _unpack_lsb(stream: bytes, bits: int, count: int) -> np.ndarray:
    """LSB-first n-bit little-endian unpack (the Fuji packed raster
    layout: low bits of each sample come first in the byte stream)."""
    need = (count * bits + 7) // 8
    if len(stream) < need:
        raise ValueError("short packed stream")
    b = np.unpackbits(np.frombuffer(stream, np.uint8, count=need),
                      bitorder="little")[:count * bits]
    w = (1 << np.arange(bits, dtype=np.uint32))
    return (b.reshape(count, bits).astype(np.uint32) * w).sum(
        axis=1).astype(np.uint16)


def _raf_gclass(g: int) -> int:
    if g < 16:
        return 0
    if g < 64:
        return 1
    if g < 256:
        return 2
    return 3


def raf_compressed_decode_py(data: bytes, width: int, height: int,
                             xtrans: np.ndarray) -> np.ndarray | None:
    """Pure-Python oracle for ruppnative.cpp raf_decode (the Fuji
    lossless compressed class): 'IS' header, u32 stripe-size table,
    independently-coded vertical stripes with nearest-same-color
    left/up prediction on the 6x6 lattice and per-(color, gradient
    class) adaptive Golomb-Rice.  Strict: exact consumption +
    sample-range gates (foreign bitstreams reject)."""
    from .cr3 import ESCAPE_Q, RESET_N

    if len(data) < 16 or data[0:3] != b"IS\x01":
        return None
    bits = data[4]
    if not (8 <= bits <= 16):
        return None
    hh = (data[5] << 8) | data[6]
    ww = (data[9] << 8) | data[10]
    block_size = (data[11] << 8) | data[12]
    blocks = data[13]
    if hh != height or ww != width or block_size < 1 \
            or blocks != -(-width // block_size):
        return None
    p = 16
    if p + 4 * blocks > len(data):
        return None
    ssz = [struct.unpack_from(">I", data, p + 4 * i)[0]
           for i in range(blocks)]
    p += 4 * blocks
    if p + sum(ssz) != len(data):
        return None
    xt = np.asarray(xtrans, dtype=np.int64) & 3
    dleft = np.zeros((6, 6), np.int64)
    dup = np.zeros((6, 6), np.int64)
    for rm in range(6):
        for cm in range(6):
            k = xt[rm, cm]
            dleft[rm, cm] = next(d for d in range(1, 7)
                                 if xt[rm, (cm - d) % 6] == k)
            dup[rm, cm] = next(d for d in range(1, 7)
                               if xt[(rm - d) % 6, cm] == k)
    out = np.zeros((height, width), np.uint16)
    maxv = (1 << bits) - 1
    for s in range(blocks):
        c0 = s * block_size
        c1 = min(c0 + block_size, width)
        br = _MsbBits(data[p:p + ssz[s]])
        ctx = [[[4, 1] for _ in range(4)] for _ in range(3)]
        for r in range(height):
            for c in range(c0, c1):
                rm, cm = r % 6, c % 6
                k = int(xt[rm, cm])
                dl, du = int(dleft[rm, cm]), int(dup[rm, cm])
                has_a = c - dl >= c0
                has_b = r - du >= 0
                a = int(out[r, c - dl]) if has_a else 0
                b = int(out[r - du, c]) if has_b else 0
                if has_a and has_b:
                    pred = (a + b) >> 1
                    cx = ctx[k][_raf_gclass(abs(a - b))]
                elif has_a:
                    pred = a
                    cx = ctx[k][0]
                elif has_b:
                    pred = b
                    cx = ctx[k][0]
                else:
                    pred = 0
                    cx = ctx[k][0]
                kk = 0
                while (cx[1] << kk) < cx[0] and kk < 15:
                    kk += 1
                q = 0
                while q <= ESCAPE_Q and br.get(1) == 0:
                    q += 1
                if q > ESCAPE_Q:
                    return None
                if q == ESCAPE_Q:
                    u = br.get(bits + 2)
                else:
                    u = (q << kk) | br.get(kk)
                err = -((u + 1) >> 1) if u & 1 else u >> 1
                v = pred + err
                if v < 0 or v > maxv:
                    return None
                out[r, c] = v
                cx[0] += u
                cx[1] += 1
                if cx[1] == RESET_N:
                    cx[0] >>= 1
                    cx[1] >>= 1
        if br.pos - br.nacc // 8 != ssz[s]:
            return None
        p += ssz[s]
    return out


def parse_raf(data: bytes) -> RawImage | None:
    """Fujifilm RAF -> RawImage.  Supports plain u16-LE and LSB-packed
    12/14-bit CFA rasters with Bayer or X-Trans (6x6, record 0x0131)
    patterns, and Fuji's lossless-compressed class ('IS'-headered
    striped rasters, raf_decode) for both lattices; unrecognized
    compressed rasters fall back to the embedded preview (the same
    source the reference hashes, scanner.rs:1353-1380)."""
    if not is_raf(data) or len(data) < 0x70:
        return None
    try:
        (_joff, _jlen, hdr_off, hdr_len,
         cfa_off, cfa_len) = struct.unpack_from(">6I", data, 0x54)
    except struct.error:
        return None
    if not hdr_off or hdr_off + 4 > len(data):
        return None
    recs: dict[int, bytes] = {}
    (count,) = struct.unpack_from(">I", data, hdr_off)
    p = hdr_off + 4
    for _ in range(min(count, 512)):
        if p + 4 > len(data):
            break
        tag, size = struct.unpack_from(">HH", data, p)
        p += 4
        recs[tag] = bytes(data[p:p + size])
        p += size
    dims = recs.get(_RAF_T_DIMS)
    if dims is None or len(dims) < 4:
        return None
    h, w = struct.unpack_from(">HH", dims, 0)
    if not (4 <= h <= 20000 and 4 <= w <= 20000):
        return None

    cfa = _RGGB.copy()
    xt = recs.get(_RAF_T_XTRANS)
    if xt is not None and len(xt) >= 36:
        # the record stores the pattern REVERSED (published decoders
        # fill xtrans_abs[0][35 - c] byte by byte): un-reverse before
        # reshaping or the grid comes out 180-degree rotated
        grid = (np.frombuffer(xt, np.uint8, count=36)[::-1]
                & 3).reshape(6, 6)
        if np.all(grid <= 2):
            # some Bayer bodies fill the record with a 2x2-periodic
            # pattern; collapse so the Malvar path handles them
            t = np.tile(grid[:2, :2], (3, 3))
            cfa = grid[:2, :2].copy() if np.array_equal(t, grid) \
                else grid.astype(np.int64)

    wb = None
    wbrec = recs.get(_RAF_T_WB)
    if wbrec is not None and len(wbrec) >= 8:
        # published layout (dcraw: FORC4 cam_mul[c ^ 1] = get2()):
        # stored order is G, R, G2, B — the third value is the second
        # green, NOT blue
        g, r, _g2, b = struct.unpack_from(">4H", wbrec, 0)
        if r > 0 and b > 0 and g > 0:
            wb = np.array([g / r, 1.0, g / b])

    if cfa_off <= 0 or cfa_off >= len(data):
        return None
    stream = bytes(data[cfa_off:cfa_off + cfa_len]) if cfa_len \
        else bytes(data[cfa_off:])
    npx = w * h
    bits = None
    brec = recs.get(_RAF_T_BITS)
    if brec is not None and len(brec) >= 2:
        bits = struct.unpack_from(">H", brec, 0)[0]
    mosaic = None
    if stream[:3] == b"IS\x01":
        # Fuji lossless-compressed class: the 6x6 lattice drives the
        # same-color prediction (a tiled 2x2 for Bayer bodies); the
        # decoder's header-dims / exact-consumption / range gates
        # reject any uncompressed raster that happens to share the
        # leading bytes, falling through to the size-based branches
        from .. import native
        lattice6 = (np.asarray(cfa) if np.asarray(cfa).shape == (6, 6)
                    else np.tile(np.asarray(cfa), (3, 3)))
        m = native.with_py_fallback(
            native.raf_decode, raf_compressed_decode_py,
            stream, w, h, lattice6)
        if m is not None:
            mosaic = m
            bits = stream[4]
    if mosaic is not None:
        pass
    elif len(stream) >= 2 * npx:
        mosaic = np.frombuffer(stream, "<u2", count=npx).reshape(h, w)
        mosaic = mosaic.copy()
    elif len(stream) >= (npx * 14 + 7) // 8 and bits in (None, 14):
        mosaic = _unpack_lsb(stream, 14, npx).reshape(h, w)
        bits = 14
    elif len(stream) >= (npx * 12 + 7) // 8:
        mosaic = _unpack_lsb(stream, 12, npx).reshape(h, w)
        bits = 12
    else:
        return None  # unknown compressed RAF: embedded-preview fallback
    if bits is None:
        bits = 16 if mosaic.max() > 16383 else 14
    return RawImage(mosaic=mosaic, cfa=np.asarray(cfa), black=0.0,
                    white=_white_for_bits(bits, mosaic),
                    as_shot_neutral=wb, color_matrix=None,
                    orientation=1)


# --------------------------------------------------------------------------
# Panasonic RW2 (reference decodes via LibRaw, gui/image.rs:1886-1945;
# the container is TIFF-shaped with magic 0x55 and PanasonicRaw tags —
# published format knowledge, exiftool PanasonicRaw.pm)
# --------------------------------------------------------------------------

_RW2_T_SENSOR_W = 0x0002
_RW2_T_SENSOR_H = 0x0003
_RW2_T_BORDERS = (0x0004, 0x0005, 0x0006, 0x0007)  # top,left,bottom,right
_RW2_T_CFA = 0x0009
_RW2_T_BITS = 0x000A
_RW2_T_BLACK = (0x001C, 0x001D, 0x001E)
_RW2_T_WB = (0x0024, 0x0025, 0x0026)               # R, G, B levels
_RW2_T_RAW_FORMAT = 0x002D                          # 6/7 = cell schemes
_RW2_T_RAW_OFFSET = 0x0118

# CFAPattern tag value -> 2x2 site grid (exiftool: 1 = [Red,Green][Green,Blue])
_RW2_CFA = {1: [[0, 1], [1, 2]], 2: [[1, 0], [2, 1]],
            3: [[1, 2], [0, 1]], 4: [[2, 1], [1, 0]]}


def is_rw2(data: bytes) -> bool:
    return data[:4] == b"II\x55\x00"


class _PanaBits:
    """The RW2 bitstream reader: 0x4000-byte blocks stored tail-first
    (last 0x2008 bytes consumed before the first 0x1ff8), a 17-bit
    down-counting position register.  Mirrors the C++ core
    (ruppnative.cpp rw2::pana_bits) for the differential oracle."""

    LF = 0x2008

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = b"\0" * 0x4000
        self.vbits = 0

    def get(self, nbits: int) -> int:
        if not self.vbits:
            blk = self.data[self.pos:self.pos + 0x4000]
            blk = blk + b"\0" * (0x4000 - len(blk))
            n1 = 0x4000 - self.LF
            self.buf = blk[n1:] + blk[:n1]
            self.pos += 0x4000
        self.vbits = (self.vbits - nbits) & 0x1FFFF
        # 16-byte cells consumed tail-first (see ruppnative.cpp)
        byte = (self.vbits >> 3) ^ 0x3FF0
        hi = self.buf[byte + 1] if byte + 1 < 0x4000 else 0
        return ((self.buf[byte] | hi << 8) >> (self.vbits & 7)) & \
            ((1 << nbits) - 1)


def _rw2_decode_py(data: bytes, width: int, height: int) -> np.ndarray:
    """Pure-Python RW2 12-bit predictive decode (oracle for the C++
    core): per-14-pixel groups, two parity predictors, 2-bit shift code
    every third pixel."""
    pb = _PanaBits(data)
    out = np.empty((height, width), np.uint16)
    pred = [0, 0]
    nonz = [0, 0]
    sh = 0
    for row in range(height):
        orow = out[row]
        for col in range(width):
            i = col % 14
            if i == 0:
                pred[0] = pred[1] = nonz[0] = nonz[1] = 0
            if i % 3 == 2:
                sh = 4 >> (3 - pb.get(2))
            p = i & 1
            if nonz[p]:
                j = pb.get(8)
                if j:
                    pred[p] -= 0x80 << sh
                    if pred[p] < 0 or sh == 4:
                        pred[p] &= ~(-1 << sh)
                    pred[p] += j << sh
            else:
                nonz[p] = pb.get(8)
                if nonz[p] or i > 11:
                    pred[p] = nonz[p] << 4 | pb.get(4)
            orow[col] = max(0, min(0xFFFF, pred[col & 1]))
    return out


def rw2_v6_decode_py(data: bytes, width: int, height: int
                     ) -> np.ndarray | None:
    """Pure-Python oracle for ruppnative rw2_v6_decode (RawFormat 6):
    16-byte pages of 11 pixels — two full 14-bit pixels then three
    groups of a 2-bit scale selector (3 -> shift 4) and three 10-bit
    midpoint-relative deltas applied to odd/even base channels.  The
    page bit-slicing layout is the published one; the reconstruction
    is the family rule (see ruppnative.cpp)."""
    bpr = -(-width // 11)
    if len(data) != bpr * 16 * height:
        return None
    out = np.empty((height, width), np.uint16)
    vidx = ((3, 4, 5), (7, 8, 9), (11, 12, 13))
    sidx = (2, 6, 10)
    for row in range(height):
        r0 = row * bpr * 16
        for blk in range(bpr):
            b = data[r0 + blk * 16:r0 + blk * 16 + 16]
            e = [0] * 14
            e[0] = (b[3] << 6) | (b[2] >> 2)
            e[1] = (((b[2] & 3) << 12) | (b[1] << 4)
                    | (b[0] >> 4)) & 0x3fff
            e[2] = (b[0] >> 2) & 3
            e[3] = ((b[0] & 3) << 8) | b[7]
            e[4] = ((b[6] << 2) | (b[5] >> 6)) & 0x3ff
            e[5] = ((b[5] & 0x3f) << 4) | (b[4] >> 4)
            e[6] = (b[4] >> 2) & 3
            e[7] = ((b[4] & 3) << 8) | b[11]
            e[8] = ((b[10] << 2) | (b[9] >> 6)) & 0x3ff
            e[9] = ((b[9] << 4) | (b[8] >> 4)) & 0x3ff
            e[10] = (b[8] >> 2) & 3
            e[11] = ((b[8] & 3) << 8) | b[15]
            e[12] = ((b[14] << 2) | (b[13] >> 6)) & 0x3ff
            e[13] = ((b[13] << 4) | (b[12] >> 4)) & 0x3ff
            oddeven = [e[0], e[1]]
            px = [e[0], e[1]] + [0] * 9
            for g in range(3):
                sel = e[sidx[g]]
                sh = 4 if sel == 3 else sel
                for k in range(3):
                    pixi = 2 + g * 3 + k
                    v = e[vidx[g][k]] - 0x200
                    r = oddeven[pixi & 1] + (v << sh)
                    r = 0 if r < 0 else (0x3fff if r > 0x3fff else r)
                    px[pixi] = r
                    oddeven[pixi & 1] = r
            for k in range(11):
                col = blk * 11 + k
                if col < width:
                    out[row, col] = px[k]
    return out


def rw2_v7_decode_py(data: bytes, width: int, height: int,
                     bps: int) -> np.ndarray | None:
    """Pure-Python oracle for ruppnative rw2_v7_decode (RawFormat 7):
    fixed-rate 16-byte blocks, 9x14-bit or 10x12-bit little-endian
    packed pixels, rows block-aligned."""
    if bps not in (12, 14):
        return None
    ppb = 9 if bps == 14 else 10
    bpr = -(-width // ppb)
    if len(data) != bpr * 16 * height:
        return None
    blocks = np.frombuffer(data, np.uint8).reshape(height, bpr, 16)
    bits = np.unpackbits(blocks, axis=-1,
                         bitorder="little")   # (h, bpr, 128)
    w = (1 << np.arange(bps, dtype=np.uint32))
    vals = (bits[:, :, :ppb * bps].reshape(height, bpr, ppb, bps)
            .astype(np.uint32) * w).sum(axis=-1)
    return vals.reshape(height, bpr * ppb)[:, :width].astype(np.uint16)


def parse_rw2(data: bytes) -> RawImage | None:
    """Panasonic RW2 -> RawImage: sensor raster (plain u16-LE, the
    classic 12-bit predictive bitstream, or the v6/v7 cell schemes
    routed by RawFormat tag 0x002D), active-area crop from the sensor
    border tags, WB from the 0x0024-0x0026 levels (G-relative
    multiplier numerators), CFA from tag 0x0009."""
    from .. import native

    if not is_rw2(data) or len(data) < 8:
        return None
    (first,) = struct.unpack_from("<I", data, 4)
    ifd, _ = _read_ifd(data, first, "<")
    if not ifd:
        return None
    sw = int(_scalar(ifd, _RW2_T_SENSOR_W, 0))
    sh_ = int(_scalar(ifd, _RW2_T_SENSOR_H, 0))
    if not (4 <= sw <= 20000 and 4 <= sh_ <= 20000):
        return None
    off = int(_scalar(ifd, _RW2_T_RAW_OFFSET, 0))
    if off <= 0 or off >= len(data):
        return None
    stream = bytes(data[off:])
    bits = int(_scalar(ifd, _RW2_T_BITS, 12))
    raw_format = int(_scalar(ifd, _RW2_T_RAW_FORMAT, 0))
    npx = sw * sh_
    mosaic = None
    if raw_format == 6:
        need = -(-sw // 11) * 16 * sh_
        blob = stream[:need]
        mosaic = native.with_py_fallback(
            native.rw2_v6_decode, rw2_v6_decode_py, blob, sw, sh_)
        if mosaic is None:
            return None   # short raster: preview fallback
        bits = 14
    elif raw_format == 7:
        bps = bits if bits in (12, 14) else 14
        ppb = 9 if bps == 14 else 10
        need = -(-sw // ppb) * 16 * sh_
        blob = stream[:need]
        mosaic = native.with_py_fallback(
            native.rw2_v7_decode, rw2_v7_decode_py, blob, sw, sh_, bps)
        if mosaic is None:
            return None
        bits = bps
    elif len(stream) >= 2 * npx:
        mosaic = np.frombuffer(stream, "<u2", count=npx).reshape(
            sh_, sw).copy()
    else:
        mosaic = native.with_py_fallback(
            native.rw2_decode, _rw2_decode_py, stream, sw, sh_)
        bits = 12  # the predictive bitstream is 12-bit

    # active-area crop (top, left, bottom, right sensor borders)
    t, le, bo, ri = (int(_scalar(ifd, tag, 0))
                     for tag in _RW2_T_BORDERS)
    if 0 <= t < bo <= sh_ and 0 <= le < ri <= sw:
        mosaic = mosaic[t:bo, le:ri]
        # keep the CFA phase: odd top/left shifts the 2x2 alignment,
        # handled below by rolling the pattern
        phase = (t & 1, le & 1)
    else:
        phase = (0, 0)

    cfa = np.asarray(_RW2_CFA.get(int(_scalar(ifd, _RW2_T_CFA, 1)),
                                  _RW2_CFA[1]), np.int64)
    cfa = np.roll(cfa, (-phase[0], -phase[1]), axis=(0, 1))

    black = 0.0
    blks = [_scalar(ifd, tag) for tag in _RW2_T_BLACK]
    vals = [float(v) for v in blks if v is not None]
    if vals and all(0 <= v < 65536 for v in vals):
        black = sum(vals) / len(vals)

    wb = None
    wbv = [_scalar(ifd, tag) for tag in _RW2_T_WB]
    if all(v is not None for v in wbv):
        r, g, b = (float(v) for v in wbv)
        if r > 0 and g > 0 and b > 0:
            wb = np.array([g / r, 1.0, g / b])

    return RawImage(
        mosaic=mosaic, cfa=cfa, black=black,
        white=float((1 << bits) - 1), as_shot_neutral=wb,
        color_matrix=None,
        orientation=int(_scalar(ifd, _T_ORIENTATION, 1)))


# --------------------------------------------------------------------------
# Olympus ORF (reference decodes via LibRaw, gui/image.rs:1886-1945;
# the container is TIFF-shaped with an "RO"/"SR" magic word and the
# raster is either packed 12-bit or "Olympus compressed" — published
# format knowledge, exiftool Olympus.pm + the dcraw/LibRaw decoder
# semantics reimplemented in ruppnative.cpp orf_decode)
# --------------------------------------------------------------------------

_ORF_MAGICS = (b"IIRO", b"IIRS", b"MMOR")
_T_ORF_RED_BALANCE = 0x1017    # MakerNote, x256
_T_ORF_BLUE_BALANCE = 0x1018


def is_orf(data: bytes) -> bool:
    return data[:4] in _ORF_MAGICS


class _MsbBits:
    """MSB-first bit reader (the ORF compressed stream layout)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nacc = 0

    def get(self, n: int) -> int:
        while self.nacc < n:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nacc += 8
        self.nacc -= n
        return (self.acc >> self.nacc) & ((1 << n) - 1)


def _orf_decode_py(data: bytes, width: int, height: int) -> np.ndarray:
    """Pure-Python Olympus-compressed decode (oracle for the C++ core):
    3-bit sign+low field, unary magnitude class (zero-run length = the
    class, 12 zeros escape to an explicit field), per-parity carry
    state with adaptive low-bit width, two-row/two-column gradient
    predictor."""
    bits = _MsbBits(data[7:])      # 7-byte preamble
    # u16 raster with mod-65536 wrap (the published decoder's ushort
    # semantics); predictions read the stored value
    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(width):
            carry = acarry[col & 1]
            i = 2 * (carry[2] < 3)
            nbits = 2 + i
            while (carry[0] & 0xFFFF) >> (nbits + i):
                nbits += 1
            field = bits.get(3)
            low = field & 3
            sign = -1 if field & 4 else 0
            high = 0
            while high < 12 and bits.get(1) == 0:
                high += 1
            if high == 12:
                high = bits.get(16 - nbits) >> 1
            carry[0] = (high << nbits) | bits.get(nbits)
            diff = (carry[0] ^ sign) + carry[1]
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if carry[0] > 16 else carry[2] + 1
            if row < 2 and col < 2:
                pred = 0
            elif row < 2:
                pred = int(out[row, col - 2])
            elif col < 2:
                pred = int(out[row - 2, col])
            else:
                w_ = int(out[row, col - 2])
                n_ = int(out[row - 2, col])
                nw = int(out[row - 2, col - 2])
                if (w_ < nw < n_) or (n_ < nw < w_):
                    if abs(w_ - nw) > 32 or abs(n_ - nw) > 32:
                        pred = w_ + n_ - nw
                    else:
                        pred = (w_ + n_) >> 1
                else:
                    pred = w_ if abs(w_ - nw) > abs(n_ - nw) else n_
            out[row, col] = (pred + ((diff << 2) | low)) & 0xFFFF
    return out


def _orf_wb(data: bytes, endian: str, ifd0: dict):
    """WB from the Olympus MakerNote (RedBalance/BlueBalance, x256)."""
    exif_ptr = ifd0.get(_T_EXIF_IFD)
    if exif_ptr is None:
        return None
    try:
        exif_entries = _ifd_entry_offsets(
            data, int(np.atleast_1d(exif_ptr)[0]), endian)
        mn = exif_entries.get(_T_MAKERNOTE)
        if mn is None:
            return None
        _, _, mn_off = mn
        # 'OLYMP\0' header then a bare IFD (older MakerNote layout)
        if data[mn_off:mn_off + 5] == b"OLYMP":
            mn_off += 8
        mn_ifd, _ = _read_ifd(data, mn_off, endian)
        r = _scalar(mn_ifd, _T_ORF_RED_BALANCE)
        b = _scalar(mn_ifd, _T_ORF_BLUE_BALANCE)
        if r is None or b is None:
            return None
        r, b = float(r) / 256.0, float(b) / 256.0
        if r <= 0 or b <= 0:
            return None
        return np.array([1.0 / r, 1.0, 1.0 / b])
    except Exception:
        return None


def parse_orf(data: bytes) -> RawImage | None:
    """Olympus ORF -> RawImage: u16-LE, LSB-packed 12-bit, or the
    Olympus-compressed raster; WB from MakerNote Red/BlueBalance."""
    from .. import native

    if not is_orf(data) or len(data) < 8:
        return None
    endian = "<" if data[:2] == b"II" else ">"
    (first,) = struct.unpack_from(endian + "I", data, 4)
    ifds = list(_all_ifds(data, endian, first))
    if not ifds:
        return None
    ifd0 = ifds[0]
    raw_ifd = None
    for ifd in ifds:
        if _T_STRIP_OFFSETS in ifd and _scalar(ifd, _T_WIDTH, 0):
            raw_ifd = ifd
            break
    if raw_ifd is None:
        return None
    w = int(_scalar(raw_ifd, _T_WIDTH, 0))
    h = int(_scalar(raw_ifd, _T_LENGTH, 0))
    if not (4 <= w <= 20000 and 4 <= h <= 20000):
        return None
    offs = np.atleast_1d(raw_ifd.get(_T_STRIP_OFFSETS, [])).astype(
        np.int64)
    if offs.size == 0 or offs[0] <= 0 or offs[0] >= len(data):
        return None
    cnts = np.atleast_1d(raw_ifd.get(
        _T_STRIP_COUNTS, np.array([len(data) - offs[0]]))).astype(
        np.int64)
    stream = b"".join(bytes(data[o:o + c]) for o, c in zip(offs, cnts))
    bits = int(_scalar(raw_ifd, _T_BITS, 12))
    npx = w * h
    if len(stream) >= 2 * npx:
        # honor the container byte order: 'MMOR' files store the
        # raster big-endian
        mosaic = np.frombuffer(stream, endian + "u2",
                               count=npx).reshape(h, w).copy()
    elif len(stream) >= (npx * 12 + 7) // 8 and bits == 12:
        mosaic = _unpack_lsb(stream, 12, npx).reshape(h, w)
    else:
        mosaic = native.with_py_fallback(
            native.orf_decode, _orf_decode_py, stream, w, h)
        if mosaic is None:
            return None

    cfa = _RGGB.copy()
    pat = raw_ifd.get(_T_CFA_PATTERN)
    if pat is not None:
        p = np.atleast_1d(pat).astype(np.int32)
        if p.size >= 4 and np.all(p[:4] <= 2):
            cfa = p[:4].reshape(2, 2)

    return RawImage(
        mosaic=mosaic, cfa=cfa, black=0.0,
        white=_white_for_bits(bits, mosaic),
        as_shot_neutral=_orf_wb(data, endian, ifd0),
        color_matrix=None,
        orientation=int(_scalar(ifd0, _T_ORIENTATION, 1)))


def parse_raw_container(data: bytes) -> RawImage | None:
    """Dispatch: CR2 signature first, then RAF/RW2/ORF by magic, then
    generic TIFF-EP CFA (NEF, uncompressed ARW, ...).  DNG is handled
    by pipeline/dng.py."""
    if is_cr2(data):
        return parse_cr2(data)
    if is_raf(data):
        return parse_raf(data)
    if is_rw2(data):
        return parse_rw2(data)
    if is_orf(data):
        return parse_orf(data)
    if _tiff_endian(data) is not None:
        return parse_tiff_cfa(data)
    return None


def decode_raw_container(data: bytes) -> np.ndarray | None:
    """Full native raw pipeline: parse -> TPU demosaic -> (H, W, 3) u8."""
    raw = parse_raw_container(data)
    if raw is None:
        return None
    from ..ops import demosaic
    return demosaic.process_raw(raw)

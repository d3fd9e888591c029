"""PDF font model: embedded-outline extraction for the text rasterizer.

The reference renders PDF page 1 *including text* via the hayro crate
(scanner.rs:583-626); hayro in turn rasterizes embedded TrueType/CFF
glyph outlines.  This module is the TPU build's equivalent: it parses
the PDF font dictionaries (pdfraster.PdfDoc objects) and the embedded
font programs, and hands the rasterizer glyph outlines as closed
polyline contours in normalized glyph space (1.0 == one text-space unit
at font size 1), plus per-code advance widths.

Supported font programs:

* **TrueType** (`FontFile2`, and CIDFontType2 descendants): `glyf`
  outlines incl. composite glyphs, `cmap` formats 0/4/6/12, `hmtx`
  advances, coordinates normalized by `unitsPerEm`.
* **CFF / Type1C** (`FontFile3`, and CIDFontType0): full Type2
  charstring interpreter (incl. flex ops and local/global subrs),
  charset/encoding tables, CID fonts via FDArray/FDSelect private
  dicts, coordinates normalized by the FontMatrix (default 1/1000).
* **Type 3**: glyph CharProcs are PDF content streams — the rasterizer
  executes them through its own interpreter (pdfraster._exec_content);
  this module only resolves the code -> proc/width mapping and the
  FontMatrix.
* **Non-embedded fonts** (the standard 14, or stripped files) fall back
  to a metrics-boxed approximation: each visible glyph renders as a
  filled box sized by its advance width, which preserves the page's
  text layout signal for perceptual hashing without shipping font
  binaries.

Both binary parsers are differentially tested against fontTools'
decompilers (tests/test_pdfraster.py): glyf point arrays must match
fontTools' getCoordinates output and CFF path commands must match a
fontTools RecordingPen replay, so the outline geometry is pinned to an
independent implementation, not to our own expectations.

Like the rest of the PDF tier this parses untrusted input: every public
entry point fails soft (None / empty contours), never raises.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


# ---------------------------------------------------------------- AGL

# Adobe Glyph List subset: glyph name -> unicode for Latin text.  The
# full AGL is ~4.5k entries; PDF Latin text (incl. the standard-14
# encodings' Differences arrays) uses this core.
_AGL = {
    "space": 0x20, "exclam": 0x21, "quotedbl": 0x22, "numbersign": 0x23,
    "dollar": 0x24, "percent": 0x25, "ampersand": 0x26,
    "quotesingle": 0x27, "parenleft": 0x28, "parenright": 0x29,
    "asterisk": 0x2A, "plus": 0x2B, "comma": 0x2C, "hyphen": 0x2D,
    "period": 0x2E, "slash": 0x2F, "zero": 0x30, "one": 0x31,
    "two": 0x32, "three": 0x33, "four": 0x34, "five": 0x35, "six": 0x36,
    "seven": 0x37, "eight": 0x38, "nine": 0x39, "colon": 0x3A,
    "semicolon": 0x3B, "less": 0x3C, "equal": 0x3D, "greater": 0x3E,
    "question": 0x3F, "at": 0x40, "bracketleft": 0x5B,
    "backslash": 0x5C, "bracketright": 0x5D, "asciicircum": 0x5E,
    "underscore": 0x5F, "grave": 0x60, "braceleft": 0x7B, "bar": 0x7C,
    "braceright": 0x7D, "asciitilde": 0x7E,
    "quoteleft": 0x2018, "quoteright": 0x2019, "quotedblleft": 0x201C,
    "quotedblright": 0x201D, "endash": 0x2013, "emdash": 0x2014,
    "bullet": 0x2022, "dagger": 0x2020, "daggerdbl": 0x2021,
    "ellipsis": 0x2026, "fi": 0xFB01, "fl": 0xFB02,
    "guillemotleft": 0xAB, "guillemotright": 0xBB, "exclamdown": 0xA1,
    "questiondown": 0xBF, "cent": 0xA2, "sterling": 0xA3, "yen": 0xA5,
    "florin": 0x192, "section": 0xA7, "currency": 0xA4,
    "copyright": 0xA9, "registered": 0xAE, "trademark": 0x2122,
    "degree": 0xB0, "plusminus": 0xB1, "multiply": 0xD7,
    "divide": 0xF7, "mu": 0xB5, "paragraph": 0xB6,
    "periodcentered": 0xB7, "agrave": 0xE0, "aacute": 0xE1,
    "acircumflex": 0xE2, "atilde": 0xE3, "adieresis": 0xE4,
    "aring": 0xE5, "ae": 0xE6, "ccedilla": 0xE7, "egrave": 0xE8,
    "eacute": 0xE9, "ecircumflex": 0xEA, "edieresis": 0xEB,
    "igrave": 0xEC, "iacute": 0xED, "icircumflex": 0xEE,
    "idieresis": 0xEF, "ntilde": 0xF1, "ograve": 0xF2, "oacute": 0xF3,
    "ocircumflex": 0xF4, "otilde": 0xF5, "odieresis": 0xF6,
    "oslash": 0xF8, "ugrave": 0xF9, "uacute": 0xFA,
    "ucircumflex": 0xFB, "udieresis": 0xFC, "yacute": 0xFD,
    "ydieresis": 0xFF, "germandbls": 0xDF, "Agrave": 0xC0,
    "Aacute": 0xC1, "Acircumflex": 0xC2, "Atilde": 0xC3,
    "Adieresis": 0xC4, "Aring": 0xC5, "AE": 0xC6, "Ccedilla": 0xC7,
    "Egrave": 0xC8, "Eacute": 0xC9, "Ecircumflex": 0xCA,
    "Edieresis": 0xCB, "Igrave": 0xCC, "Iacute": 0xCD,
    "Icircumflex": 0xCE, "Idieresis": 0xCF, "Ntilde": 0xD1,
    "Ograve": 0xD2, "Oacute": 0xD3, "Ocircumflex": 0xD4,
    "Otilde": 0xD5, "Odieresis": 0xD6, "Oslash": 0xD8, "Ugrave": 0xD9,
    "Uacute": 0xDA, "Ucircumflex": 0xDB, "Udieresis": 0xDC,
    "Yacute": 0xDD, "Eth": 0xD0, "Thorn": 0xDE, "eth": 0xF0,
    "thorn": 0xFE, "dotlessi": 0x131, "OE": 0x152, "oe": 0x153,
    "Scaron": 0x160, "scaron": 0x161, "Zcaron": 0x17D,
    "zcaron": 0x17E, "Ydieresis": 0x178, "circumflex": 0x2C6,
    "tilde": 0x2DC, "macron": 0xAF, "breve": 0x2D8, "dotaccent": 0x2D9,
    "dieresis": 0xA8, "ring": 0x2DA, "cedilla": 0xB8,
    "hungarumlaut": 0x2DD, "ogonek": 0x2DB, "caron": 0x2C7,
    "minus": 0x2212, "brokenbar": 0xA6, "logicalnot": 0xAC,
    "onesuperior": 0xB9, "twosuperior": 0xB2, "threesuperior": 0xB3,
    "onequarter": 0xBC, "onehalf": 0xBD, "threequarters": 0xBE,
    "ordfeminine": 0xAA, "ordmasculine": 0xBA, "softhyphen": 0xAD,
    "perthousand": 0x2030, "quotesinglbase": 0x201A,
    "quotedblbase": 0x201E, "guilsinglleft": 0x2039,
    "guilsinglright": 0x203A, "Euro": 0x20AC, "nbspace": 0xA0,
}
for _c in range(0x21, 0x7F):
    ch = chr(_c)
    if ch.isalpha():
        _AGL.setdefault(ch, _c)


def glyphname_to_unicode(name: str) -> int | None:
    if name in _AGL:
        return _AGL[name]
    if name.startswith("uni") and len(name) >= 7:
        try:
            return int(name[3:7], 16)
        except ValueError:
            return None
    if name.startswith("u") and 5 <= len(name) <= 7:
        try:
            return int(name[1:], 16)
        except ValueError:
            return None
    return None


def _unicode_to_glyphname(cp: int) -> str | None:
    return _U2NAME.get(cp)


_U2NAME = {}
for _n, _u in _AGL.items():
    _U2NAME.setdefault(_u, _n)


# Standard / WinAnsi / MacRoman base encodings, code -> glyph name.
# WinAnsi and MacRoman ride the stdlib codecs (cp1252 / mac_roman);
# StandardEncoding's divergent slots are patched on top of ASCII.
def _codec_encoding(codec: str) -> dict[int, str]:
    out = {}
    for c in range(32, 256):
        try:
            u = bytes([c]).decode(codec)
        except UnicodeDecodeError:
            continue
        name = _unicode_to_glyphname(ord(u))
        if name:
            out[c] = name
    return out


WIN_ANSI_ENCODING = _codec_encoding("cp1252")
MAC_ROMAN_ENCODING = _codec_encoding("mac_roman")
STANDARD_ENCODING = _codec_encoding("ascii")
STANDARD_ENCODING.update({
    0x27: "quoteright", 0x60: "quoteleft", 0xA1: "exclamdown",
    0xA2: "cent", 0xA3: "sterling", 0xA8: "currency",
    0xB4: "periodcentered", 0xB7: "bullet", 0xD0: "emdash",
    0xE1: "AE", 0xF1: "ae", 0xE9: "Oslash", 0xF9: "oslash",
})

_BASE_ENCODINGS = {
    "WinAnsiEncoding": WIN_ANSI_ENCODING,
    "MacRomanEncoding": MAC_ROMAN_ENCODING,
    "StandardEncoding": STANDARD_ENCODING,
    "MacExpertEncoding": STANDARD_ENCODING,  # niche; ASCII-ish fallback
}


# --------------------------------------------------- outline flattening

def _flatten_quad(p0, p1, p2, n=8):
    """Quadratic bezier -> n points (excl. p0)."""
    pts = []
    for i in range(1, n + 1):
        t = i / n
        u = 1 - t
        pts.append((u * u * p0[0] + 2 * u * t * p1[0] + t * t * p2[0],
                    u * u * p0[1] + 2 * u * t * p1[1] + t * t * p2[1]))
    return pts


def _flatten_cubic(p0, p1, p2, p3, n=8):
    pts = []
    for i in range(1, n + 1):
        t = i / n
        u = 1 - t
        pts.append((u ** 3 * p0[0] + 3 * u * u * t * p1[0]
                    + 3 * u * t * t * p2[0] + t ** 3 * p3[0],
                    u ** 3 * p0[1] + 3 * u * u * t * p1[1]
                    + 3 * u * t * t * p2[1] + t ** 3 * p3[1]))
    return pts


def path_to_contours(path, scale: float):
    """[('m',(x,y)), ('l',...), ('c',p1,p2,p3), ('q',p1,p2), ('close',)]
    -> closed polyline contours, coordinates * scale."""
    contours = []
    cur = []
    pos = (0.0, 0.0)
    for seg in path:
        op = seg[0]
        if op == "m":
            if len(cur) > 2:
                contours.append(cur)
            pos = seg[1]
            cur = [pos]
        elif op == "l":
            pos = seg[1]
            cur.append(pos)
        elif op == "q":
            cur.extend(_flatten_quad(pos, seg[1], seg[2]))
            pos = seg[2]
        elif op == "c":
            cur.extend(_flatten_cubic(pos, seg[1], seg[2], seg[3]))
            pos = seg[3]
        elif op == "close":
            if len(cur) > 2:
                contours.append(cur)
            cur = []
    if len(cur) > 2:
        contours.append(cur)
    return [[(x * scale, y * scale) for x, y in c] for c in contours]


# ------------------------------------------------------------ TrueType

class TrueTypeFont:
    """Minimal sfnt parser: glyf/loca/cmap/hmtx/head/hhea/maxp.

    Outline source for FontFile2 and CIDFontType2 descendants
    (scanner.rs:583-626 renders these via hayro's TrueType path).
    """

    def __init__(self, data: bytes):
        self.d = data
        self.tables: dict[bytes, tuple[int, int]] = {}
        tag0 = data[:4]
        off = 0
        if tag0 == b"ttcf":          # font collection: first font
            off = struct.unpack_from(">I", data, 12)[0]
        ver = data[off:off + 4]
        if ver not in (b"\x00\x01\x00\x00", b"true", b"OTTO"):
            raise ValueError("not an sfnt font")
        num = struct.unpack_from(">H", data, off + 4)[0]
        for i in range(num):
            tag, _chk, toff, tlen = struct.unpack_from(
                ">4sIII", data, off + 12 + 16 * i)
            self.tables[tag] = (toff, tlen)
        if b"head" not in self.tables:
            raise ValueError("no head table")
        h0 = self.tables[b"head"][0]
        self.units_per_em = struct.unpack_from(">H", data, h0 + 18)[0] \
            or 1000
        self.loca_long = struct.unpack_from(">h", data, h0 + 50)[0] == 1
        self.is_cff = b"CFF " in self.tables  # OTTO: outlines live in CFF
        self.cff = None
        if self.is_cff:
            o, ln = self.tables[b"CFF "]
            self.cff = CFFFont(data[o:o + ln])
        self.n_glyphs = 0
        if b"maxp" in self.tables:
            self.n_glyphs = struct.unpack_from(
                ">H", data, self.tables[b"maxp"][0] + 4)[0]
        self._loca = None
        self._hmtx = None
        self._cmap = None

    # ----- loca / glyf

    def _glyf_range(self, gid: int):
        if b"loca" not in self.tables or b"glyf" not in self.tables:
            return None
        if self._loca is None:
            o, ln = self.tables[b"loca"]
            if self.loca_long:
                n = ln // 4
                self._loca = struct.unpack_from(f">{n}I", self.d, o)
            else:
                n = ln // 2
                self._loca = tuple(v * 2 for v in struct.unpack_from(
                    f">{n}H", self.d, o))
        if gid + 1 >= len(self._loca):
            return None
        s, e = self._loca[gid], self._loca[gid + 1]
        if e <= s:
            return None  # empty glyph (space)
        g0 = self.tables[b"glyf"][0]
        return g0 + s, g0 + e

    def glyph_points(self, gid: int, depth: int = 0, _budget=None):
        """Raw outline: (points [(x, y)], on_curve flags, contour end
        indices) in font units — composites resolved.  Matches
        fontTools' getCoordinates for the differential test.

        _budget bounds TOTAL components across the recursion: depth
        alone caps nesting but not width — a crafted 64 KB composite
        whose ~10K components all reference themselves costs
        ~(L/6)^depth iterations without it.  Real fonts use 2-6
        components per composite."""
        if _budget is None:
            _budget = [512]
        rng = self._glyf_range(gid)
        if rng is None or depth > 5:
            return [], [], []
        s, e = rng
        d = self.d
        ncont = struct.unpack_from(">h", d, s)[0]
        if ncont >= 0:
            return self._simple_glyph(s, ncont)
        # composite
        pts, flags, ends = [], [], []
        p = s + 10
        while True:
            if _budget[0] <= 0:
                break
            _budget[0] -= 1
            fl, sub_gid = struct.unpack_from(">HH", d, p)
            p += 4
            if fl & 0x0001:  # ARG_1_AND_2_ARE_WORDS
                a1, a2 = struct.unpack_from(">hh", d, p)
                p += 4
            else:
                a1, a2 = struct.unpack_from(">bb", d, p)
                p += 2
            sx = sy = 1.0
            s01 = s10 = 0.0
            if fl & 0x0008:      # WE_HAVE_A_SCALE
                sx = sy = struct.unpack_from(">h", d, p)[0] / 16384.0
                p += 2
            elif fl & 0x0040:    # X_AND_Y_SCALE
                sx, sy = (v / 16384.0
                          for v in struct.unpack_from(">hh", d, p))
                p += 4
            elif fl & 0x0080:    # 2x2
                sx, s01, s10, sy = (v / 16384.0 for v in
                                    struct.unpack_from(">hhhh", d, p))
                p += 8
            dx, dy = (a1, a2) if fl & 0x0002 else (0, 0)
            sp, sf, se = self.glyph_points(sub_gid, depth + 1, _budget)
            base = len(pts)
            for (x, y) in sp:
                pts.append((x * sx + y * s10 + dx, x * s01 + y * sy + dy))
            flags.extend(sf)
            ends.extend(base + i for i in se)
            if not fl & 0x0020:  # MORE_COMPONENTS
                break
        return pts, flags, ends

    def _simple_glyph(self, s: int, ncont: int):
        d = self.d
        p = s + 10
        ends = list(struct.unpack_from(f">{ncont}H", d, p))
        p += 2 * ncont
        ilen = struct.unpack_from(">H", d, p)[0]
        p += 2 + ilen
        npts = (ends[-1] + 1) if ends else 0
        flags = []
        while len(flags) < npts:
            f = d[p]
            p += 1
            flags.append(f)
            if f & 0x08:  # REPEAT
                rep = d[p]
                p += 1
                flags.extend([f] * rep)
        flags = flags[:npts]
        xs, x = [], 0
        for f in flags:
            if f & 0x02:      # short x
                dx = d[p]
                p += 1
                x += dx if f & 0x10 else -dx
            elif not f & 0x10:
                x += struct.unpack_from(">h", d, p)[0]
                p += 2
            xs.append(x)
        ys, y = [], 0
        for f in flags:
            if f & 0x04:      # short y
                dy = d[p]
                p += 1
                y += dy if f & 0x20 else -dy
            elif not f & 0x20:
                y += struct.unpack_from(">h", d, p)[0]
                p += 2
            ys.append(y)
        return (list(zip(xs, ys)), [bool(f & 0x01) for f in flags], ends)

    def glyph_path(self, gid: int):
        """Quadratic path commands from the point array (off-curve runs
        get the TrueType implied on-curve midpoints)."""
        if self.is_cff and self.cff is not None:
            return self.cff.glyph_path(gid)
        pts, on, ends = self.glyph_points(gid)
        path = []
        start = 0
        for end in ends:
            cpts = pts[start:end + 1]
            cflags = on[start:end + 1]
            start = end + 1
            n = len(cpts)
            if n == 0:
                continue
            # rotate so the contour starts on-curve (or synthesize)
            first_on = next((i for i, f in enumerate(cflags) if f), None)
            if first_on is None:
                p0 = ((cpts[0][0] + cpts[-1][0]) / 2,
                      (cpts[0][1] + cpts[-1][1]) / 2)
                seq = cpts[:]
                sflags = cflags[:]
            else:
                p0 = cpts[first_on]
                seq = cpts[first_on + 1:] + cpts[:first_on]
                sflags = cflags[first_on + 1:] + cflags[:first_on]
            path.append(("m", p0))
            pos = p0
            pending = None  # off-curve control point
            for pt, flag in zip(seq + [p0], sflags + [True]):
                if flag:
                    if pending is None:
                        path.append(("l", pt))
                    else:
                        path.append(("q", pending, pt))
                        pending = None
                    pos = pt
                else:
                    if pending is not None:
                        mid = ((pending[0] + pt[0]) / 2,
                               (pending[1] + pt[1]) / 2)
                        path.append(("q", pending, mid))
                        pos = mid
                    pending = pt
            path.append(("close",))
        return path

    def glyph_contours(self, gid: int):
        """Closed polyline contours, normalized to 1.0 == 1 em."""
        if self.is_cff and self.cff is not None:
            # OTTO: the embedded CFF's FontMatrix is the authority on
            # glyph-space scale (usually 1/1000, but not always)
            return self.cff.glyph_contours(gid)
        return path_to_contours(self.glyph_path(gid),
                                1.0 / self.units_per_em)

    # ----- metrics

    def advance(self, gid: int) -> float:
        """Advance width, normalized (1.0 == 1 em)."""
        if self._hmtx is None:
            if b"hhea" not in self.tables or b"hmtx" not in self.tables:
                self._hmtx = ()
            else:
                nh = struct.unpack_from(
                    ">H", self.d, self.tables[b"hhea"][0] + 34)[0]
                o = self.tables[b"hmtx"][0]
                self._hmtx = struct.unpack_from(
                    ">" + "Hh" * nh, self.d, o)[::2]
        if not self._hmtx:
            return 0.5
        aw = self._hmtx[min(gid, len(self._hmtx) - 1)]
        # hmtx is always in head.unitsPerEm units — OTTO included
        # (the 1000 lives in the CFF FontMatrix, which only scales
        # outlines, not the sfnt metrics tables)
        return aw / float(self.units_per_em)

    # ----- cmap

    def _load_cmap(self):
        self._cmap = {}
        if b"cmap" not in self.tables:
            return
        d = self.d
        o = self.tables[b"cmap"][0]
        n = struct.unpack_from(">H", d, o + 2)[0]
        subtables = {}
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", d, o + 4 + 8 * i)
            subtables[(pid, eid)] = o + off
        # preference: unicode BMP, full unicode, symbol, mac roman
        for key in ((3, 1), (0, 3), (0, 4), (3, 10), (0, 6), (0, 0),
                    (0, 1), (0, 2), (3, 0), (1, 0)):
            if key in subtables:
                self._cmap_symbol = key == (3, 0)
                self._parse_cmap_sub(subtables[key])
                if self._cmap:
                    return

    def _parse_cmap_sub(self, p: int):
        d = self.d
        fmt = struct.unpack_from(">H", d, p)[0]
        if fmt == 0:
            for c in range(256):
                g = d[p + 6 + c]
                if g:
                    self._cmap[c] = g
        elif fmt == 4:
            segx2 = struct.unpack_from(">H", d, p + 6)[0]
            seg = segx2 // 2
            ends = struct.unpack_from(f">{seg}H", d, p + 14)
            starts = struct.unpack_from(f">{seg}H", d, p + 16 + segx2)
            deltas = struct.unpack_from(f">{seg}h", d, p + 16 + 2 * segx2)
            ro_base = p + 16 + 3 * segx2
            ros = struct.unpack_from(f">{seg}H", d, ro_base)
            # total-work bound: the BMP code space is 64K, so any
            # honest format-4 table maps <= 64K codes across all
            # segments; a crafted one can declare 32K segments each
            # spanning the full range (2e9 iterations) — cap like
            # format 12 does
            work = 1 << 17
            for i in range(seg):
                if starts[i] == 0xFFFF:
                    continue
                work -= max(0, min(ends[i], 0xFFFE) + 1 - starts[i])
                if work < 0:
                    break
                for c in range(starts[i], min(ends[i], 0xFFFE) + 1):
                    if ros[i] == 0:
                        g = (c + deltas[i]) & 0xFFFF
                    else:
                        gp = ro_base + 2 * i + ros[i] \
                            + 2 * (c - starts[i])
                        if gp + 2 > len(d):
                            continue
                        g = struct.unpack_from(">H", d, gp)[0]
                        if g:
                            g = (g + deltas[i]) & 0xFFFF
                    if g:
                        self._cmap[c] = g
        elif fmt == 6:
            first, cnt = struct.unpack_from(">HH", d, p + 6)
            gids = struct.unpack_from(f">{cnt}H", d, p + 10)
            for i, g in enumerate(gids):
                if g:
                    self._cmap[first + i] = g
        elif fmt == 12:
            ngroups = struct.unpack_from(">I", d, p + 12)[0]
            for i in range(min(ngroups, 10000)):
                s, e, g0 = struct.unpack_from(">III", d, p + 16 + 12 * i)
                for c in range(s, min(e, s + 1000) + 1):
                    self._cmap[c] = g0 + (c - s)

    def gid_for_unicode(self, cp: int) -> int:
        if self._cmap is None:
            self._load_cmap()
        g = self._cmap.get(cp, 0)
        if not g and getattr(self, "_cmap_symbol", False) and cp < 0x100:
            g = self._cmap.get(0xF000 + cp, 0)
        return g


# ----------------------------------------------------------------- CFF

# CFF standard strings 0..390; glyph names for Latin live in 0..228.
_CFF_STD_STRINGS = (
    ".notdef space exclam quotedbl numbersign dollar percent ampersand "
    "quoteright parenleft parenright asterisk plus comma hyphen period "
    "slash zero one two three four five six seven eight nine colon "
    "semicolon less equal greater question at A B C D E F G H I J K L M "
    "N O P Q R S T U V W X Y Z bracketleft backslash bracketright "
    "asciicircum underscore quoteleft a b c d e f g h i j k l m n o p q "
    "r s t u v w x y z braceleft bar braceright asciitilde exclamdown "
    "cent sterling fraction yen florin section currency quotesingle "
    "quotedblleft guillemotleft guilsinglleft guilsinglright fi fl "
    "endash dagger daggerdbl periodcentered paragraph bullet "
    "quotesinglbase quotedblbase quotedblright guillemotright ellipsis "
    "perthousand questiondown grave acute circumflex tilde macron breve "
    "dotaccent dieresis ring cedilla hungarumlaut ogonek caron emdash "
    "AE ordfeminine Lslash Oslash OE ordmasculine ae dotlessi lslash "
    "oslash oe germandbls onesuperior logicalnot mu trademark Eth "
    "onehalf plusminus Thorn onequarter divide brokenbar degree thorn "
    "threequarters twosuperior registered minus eth multiply "
    "threesuperior copyright Aacute Acircumflex Adieresis Agrave Aring "
    "Atilde Ccedilla Eacute Ecircumflex Edieresis Egrave Iacute "
    "Icircumflex Idieresis Igrave Ntilde Oacute Ocircumflex Odieresis "
    "Ograve Otilde Scaron Uacute Ucircumflex Udieresis Ugrave Yacute "
    "Ydieresis Zcaron aacute acircumflex adieresis agrave aring atilde "
    "ccedilla eacute ecircumflex edieresis egrave iacute icircumflex "
    "idieresis igrave ntilde oacute ocircumflex odieresis ograve otilde "
    "scaron uacute ucircumflex udieresis ugrave yacute ydieresis zcaron"
).split()


def _cff_index(d: bytes, p: int):
    """CFF INDEX at p -> (list of byte items, end offset)."""
    if p + 2 > len(d):
        return [], p + 2
    count = struct.unpack_from(">H", d, p)[0]
    if count == 0:
        return [], p + 2
    osz = d[p + 2]
    offs = []
    q = p + 3
    for i in range(count + 1):
        v = 0
        for b in d[q:q + osz]:
            v = (v << 8) | b
        offs.append(v)
        q += osz
    base = q - 1
    items = [d[base + offs[i]:base + offs[i + 1]] for i in range(count)]
    return items, base + offs[-1]


def _cff_dict(data: bytes) -> dict:
    """CFF DICT -> {op: [operands]}; esc ops keyed as 1200+op."""
    out = {}
    stack = []
    p = 0
    while p < len(data):
        b0 = data[p]
        if b0 <= 21:
            op = b0
            p += 1
            if b0 == 12:
                op = 1200 + data[p]
                p += 1
            out[op] = stack
            stack = []
        elif b0 == 28:
            stack.append(struct.unpack_from(">h", data, p + 1)[0])
            p += 3
        elif b0 == 29:
            stack.append(struct.unpack_from(">i", data, p + 1)[0])
            p += 5
        elif b0 == 30:  # real: packed nibbles
            s = ""
            p += 1
            done = False
            while p < len(data) and not done:
                for nib in (data[p] >> 4, data[p] & 15):
                    if nib <= 9:
                        s += str(nib)
                    elif nib == 10:
                        s += "."
                    elif nib == 11:
                        s += "E"
                    elif nib == 12:
                        s += "E-"
                    elif nib == 14:
                        s += "-"
                    elif nib == 15:
                        done = True
                        break
                p += 1
            try:
                stack.append(float(s) if s else 0.0)
            except ValueError:
                stack.append(0.0)
        elif 32 <= b0 <= 246:
            stack.append(b0 - 139)
            p += 1
        elif 247 <= b0 <= 250:
            stack.append((b0 - 247) * 256 + data[p + 1] + 108)
            p += 2
        elif 251 <= b0 <= 254:
            stack.append(-(b0 - 251) * 256 - data[p + 1] - 108)
            p += 2
        else:
            p += 1
    return out


def _subr_bias(n: int) -> int:
    return 107 if n < 1240 else (1131 if n < 33900 else 32768)


class CFFFont:
    """CFF (Type1C / FontFile3 / OpenType CFF) outline source with a
    full Type2 charstring interpreter."""

    def __init__(self, data: bytes):
        self.d = data
        hdr_size = data[2]
        p = hdr_size
        _names, p = _cff_index(data, p)
        tops, p = _cff_index(data, p)
        self.strings, p = _cff_index(data, p)
        self.gsubrs, p = _cff_index(data, p)
        self.top = _cff_dict(tops[0]) if tops else {}
        cs_off = int(self.top.get(17, [0])[0])
        self.charstrings, _ = _cff_index(data, cs_off) if cs_off else \
            ([], 0)
        self.n_glyphs = len(self.charstrings)
        fm = self.top.get(1207)
        self.font_matrix = [float(v) for v in fm] if fm and len(fm) == 6 \
            else [0.001, 0, 0, 0.001, 0, 0]
        self.is_cid = 1230 in self.top
        # private dict(s) + local subrs
        self._privs = []           # [(default_w, nominal_w, subrs)]
        self._fdselect = None
        if self.is_cid:
            fda_off = int(self.top.get(1236, [0])[0])
            fds, _ = _cff_index(data, fda_off) if fda_off else ([], 0)
            for fd in fds:
                self._privs.append(self._load_private(_cff_dict(fd)))
            fdsel_off = int(self.top.get(1237, [0])[0])
            if fdsel_off:
                self._fdselect = self._load_fdselect(fdsel_off)
        else:
            self._privs.append(self._load_private(self.top))
        if not self._privs:
            self._privs.append((0.0, 0.0, []))
        self._charset = None
        self._encoding = None
        self._name2gid = None

    def _load_private(self, owner: dict):
        pv = owner.get(18)
        if not pv or len(pv) < 2:
            return (0.0, 0.0, [])
        size, off = int(pv[0]), int(pv[1])
        pd = _cff_dict(self.d[off:off + size])
        subrs = []
        if 19 in pd:
            subrs, _ = _cff_index(self.d, off + int(pd[19][0]))
        return (float(pd.get(20, [0])[0]), float(pd.get(21, [0])[0]),
                subrs)

    def _load_fdselect(self, p: int):
        d = self.d
        fmt = d[p]
        sel = {}
        if fmt == 0:
            for gid in range(self.n_glyphs):
                sel[gid] = d[p + 1 + gid]
        elif fmt == 3:
            nr = struct.unpack_from(">H", d, p + 1)[0]
            q = p + 3
            for _ in range(nr):
                first, fd = struct.unpack_from(">HB", d, q)
                nxt = struct.unpack_from(">H", d, q + 3)[0]
                for gid in range(first, nxt):
                    sel[gid] = fd
                q += 3
        return sel

    def _sid_name(self, sid: int) -> str:
        if sid < len(_CFF_STD_STRINGS):
            return _CFF_STD_STRINGS[sid]
        i = sid - 391
        if 0 <= i < len(self.strings):
            return self.strings[i].decode("latin-1")
        return f"sid{sid}"

    def _load_charset(self):
        """gid -> SID (or CID for CID fonts)."""
        self._charset = {0: 0}
        off = int(self.top.get(15, [0])[0])
        n = self.n_glyphs
        if off == 0:   # ISOAdobe: identity SIDs
            for gid in range(n):
                self._charset[gid] = gid
            return
        if off in (1, 2):  # Expert charsets: approximate identity
            for gid in range(n):
                self._charset[gid] = gid
            return
        d = self.d
        fmt = d[off]
        if fmt == 0:
            for gid in range(1, n):
                self._charset[gid] = struct.unpack_from(
                    ">H", d, off + 1 + 2 * (gid - 1))[0]
        elif fmt in (1, 2):
            gid = 1
            q = off + 1
            step = 3 if fmt == 1 else 4
            while gid < n:
                sid = struct.unpack_from(">H", d, q)[0]
                nleft = d[q + 2] if fmt == 1 else \
                    struct.unpack_from(">H", d, q + 2)[0]
                for k in range(nleft + 1):
                    if gid >= n:
                        break
                    self._charset[gid] = sid + k
                    gid += 1
                q += step

    def gid_for_name(self, name: str) -> int:
        if self._name2gid is None:
            if self._charset is None:
                self._load_charset()
            self._name2gid = {
                self._sid_name(sid): gid
                for gid, sid in self._charset.items()}
        return self._name2gid.get(name, 0)

    def gid_for_cid(self, cid: int) -> int:
        """CID-keyed font: charset maps gid -> CID; invert."""
        if self._charset is None:
            self._load_charset()
        if self._cid2gid is None:
            self._cid2gid = {cid: gid
                             for gid, cid in self._charset.items()}
        return self._cid2gid.get(cid, 0)

    _cid2gid = None

    def gid_for_code(self, code: int) -> int:
        """Built-in encoding: code -> gid (simple CFF fonts)."""
        if self._encoding is None:
            self._encoding = {}
            off = int(self.top.get(16, [0])[0])
            if off in (0, 1):
                enc = STANDARD_ENCODING
                for c, name in enc.items():
                    gid = self.gid_for_name(name)
                    if gid:
                        self._encoding[c] = gid
            else:
                d = self.d
                fmt = d[off] & 0x7F
                if fmt == 0:
                    ncodes = d[off + 1]
                    for i in range(ncodes):
                        self._encoding[d[off + 2 + i]] = i + 1
                elif fmt == 1:
                    nranges = d[off + 1]
                    gid = 1
                    q = off + 2
                    for _ in range(nranges):
                        first, nleft = d[q], d[q + 1]
                        for k in range(nleft + 1):
                            self._encoding[first + k] = gid
                            gid += 1
                        q += 2
        return self._encoding.get(code, 0)

    # ----- Type2 charstrings

    def glyph_path(self, gid: int):
        """Type2 charstring -> cubic path commands (fontTools-pen
        equivalent, differential-tested)."""
        if not 0 <= gid < self.n_glyphs:
            return []
        dflt, nominal, lsubrs = self._privs[
            (self._fdselect or {}).get(gid, 0) % max(len(self._privs), 1)]
        st = _T2State(self, lsubrs)
        try:
            st.run(self.charstrings[gid])
        except Exception:
            pass
        if st.open:
            st.path.append(("close",))
        return st.path

    def glyph_width(self, gid: int) -> float | None:
        """Charstring-carried width (glyph units), if present."""
        if not 0 <= gid < self.n_glyphs:
            return None
        dflt, nominal, lsubrs = self._privs[
            (self._fdselect or {}).get(gid, 0) % max(len(self._privs), 1)]
        st = _T2State(self, lsubrs)
        try:
            st.run(self.charstrings[gid])
        except Exception:
            return None
        if st.width is None:
            return dflt or None
        return nominal + st.width

    def glyph_contours(self, gid: int):
        m = self.font_matrix
        path = self.glyph_path(gid)
        contours = path_to_contours(path, 1.0)
        return [[(x * m[0] + y * m[2] + m[4], x * m[1] + y * m[3] + m[5])
                 for x, y in c] for c in contours]


class _T2State:
    """Type2 charstring execution state."""

    def __init__(self, font: CFFFont, lsubrs):
        self.font = font
        self.lsubrs = lsubrs
        self.lbias = _subr_bias(len(lsubrs))
        self.gbias = _subr_bias(len(font.gsubrs))
        self.stack: list[float] = []
        self.path: list = []
        self.x = 0.0
        self.y = 0.0
        self.nstems = 0
        self.width = None
        self.open = False
        self.trans: list[float] = []  # transient array (put/get)
        # total-work bound shared across subr recursion: depth alone
        # caps nesting (10) but not branching — a 16-byte local subr
        # with 4 self-calls already costs 4^10 invocations, and ~20
        # self-calls is ~1e13.  Real charstrings run a few hundred
        # ops; 65536 is far past any honest glyph.
        self.ops_left = 65536

    def _moveto(self, dx, dy):
        if self.open:
            self.path.append(("close",))
        self.x += dx
        self.y += dy
        self.path.append(("m", (self.x, self.y)))
        self.open = True

    def _lineto(self, dx, dy):
        self.x += dx
        self.y += dy
        self.path.append(("l", (self.x, self.y)))

    def _curveto(self, dxa, dya, dxb, dyb, dxc, dyc):
        c1 = (self.x + dxa, self.y + dya)
        c2 = (c1[0] + dxb, c1[1] + dyb)
        self.x, self.y = c2[0] + dxc, c2[1] + dyc
        self.path.append(("c", c1, c2, (self.x, self.y)))

    def run(self, cs: bytes, depth: int = 0):
        if depth > 10:
            return
        p = 0
        st = self.stack
        while p < len(cs):
            self.ops_left -= 1
            if self.ops_left <= 0:
                return
            b0 = cs[p]
            if b0 >= 32 or b0 == 28:
                if b0 == 28:
                    st.append(struct.unpack_from(">h", cs, p + 1)[0])
                    p += 3
                elif b0 <= 246:
                    st.append(b0 - 139)
                    p += 1
                elif b0 <= 250:
                    st.append((b0 - 247) * 256 + cs[p + 1] + 108)
                    p += 2
                elif b0 <= 254:
                    st.append(-(b0 - 251) * 256 - cs[p + 1] - 108)
                    p += 2
                else:  # 255: 16.16 fixed
                    st.append(struct.unpack_from(
                        ">i", cs, p + 1)[0] / 65536.0)
                    p += 5
                continue
            p += 1
            if b0 in (1, 3, 18, 23):        # h/vstem(hm)
                if len(st) % 2 and self.width is None:
                    self.width = st[0]
                self.nstems += len(st) // 2
                st.clear()
            elif b0 in (19, 20):            # hintmask/cntrmask
                if len(st) % 2 and self.width is None:
                    self.width = st[0]
                self.nstems += len(st) // 2
                st.clear()
                p += (self.nstems + 7) // 8
            elif b0 == 21:                  # rmoveto
                if len(st) > 2 and self.width is None:
                    self.width = st[0]
                    del st[0]
                if len(st) >= 2:
                    self._moveto(st[-2], st[-1])
                st.clear()
            elif b0 == 22:                  # hmoveto
                if len(st) > 1 and self.width is None:
                    self.width = st[0]
                    del st[0]
                if st:
                    self._moveto(st[-1], 0)
                st.clear()
            elif b0 == 4:                   # vmoveto
                if len(st) > 1 and self.width is None:
                    self.width = st[0]
                    del st[0]
                if st:
                    self._moveto(0, st[-1])
                st.clear()
            elif b0 == 5:                   # rlineto
                for i in range(0, len(st) - 1, 2):
                    self._lineto(st[i], st[i + 1])
                st.clear()
            elif b0 in (6, 7):              # hlineto / vlineto
                horiz = b0 == 6
                for v in st:
                    if horiz:
                        self._lineto(v, 0)
                    else:
                        self._lineto(0, v)
                    horiz = not horiz
                st.clear()
            elif b0 == 8:                   # rrcurveto
                for i in range(0, len(st) - 5, 6):
                    self._curveto(*st[i:i + 6])
                st.clear()
            elif b0 == 24:                  # rcurveline
                i = 0
                while len(st) - i >= 8:
                    self._curveto(*st[i:i + 6])
                    i += 6
                if len(st) - i >= 2:
                    self._lineto(st[i], st[i + 1])
                st.clear()
            elif b0 == 25:                  # rlinecurve
                i = 0
                while len(st) - i >= 8:
                    self._lineto(st[i], st[i + 1])
                    i += 2
                if len(st) - i >= 6:
                    self._curveto(*st[i:i + 6])
                st.clear()
            elif b0 == 26:                  # vvcurveto
                i = 0
                dx1 = 0.0
                if len(st) % 4:
                    dx1 = st[0]
                    i = 1
                while len(st) - i >= 4:
                    self._curveto(dx1, st[i], st[i + 1], st[i + 2],
                                  0, st[i + 3])
                    dx1 = 0.0
                    i += 4
                st.clear()
            elif b0 == 27:                  # hhcurveto
                i = 0
                dy1 = 0.0
                if len(st) % 4:
                    dy1 = st[0]
                    i = 1
                while len(st) - i >= 4:
                    self._curveto(st[i], dy1, st[i + 1], st[i + 2],
                                  st[i + 3], 0)
                    dy1 = 0.0
                    i += 4
                st.clear()
            elif b0 in (30, 31):            # vhcurveto / hvcurveto
                horiz = b0 == 31
                i = 0
                while len(st) - i >= 4:
                    last = len(st) - i in (5,)
                    df = st[i + 4] if last else 0.0
                    if horiz:
                        self._curveto(st[i], 0, st[i + 1], st[i + 2],
                                      df, st[i + 3])
                    else:
                        self._curveto(0, st[i], st[i + 1], st[i + 2],
                                      st[i + 3], df)
                    horiz = not horiz
                    i += 4
                st.clear()
            elif b0 == 10:                  # callsubr
                if st:
                    idx = int(st.pop()) + self.lbias
                    if 0 <= idx < len(self.lsubrs):
                        self.run(self.lsubrs[idx], depth + 1)
            elif b0 == 29:                  # callgsubr
                if st:
                    idx = int(st.pop()) + self.gbias
                    if 0 <= idx < len(self.font.gsubrs):
                        self.run(self.font.gsubrs[idx], depth + 1)
            elif b0 == 11:                  # return
                return
            elif b0 == 14:                  # endchar
                if len(st) in (1, 5) and self.width is None:
                    self.width = st[0]
                st.clear()
                return
            elif b0 == 12:                  # escape ops
                b1 = cs[p]
                p += 1
                if b1 == 35 and len(st) >= 13:      # flex
                    self._curveto(*st[0:6])
                    self._curveto(*st[6:12])
                elif b1 == 34 and len(st) >= 7:     # hflex
                    self._curveto(st[0], 0, st[1], st[2], st[3], 0)
                    self._curveto(st[4], 0, st[5], -st[2], st[6], 0)
                elif b1 == 36 and len(st) >= 9:     # hflex1
                    # endpoint returns to the starting y: the final
                    # delta is -(dy1 + dy2 + dy5) (Type2 spec / the
                    # dy6 of fontTools' op_hflex1)
                    self._curveto(st[0], st[1], st[2], st[3], st[4], 0)
                    self._curveto(st[5], 0, st[6], st[7], st[8],
                                  -(st[1] + st[3] + st[7]))
                elif b1 == 37 and len(st) >= 11:    # flex1
                    # dx/dy sum the FIVE explicit deltas; the sixth
                    # delta is d6 on the dominant axis and -(sum) on
                    # the other, so the endpoint returns to the
                    # start's off-axis coordinate
                    dx = sum(st[i] for i in (0, 2, 4, 6, 8))
                    dy = sum(st[i] for i in (1, 3, 5, 7, 9))
                    self._curveto(*st[0:6])
                    if abs(dx) > abs(dy):
                        self._curveto(st[6], st[7], st[8], st[9],
                                      st[10], -dy)
                    else:
                        self._curveto(st[6], st[7], st[8], st[9],
                                      -dx, st[10])
                st.clear()
            else:
                st.clear()


# ----------------------------------------------------- PDF font model

@dataclass
class PdfFont:
    """Resolved PDF font: code iteration, outlines, widths.

    subtype: 'TrueType' | 'CFF' | 'Type3' | 'boxed'
    """
    subtype: str
    two_byte: bool = False
    program: object = None          # TrueTypeFont | CFFFont | None
    widths: dict[int, float] = field(default_factory=dict)  # code->text
    default_width: float = 0.5
    code_to_gid: dict[int, int] = field(default_factory=dict)
    encoding: dict[int, str] = field(default_factory=dict)  # code->name
    # Type3:
    char_procs: dict[str, object] = field(default_factory=dict)
    font_matrix: tuple = (0.001, 0, 0, 0.001, 0, 0)
    resources: object = None
    _contour_cache: dict = field(default_factory=dict)

    def codes(self, s: bytes):
        if self.two_byte:
            for i in range(0, len(s) - 1, 2):
                yield (s[i] << 8) | s[i + 1]
        else:
            yield from s

    def advance(self, code: int) -> float:
        """Advance width in text space units (em = 1.0)."""
        w = self.widths.get(code)
        if w is not None:
            return w
        if self.subtype in ("TrueType", "CFF") and self.program:
            gid = self._gid(code)
            if gid:
                if self.subtype == "CFF" and isinstance(self.program,
                                                        CFFFont):
                    gw = self.program.glyph_width(gid)
                    if gw is not None:
                        m = self.program.font_matrix
                        return gw * m[0]
                else:
                    return self.program.advance(gid)
        return self.default_width

    def _gid(self, code: int) -> int:
        if code in self.code_to_gid:
            return self.code_to_gid[code]
        gid = 0
        prog = self.program
        name = self.encoding.get(code)
        if isinstance(prog, TrueTypeFont):
            if prog.is_cff and prog.cff is not None and name:
                gid = prog.cff.gid_for_name(name)
            if not gid:
                cp = glyphname_to_unicode(name) if name else code
                if cp is not None:
                    gid = prog.gid_for_unicode(cp)
                if not gid and code < 0x100:
                    gid = prog.gid_for_unicode(0xF000 + code) \
                        or prog.gid_for_unicode(code)
        elif isinstance(prog, CFFFont):
            if name:
                gid = prog.gid_for_name(name)
            if not gid:
                gid = prog.gid_for_code(code)
        self.code_to_gid[code] = gid
        return gid

    def contours(self, code: int):
        """Closed polyline contours in text space (em = 1.0) or None
        when the glyph must be drawn another way (Type3/boxed)."""
        if code in self._contour_cache:
            return self._contour_cache[code]
        out = None
        if self.subtype in ("TrueType", "CFF") and self.program:
            gid = self._gid(code)
            out = self.program.glyph_contours(gid) if gid else []
        elif self.subtype == "boxed":
            name = self.encoding.get(code)
            cp = glyphname_to_unicode(name) if name else code
            if cp is not None and chr(cp).isspace():
                out = []
            else:
                w = self.advance(code)
                out = [[(0.08 * w, 0.0), (0.92 * w, 0.0),
                        (0.92 * w, 0.66), (0.08 * w, 0.66)]]
        self._contour_cache[code] = out
        return out


# Standard-14 metrics approximation (boxed fallback): Courier is
# fixed-pitch 600/1000; the proportional faces get a coarse width
# classing that preserves line lengths well enough for layout hashing.
_NARROW = set("iljtf.,;:!'|()[]{} ")
_WIDE = set("mwMW@%&")
_CAPS_WIDE = set("ABCDEFGHKNOPQRSUVXYZ")


def _std14_width(name: str | None, ch: str) -> float:
    base = (name or "").split("+")[-1].lower()
    if "courier" in base or "mono" in base:
        return 0.6
    if ch in _NARROW:
        return 0.28
    if ch in _WIDE:
        return 0.85
    if ch in _CAPS_WIDE or ch.isupper():
        return 0.70
    if ch.isdigit():
        return 0.50
    return 0.50


def load_font(doc, font_dict: dict) -> PdfFont | None:
    """PDF font dictionary -> PdfFont.  Never raises."""
    try:
        return _load_font(doc, font_dict)
    except Exception:
        return None


def _font_program(doc, descriptor: dict):
    """(program object, kind) from a FontDescriptor's FontFile2/3."""
    if not isinstance(descriptor, dict):
        return None, None
    ff2 = descriptor.get("FontFile2")
    if ff2 is not None:
        raw = doc.stream_of(ff2)
        if raw:
            try:
                return TrueTypeFont(raw), "TrueType"
            except Exception:
                pass
    ff3 = descriptor.get("FontFile3")
    if ff3 is not None:
        raw = doc.stream_of(ff3)
        if raw:
            try:
                if raw[:4] in (b"OTTO", b"\x00\x01\x00\x00"):
                    return TrueTypeFont(raw), "TrueType"
                return CFFFont(raw), "CFF"
            except Exception:
                pass
    # FontFile (Type1/eexec) unsupported -> boxed fallback; rare in
    # modern files (hayro also routes these through a converter).
    return None, None


def _simple_encoding(doc, font_dict: dict, symbolic: bool):
    enc = doc.resolve(font_dict.get("Encoding"))
    table: dict[int, str] = {}
    if not symbolic:
        table.update(STANDARD_ENCODING)
    if isinstance(enc, str):
        table = dict(_BASE_ENCODINGS.get(str(enc), table))
    elif isinstance(enc, dict):
        base = doc.resolve(enc.get("BaseEncoding"))
        if isinstance(base, str) and str(base) in _BASE_ENCODINGS:
            table = dict(_BASE_ENCODINGS[str(base)])
        diffs = doc.resolve(enc.get("Differences"))
        if isinstance(diffs, list):
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, str):
                    table[code] = str(item)
                    code += 1
    return table


def _load_font(doc, font_dict: dict) -> PdfFont | None:
    subtype = str(doc.resolve(font_dict.get("Subtype")) or "")

    if subtype == "Type0":
        desc = doc.resolve(font_dict.get("DescendantFonts"))
        if not desc:
            return None
        dfont = doc.resolve(desc[0])
        if not isinstance(dfont, dict):
            return None
        descriptor = doc.resolve(dfont.get("FontDescriptor")) or {}
        prog, kind = _font_program(doc, descriptor)
        f = PdfFont(subtype=kind or "boxed", two_byte=True, program=prog)
        f.default_width = float(doc.resolve(dfont.get("DW", 1000)) or
                                1000) / 1000.0
        warr = doc.resolve(dfont.get("W"))
        if isinstance(warr, list):
            i = 0
            while i < len(warr):
                c = doc.resolve(warr[i])
                nxt = doc.resolve(warr[i + 1]) if i + 1 < len(warr) \
                    else None
                if isinstance(nxt, list):
                    for k, w in enumerate(nxt):
                        w = doc.resolve(w)
                        if isinstance(w, (int, float)):
                            f.widths[int(c) + k] = float(w) / 1000.0
                    i += 2
                elif isinstance(nxt, (int, float)) and i + 2 < len(warr):
                    w = doc.resolve(warr[i + 2])
                    if isinstance(w, (int, float)):
                        for cc in range(int(c), int(nxt) + 1):
                            f.widths[cc] = float(w) / 1000.0
                    i += 3
                else:
                    break
        # CID -> GID
        c2g = doc.resolve(dfont.get("CIDToGIDMap"))
        if isinstance(prog, TrueTypeFont):
            if c2g is None or str(c2g) == "Identity":
                f._cid_identity = True
            else:
                raw = doc.stream_of(dfont.get("CIDToGIDMap"))
                if raw:
                    for cid in range(len(raw) // 2):
                        gid = (raw[2 * cid] << 8) | raw[2 * cid + 1]
                        if gid:
                            f.code_to_gid[cid] = gid
                else:
                    f._cid_identity = True
            if getattr(f, "_cid_identity", False):
                f.code_to_gid = _IdentityGidMap(
                    getattr(prog, "n_glyphs", 0) or 1 << 16)
        elif isinstance(prog, CFFFont):
            if prog.is_cid:
                f.code_to_gid = _CidGidMap(prog)
            else:
                f.code_to_gid = _IdentityGidMap(prog.n_glyphs)
        return f

    if subtype == "Type3":
        f = PdfFont(subtype="Type3")
        fm = doc.resolve(font_dict.get("FontMatrix"))
        if isinstance(fm, list) and len(fm) == 6:
            f.font_matrix = tuple(float(doc.resolve(v)) for v in fm)
        f.encoding = _simple_encoding(doc, font_dict, symbolic=True)
        procs = doc.resolve(font_dict.get("CharProcs")) or {}
        if isinstance(procs, dict):
            f.char_procs = procs
        f.resources = doc.resolve(font_dict.get("Resources"))
        _simple_widths(doc, font_dict, f,
                       scale=abs(f.font_matrix[0]) or 0.001)
        f.default_width = 0.0
        return f

    # simple fonts: Type1 / TrueType / MMType1
    descriptor = doc.resolve(font_dict.get("FontDescriptor")) or {}
    flags = int(doc.resolve(descriptor.get("Flags", 0)) or 0) \
        if isinstance(descriptor, dict) else 0
    symbolic = bool(flags & 4) and not bool(flags & 32)
    prog, kind = _font_program(doc, descriptor)
    f = PdfFont(subtype=kind or "boxed", program=prog)
    f.encoding = _simple_encoding(doc, font_dict, symbolic)
    _simple_widths(doc, font_dict, f, scale=0.001)
    if isinstance(descriptor, dict):
        mw = doc.resolve(descriptor.get("MissingWidth"))
        if isinstance(mw, (int, float)):
            f.default_width = float(mw) / 1000.0
    if f.subtype == "boxed":
        base = str(doc.resolve(font_dict.get("BaseFont")) or "")
        if not f.widths:
            for c in range(32, 256):
                name = f.encoding.get(c)
                cp = glyphname_to_unicode(name) if name else c
                ch = chr(cp) if cp is not None and cp < 0x110000 else "?"
                f.widths[c] = _std14_width(base, ch)
        f.default_width = 0.5 if "courier" not in base.lower() else 0.6
    return f


def _simple_widths(doc, font_dict: dict, f: PdfFont, scale: float):
    first = doc.resolve(font_dict.get("FirstChar"))
    widths = doc.resolve(font_dict.get("Widths"))
    if isinstance(first, (int, float)) and isinstance(widths, list):
        for i, w in enumerate(widths):
            w = doc.resolve(w)
            if isinstance(w, (int, float)):
                f.widths[int(first) + i] = float(w) * scale


class _IdentityGidMap(dict):
    """code -> code, bounded by glyph count (CIDToGIDMap /Identity)."""

    def __init__(self, n: int):
        super().__init__()
        self._n = n

    def __contains__(self, k):
        return True

    def __getitem__(self, k):
        return k if 0 <= k < self._n else 0

    def get(self, k, default=None):
        return self[k]


class _CidGidMap(dict):
    """CID-keyed CFF: CID -> gid via the font's charset."""

    def __init__(self, cff: CFFFont):
        super().__init__()
        self._cff = cff

    def __contains__(self, k):
        return True

    def __getitem__(self, k):
        return self._cff.gid_for_cid(k)

    def get(self, k, default=None):
        return self[k]

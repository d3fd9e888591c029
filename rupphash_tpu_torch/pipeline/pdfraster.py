"""Minimal first-page PDF rasterizer (vector graphics + text).

The reference renders PDF page 1 at 2x on a white background via the
hayro crate (scanner.rs:583-626) — text included.  No rasterizer
library exists in this image, so this module implements the subset that
makes real PDFs hashable: path construction (m/l/c/v/y/h/re), nonzero
and even-odd fills, stroking (as segment quads), the graphics-state
stack and CTM, RGB/Gray/CMYK fill colors, image and Form XObjects (Do),
and the full text machine — BT/ET, Td/TD/Tm/T*, Tc/Tw/Tz/TL/Ts/Tr,
Tj/TJ/'/" — filling glyph outlines extracted from embedded TrueType
and CFF font programs (pipeline/pdffont.py), executing Type 3 glyph
content streams, and boxing non-embedded (standard-14) fonts.  Render
mode 3/7 (invisible, OCR overlays) advances without painting; clips
are ignored; stroke-text modes fill (at hash scale the difference is
sub-threshold).

Object model: plain `N G obj` objects located by byte scan (object
streams are not unpacked — files that put the page tree inside an
ObjStm fall back to pdfimg's embedded-raster tier).
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field

import numpy as np


# --------------------------------------------------------------- lexer

class Ref:
    __slots__ = ("num",)

    def __init__(self, num):
        self.num = num

    def __repr__(self):
        return f"Ref({self.num})"


class Name(str):
    pass


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _hex_bytes(raw: bytes) -> bytes:
    """PDF hex-string payload -> bytes: non-hex bytes dropped, an odd
    digit count gets the spec's implied trailing 0 (7.3.4.3) — plain
    bytes.fromhex raises on both, which real files exercise."""
    digits = re.sub(rb"[^0-9a-fA-F]", b"", raw)
    if len(digits) % 2:
        digits += b"0"
    return bytes.fromhex(digits.decode("ascii"))


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def _skip_ws(self):
        d, p = self.d, self.p
        while p < len(d):
            c = d[p:p + 1]
            if c in b"%":
                nl = self.d.find(b"\n", p)
                p = len(d) if nl < 0 else nl + 1
            elif c in _WS:
                p += 1
            else:
                break
        self.p = p

    def token(self):
        """Next raw token (value or operator) or None at end."""
        self._skip_ws()
        d, p = self.d, self.p
        if p >= len(d):
            return None
        c = d[p:p + 1]
        if c == b"/":
            q = p + 1
            while q < len(d) and d[q:q + 1] not in _WS + _DELIM:
                q += 1
            self.p = q
            return Name(d[p + 1:q].decode("latin-1"))
        if c == b"(":
            depth, q = 1, p + 1
            out = bytearray()
            while q < len(d) and depth:
                ch = d[q]
                if ch == 0x5C and q + 1 < len(d):  # backslash escape
                    out.append(d[q + 1])
                    q += 2
                    continue
                if ch == 0x28:
                    depth += 1
                elif ch == 0x29:
                    depth -= 1
                    if not depth:
                        q += 1
                        break
                out.append(ch)
                q += 1
            self.p = q
            return bytes(out)
        if d[p:p + 2] == b"<<":
            self.p = p + 2
            return "<<"
        if d[p:p + 2] == b">>":
            self.p = p + 2
            return ">>"
        if c == b"<":  # hex string
            q = d.find(b">", p)
            self.p = len(d) if q < 0 else q + 1
            return _hex_bytes(d[p + 1:q] if q > p else b"")
        if c in b"[]{}":
            self.p = p + 1
            return c.decode()
        # number / keyword / operator
        q = p
        while q < len(d) and d[q:q + 1] not in _WS + _DELIM:
            q += 1
        if q == p:
            # stray delimiter byte (unbalanced ')' or a lone '>'):
            # consume it so the token stream always makes progress —
            # corrupt files otherwise yield empty tokens forever
            self.p = p + 1
            return d[p:p + 1].decode("latin-1")
        word = d[p:q]
        self.p = q
        try:
            if b"." in word or b"e" in word.lower():
                return float(word)
            return int(word)
        except ValueError:
            return word.decode("latin-1")

    def value(self, tok=None):
        """Parse one PDF value starting at tok (or the next token)."""
        if tok is None:
            tok = self.token()
        if tok == "<<":
            out = {}
            while True:
                k = self.token()
                if k == ">>" or k is None:
                    return out
                out[str(k)] = self.value()
        if tok == "[":
            out = []
            while True:
                t = self.token()
                if t == "]" or t is None:
                    return out
                out.append(self.value(t))
        if isinstance(tok, int):
            # possible "N G R" reference
            save = self.p
            t2 = self.token()
            if isinstance(t2, int):
                t3 = self.token()
                if t3 == "R":
                    return Ref(tok)
            self.p = save
            return tok
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok == "null":
            return None
        return tok


# ------------------------------------------------------------ document

_OBJ_HEAD = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfDoc:
    def __init__(self, data: bytes):
        self.data = data
        self.objs: dict[int, tuple[object, bytes | None]] = {}
        self._parse_objects()
        self.trailer = self._find_trailer()

    def _parse_objects(self):
        d = self.data
        for m in _OBJ_HEAD.finditer(d):
            num = int(m.group(1))
            lex = _Lexer(d, m.end())
            try:
                val = lex.value()
            except Exception:
                continue
            stream = None
            lex._skip_ws()
            if d[lex.p:lex.p + 6] == b"stream":
                s = lex.p + 6
                if d[s:s + 2] == b"\r\n":
                    s += 2
                elif d[s:s + 1] in (b"\n", b"\r"):
                    s += 1
                length = val.get("Length") if isinstance(val, dict) \
                    else None
                if isinstance(length, Ref):
                    length = self._peek_int(length.num)
                if isinstance(length, int) and \
                        d[s + length:s + length + 20].lstrip()[:9] \
                        == b"endstream":
                    stream = d[s:s + length]
                else:
                    e = d.find(b"endstream", s)
                    stream = d[s:e].rstrip(b"\r\n") if e > 0 else b""
            # latest definition wins (incremental updates append)
            self.objs[num] = (val, stream)

    def _peek_int(self, num: int):
        v = self.objs.get(num)
        return v[0] if v and isinstance(v[0], int) else None

    def _find_trailer(self) -> dict:
        # every 'trailer' dict, last (most recent update) first; XRef
        # streams carry /Root in the stream dict itself
        for m in reversed(list(re.finditer(rb"trailer", self.data))):
            lex = _Lexer(self.data, m.end())
            try:
                t = lex.value()
            except Exception:
                continue
            if isinstance(t, dict) and "Root" in t:
                return t
        for num, (val, _) in self.objs.items():
            if isinstance(val, dict) and val.get("Type") == "XRef" \
                    and "Root" in val:
                return val
        # last resort: any Catalog object
        for num, (val, _) in self.objs.items():
            if isinstance(val, dict) and val.get("Type") == "Catalog":
                return {"Root": Ref(num)}
        return {}

    def resolve(self, v, depth=0):
        while isinstance(v, Ref) and depth < 32:
            got = self.objs.get(v.num)
            if got is None:
                return None
            v = got[0]
            depth += 1
        return v

    def stream_of(self, v) -> bytes | None:
        """Decoded stream bytes of a (possibly referenced) stream obj."""
        if isinstance(v, Ref):
            got = self.objs.get(v.num)
            if got is None:
                return None
            d, raw = got
        else:
            return None
        if raw is None:
            return None
        filt = self.resolve(d.get("Filter")) if isinstance(d, dict) \
            else None
        filters = [filt] if isinstance(filt, Name) else (filt or [])
        out = raw
        for f in filters:
            if str(f) == "FlateDecode":
                try:
                    out = zlib.decompress(out)
                except zlib.error:
                    return None
            elif str(f) in ("ASCIIHexDecode",):
                out = _hex_bytes(out)
            else:
                return None  # unsupported for content streams
        return out

    def first_page(self) -> dict | None:
        root = self.resolve(self.trailer.get("Root"))
        if not isinstance(root, dict):
            return None
        node = self.resolve(root.get("Pages"))
        inherited = {}
        depth = 0
        while isinstance(node, dict) and depth < 64:
            depth += 1
            for key in ("MediaBox", "Resources"):
                if key in node:
                    inherited[key] = node[key]
            if node.get("Type") == "Page":
                page = dict(node)
                for key, v in inherited.items():
                    page.setdefault(key, v)
                return page
            kids = self.resolve(node.get("Kids"))
            if not kids:
                return None
            node = self.resolve(kids[0])
        return None


# ------------------------------------------------------ rasterization

@dataclass
class _GState:
    ctm: np.ndarray
    fill: tuple = (0.0, 0.0, 0.0)
    stroke: tuple = (0.0, 0.0, 0.0)
    line_width: float = 1.0
    # text state (persists across BT..ET and q/Q like the rest)
    font: object = None           # pdffont.PdfFont | None
    size: float = 0.0
    char_sp: float = 0.0
    word_sp: float = 0.0
    hscale: float = 1.0
    leading: float = 0.0
    rise: float = 0.0
    render_mode: int = 0

    def copy(self):
        return _GState(self.ctm.copy(), self.fill, self.stroke,
                       self.line_width, self.font, self.size,
                       self.char_sp, self.word_sp, self.hscale,
                       self.leading, self.rise, self.render_mode)


def _mat(a, b, c, d, e, f) -> np.ndarray:
    return np.array([[a, b], [c, d], [e, f]], dtype=np.float64)


def _mul(m2: np.ndarray, m1: np.ndarray) -> np.ndarray:
    """Apply m2 then m1 (PDF cm premultiplies)."""
    out = np.empty((3, 2))
    out[:2] = m2[:2] @ m1[:2]
    out[2] = m2[2] @ m1[:2] + m1[2]
    return out


def _xform(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:2] + m[2]


def _flatten_bezier(p0, p1, p2, p3, n=16):
    t = np.linspace(0.0, 1.0, n + 1)[1:, None]
    u = 1 - t
    return (u ** 3 * p0 + 3 * u ** 2 * t * p1
            + 3 * u * t ** 2 * p2 + t ** 3 * p3)


def _fill_polys(canvas: np.ndarray, subpaths, color, evenodd: bool):
    """Scanline polygon fill over closed subpaths (device space)."""
    edges = []
    for sp in subpaths:
        if len(sp) < 3:
            continue
        pts = np.asarray(sp)
        closed = np.vstack([pts, pts[:1]])
        for i in range(len(pts)):
            x0, y0 = closed[i]
            x1, y1 = closed[i + 1]
            if y0 != y1:
                edges.append((x0, y0, x1, y1))
    if not edges:
        return
    e = np.asarray(edges)
    h, w = canvas.shape[:2]
    ymin = max(int(np.floor(e[:, [1, 3]].min())), 0)
    ymax = min(int(np.ceil(e[:, [1, 3]].max())), h - 1)
    col = np.asarray([int(round(c * 255)) for c in color], dtype=np.uint8)
    x0, y0, x1, y1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    for y in range(ymin, ymax + 1):
        yc = y + 0.5
        hit = ((y0 <= yc) & (yc < y1)) | ((y1 <= yc) & (yc < y0))
        if not hit.any():
            continue
        xs = x0[hit] + (yc - y0[hit]) * (x1[hit] - x0[hit]) \
            / (y1[hit] - y0[hit])
        wind = np.where(y1[hit] > y0[hit], 1, -1)
        order = np.argsort(xs, kind="stable")
        xs, wind = xs[order], wind[order]
        if evenodd:
            for i in range(0, len(xs) - 1, 2):
                a = max(int(np.ceil(xs[i] - 0.5)), 0)
                b = min(int(np.floor(xs[i + 1] - 0.5)), w - 1)
                if b >= a:
                    canvas[y, a:b + 1] = col
        else:
            acc = 0
            for i in range(len(xs) - 1):
                acc += wind[i]
                if acc != 0:
                    a = max(int(np.ceil(xs[i] - 0.5)), 0)
                    b = min(int(np.floor(xs[i + 1] - 0.5)), w - 1)
                    if b >= a:
                        canvas[y, a:b + 1] = col


def _stroke_polys(canvas, subpaths, color, width):
    """Stroke as per-segment quads (device space, butt caps)."""
    width = max(width, 1.0)
    quads = []
    for sp in subpaths:
        pts = np.asarray(sp)
        for i in range(len(pts) - 1):
            p, q = pts[i], pts[i + 1]
            d = q - p
            n = np.hypot(*d)
            if n < 1e-9:
                continue
            off = np.array([-d[1], d[0]]) / n * (width / 2)
            quads.append([p + off, q + off, q - off, p - off])
    if quads:
        _fill_polys(canvas, quads, color, evenodd=False)


def _cmyk_rgb(c, m, y, k):
    return ((1 - c) * (1 - k), (1 - m) * (1 - k), (1 - y) * (1 - k))


def _composite_image(canvas, img: np.ndarray, ctm: np.ndarray):
    """Draw an image XObject: unit square [0,1]^2 maps through ctm."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = canvas.shape[:2]
    corners = _xform(ctm, np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                                   dtype=np.float64))
    x0 = max(int(np.floor(corners[:, 0].min())), 0)
    x1 = min(int(np.ceil(corners[:, 0].max())), w - 1)
    y0 = max(int(np.floor(corners[:, 1].min())), 0)
    y1 = min(int(np.ceil(corners[:, 1].max())), h - 1)
    if x1 < x0 or y1 < y0:
        return
    # inverse affine: device -> unit square
    a = np.vstack([ctm[:2], ctm[2]])
    m = np.array([[a[0, 0], a[1, 0], a[2, 0]],
                  [a[0, 1], a[1, 1], a[2, 1]],
                  [0, 0, 1]])
    try:
        inv = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    px = xs + 0.5
    py = ys + 0.5
    u = inv[0, 0] * px + inv[0, 1] * py + inv[0, 2]
    v = inv[1, 0] * px + inv[1, 1] * py + inv[1, 2]
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    ih, iw = img.shape[:2]
    # image space: v=1 is the TOP row (PDF image space y-up)
    sx = np.clip((u * iw).astype(np.int64), 0, iw - 1)
    sy = np.clip(((1 - v) * ih).astype(np.int64), 0, ih - 1)
    region = canvas[y0:y1 + 1, x0:x1 + 1]
    region[inside] = img[sy[inside], sx[inside], :3]


def rasterize_first_page(data: bytes, scale: float = 2.0,
                         max_side: int = 4096) -> np.ndarray | None:
    """Render page 1 at `scale` on white -> (H, W, 3) uint8, or None.
    Never raises: this parses untrusted scan input and its callers
    (decode tiers, GUI render, serve add) treat None as 'not a
    renderable PDF'."""
    try:
        return _rasterize_first_page(data, scale, max_side)
    except Exception:
        return None


def _rasterize_first_page(data: bytes, scale: float,
                          max_side: int) -> np.ndarray | None:
    if not data.startswith(b"%PDF"):
        idx = data.find(b"%PDF")
        if idx < 0:
            return None
        data = data[idx:]
    try:
        doc = PdfDoc(data)
        page = doc.first_page()
    except Exception:
        return None
    if page is None:
        return None
    try:
        mb = doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792]
        mb = [float(doc.resolve(v)) for v in mb[:4]]
        if len(mb) != 4:
            raise ValueError("short MediaBox")
        pw, ph = mb[2] - mb[0], mb[3] - mb[1]
    except (TypeError, ValueError, IndexError):
        # malformed MediaBox (short array, null entries): the contract
        # is None, not an exception out of the untrusted-input parser
        return None
    if pw <= 0 or ph <= 0:
        return None
    scale = min(scale, max_side / max(pw, ph))
    w, h = int(round(pw * scale)), int(round(ph * scale))
    if w < 4 or h < 4:
        return None
    canvas = np.full((h, w, 3), 255, dtype=np.uint8)

    contents = page.get("Contents")
    streams = []
    cl = doc.resolve(contents)
    refs = cl if isinstance(cl, list) else [contents]
    for r in refs:
        s = doc.stream_of(r if isinstance(r, Ref) else contents)
        if s:
            streams.append(s)
    if not streams:
        return canvas
    content = b"\n".join(streams)

    resources = doc.resolve(page.get("Resources")) or {}

    # device transform: PDF user space (y up, origin at MediaBox ll)
    base = _mat(scale, 0, 0, -scale, -mb[0] * scale, mb[3] * scale)
    st = _GState(ctm=base)
    _exec_content(doc, canvas, content, resources, st,
                  budget=[2_000_000], depth=0)
    return canvas


_IDENT_TM = _mat(1, 0, 0, 1, 0, 0)


def _get_font(doc: PdfDoc, resources: dict, name):
    """Resolve /Font <name> from resources, cached on the doc (fonts
    repeat across Tf ops and across Type3 recursion)."""
    from . import pdffont

    fonts = doc.resolve(resources.get("Font")) if isinstance(
        resources, dict) else None
    if not isinstance(fonts, dict):
        return None
    ref = fonts.get(str(name))
    cache = getattr(doc, "_font_cache", None)
    if cache is None:
        cache = doc._font_cache = {}
    key = ref.num if isinstance(ref, Ref) else id(ref)
    if key in cache:
        return cache[key]
    fd = doc.resolve(ref)
    font = pdffont.load_font(doc, fd) if isinstance(fd, dict) else None
    cache[key] = font
    return font


def _show_text(doc, canvas, st, tm, s: bytes, resources, budget, depth):
    """Paint string s at text matrix tm; returns the advanced tm.
    Implements PDF 9.4.4 glyph positioning: for each code the glyph is
    placed through [size*hscale 0, 0 size, 0 rise] x Tm x CTM, then Tm
    advances by (w0*size + Tc + Tw[space]) * hscale."""
    font = st.font
    if font is None or not isinstance(s, bytes):
        return tm
    invisible = st.render_mode in (3, 7)
    color = st.stroke if st.render_mode in (1, 5) else st.fill
    polys = []
    for code in font.codes(s):
        if not invisible:
            g = _mat(st.size * st.hscale, 0, 0, st.size, 0, st.rise)
            trm = _mul(_mul(g, tm), st.ctm)
            if font.subtype == "Type3":
                _draw_type3(doc, canvas, st, trm, font, code,
                            resources, budget, depth)
            else:
                contours = font.contours(code)
                if contours:
                    for c in contours:
                        polys.append(_xform(
                            trm, np.asarray(c, dtype=np.float64)))
        w0 = font.advance(code)
        tx = (w0 * st.size + st.char_sp
              + (st.word_sp if (code == 32 and not font.two_byte)
                 else 0.0)) * st.hscale
        tm = _mul(_mat(1, 0, 0, 1, tx, 0), tm)
    if polys:
        # one scanline pass per show op: glyph boxes share the text
        # line's y-range, so batching all outlines beats per-glyph fills
        _fill_polys(canvas, polys, color, evenodd=False)
    return tm


def _draw_type3(doc, canvas, st, trm, font, code, resources, budget,
                depth):
    """Execute a Type 3 glyph CharProc with CTM = FontMatrix x Trm."""
    name = font.encoding.get(code)
    proc = font.char_procs.get(str(name)) if name else None
    stream = doc.stream_of(proc) if proc is not None else None
    if not stream:
        return
    gst = st.copy()
    gst.ctm = _mul(_mat(*font.font_matrix), trm)
    gst.font = None                  # glyph procs restate their own
    res = font.resources if isinstance(font.resources, dict) \
        else resources
    _exec_content(doc, canvas, stream, res, gst, budget, depth + 1)


def _exec_content(doc: PdfDoc, canvas: np.ndarray, content: bytes,
                  resources: dict, st: _GState, budget: list,
                  depth: int):
    """Interpret one content stream onto canvas.  Recursions: Form
    XObjects (Do) and Type 3 glyph procs (via _show_text); budget is a
    shared op counter bounding adversarial inputs across all levels."""
    if depth > 6:
        return
    resources = resources if isinstance(resources, dict) else {}
    xobjects = doc.resolve(resources.get("XObject")) or {}
    stack: list[_GState] = []
    subpaths: list[list] = []
    cur: list | None = None
    start = None
    lex = _Lexer(content)
    operands: list = []
    tm = _IDENT_TM
    tlm = _IDENT_TM

    def dev(pts):
        return _xform(st.ctm, np.asarray(pts, dtype=np.float64))

    def flush_path():
        nonlocal subpaths, cur, start
        subpaths, cur, start = [], None, None

    def close_cur():
        nonlocal cur
        if cur and len(cur) > 1:
            subpaths.append(cur)
        cur = None

    def nums(n):
        vals = operands[-n:] if len(operands) >= n else None
        if vals is None or not all(isinstance(v, (int, float))
                                   for v in vals):
            return None
        return [float(v) for v in vals]

    def text_newline(ty=None):
        nonlocal tm, tlm
        tlm = _mul(_mat(1, 0, 0, 1, 0,
                        -st.leading if ty is None else ty), tlm)
        tm = tlm

    while True:
        budget[0] -= 1
        if budget[0] <= 0:
            break
        tok = lex.token()
        if tok is None:
            break
        if tok == "<<" or tok == "[":
            try:
                operands.append(lex.value(tok))
            except Exception:
                operands.clear()
            continue
        if isinstance(tok, (int, float, bytes, Name)):
            operands.append(tok)
            continue
        op = str(tok)
        try:
            if op == "q":
                stack.append(st.copy())
            elif op == "Q":
                if stack:
                    st = stack.pop()
            elif op == "cm":
                v = nums(6)
                if v:
                    st.ctm = _mul(_mat(*v), st.ctm)
            elif op == "w":
                v = nums(1)
                if v:
                    st.line_width = v[0]
            elif op == "m":
                v = nums(2)
                if v:
                    close_cur()
                    cur = [dev([v])[0]]
                    start = cur[0]
            elif op == "l":
                v = nums(2)
                if v and cur is not None:
                    cur.append(dev([v])[0])
            elif op in ("c", "v", "y"):
                need = {"c": 6, "v": 4, "y": 4}[op]
                v = nums(need)
                if v and cur is not None:
                    p0 = cur[-1]
                    if op == "c":
                        p1, p2, p3 = dev([v[0:2], v[2:4], v[4:6]])
                    elif op == "v":
                        p2, p3 = dev([v[0:2], v[2:4]])
                        p1 = p0
                    else:  # y
                        p1, p3 = dev([v[0:2], v[2:4]])
                        p2 = p3
                    cur.extend(_flatten_bezier(np.asarray(p0), p1, p2,
                                               p3))
            elif op == "h":
                if cur is not None and start is not None:
                    cur.append(start)
                    close_cur()
            elif op == "re":
                v = nums(4)
                if v:
                    x, y, rw, rh = v
                    close_cur()
                    subpaths.append(list(dev([[x, y], [x + rw, y],
                                              [x + rw, y + rh],
                                              [x, y + rh]])))
            elif op in ("f", "F", "f*", "b", "b*", "B", "B*"):
                close_cur()
                _fill_polys(canvas, subpaths, st.fill,
                            evenodd=op.endswith("*"))
                if op in ("b", "b*", "B", "B*"):
                    _stroke_polys(canvas, subpaths, st.stroke,
                                  st.line_width * abs(st.ctm[0, 0]))
                flush_path()
            elif op in ("S", "s"):
                if op == "s" and cur is not None and start is not None:
                    cur.append(start)
                close_cur()
                _stroke_polys(canvas, subpaths, st.stroke,
                              st.line_width * abs(st.ctm[0, 0]))
                flush_path()
            elif op in ("n",):
                flush_path()
            elif op in ("W", "W*"):
                pass  # clip ignored (minimal rasterizer)
            elif op == "rg":
                v = nums(3)
                if v:
                    st.fill = tuple(v)
            elif op == "RG":
                v = nums(3)
                if v:
                    st.stroke = tuple(v)
            elif op == "g":
                v = nums(1)
                if v:
                    st.fill = (v[0],) * 3
            elif op == "G":
                v = nums(1)
                if v:
                    st.stroke = (v[0],) * 3
            elif op == "k":
                v = nums(4)
                if v:
                    st.fill = _cmyk_rgb(*v)
            elif op == "K":
                v = nums(4)
                if v:
                    st.stroke = _cmyk_rgb(*v)
            elif op in ("sc", "scn", "SC", "SCN"):
                numeric = [float(v) for v in operands
                           if isinstance(v, (int, float))]
                col = None
                if len(numeric) >= 3:
                    col = tuple(numeric[-3:])
                elif len(numeric) == 1:
                    col = (numeric[0],) * 3
                if col:
                    if op.islower():
                        st.fill = col
                    else:
                        st.stroke = col
            # ---------------------------------------------- text machine
            elif op == "BT":
                tm = tlm = _IDENT_TM
            elif op == "ET":
                pass
            elif op == "Tf":
                v = nums(1)
                if v and len(operands) >= 2 and \
                        isinstance(operands[-2], Name):
                    st.font = _get_font(doc, resources, operands[-2])
                    st.size = v[0]
            elif op == "Td":
                v = nums(2)
                if v:
                    tlm = _mul(_mat(1, 0, 0, 1, v[0], v[1]), tlm)
                    tm = tlm
            elif op == "TD":
                v = nums(2)
                if v:
                    st.leading = -v[1]
                    tlm = _mul(_mat(1, 0, 0, 1, v[0], v[1]), tlm)
                    tm = tlm
            elif op == "Tm":
                v = nums(6)
                if v:
                    tm = tlm = _mat(*v)
            elif op == "T*":
                text_newline()
            elif op == "TL":
                v = nums(1)
                if v:
                    st.leading = v[0]
            elif op == "Tc":
                v = nums(1)
                if v:
                    st.char_sp = v[0]
            elif op == "Tw":
                v = nums(1)
                if v:
                    st.word_sp = v[0]
            elif op == "Tz":
                v = nums(1)
                if v:
                    st.hscale = v[0] / 100.0
            elif op == "Ts":
                v = nums(1)
                if v:
                    st.rise = v[0]
            elif op == "Tr":
                v = nums(1)
                if v:
                    st.render_mode = int(v[0])
            elif op == "Tj":
                if operands and isinstance(operands[-1], bytes):
                    tm = _show_text(doc, canvas, st, tm, operands[-1],
                                    resources, budget, depth)
            elif op == "'":
                if operands and isinstance(operands[-1], bytes):
                    text_newline()
                    tm = _show_text(doc, canvas, st, tm, operands[-1],
                                    resources, budget, depth)
            elif op == '"':
                if len(operands) >= 3 and \
                        isinstance(operands[-1], bytes):
                    # aw ac string ": the string operand means nums()
                    # can't see the two spacings — read them directly
                    if isinstance(operands[-3], (int, float)) and \
                            isinstance(operands[-2], (int, float)):
                        st.word_sp = float(operands[-3])
                        st.char_sp = float(operands[-2])
                    text_newline()
                    tm = _show_text(doc, canvas, st, tm, operands[-1],
                                    resources, budget, depth)
            elif op == "TJ":
                arr = operands[-1] if operands and \
                    isinstance(operands[-1], list) else None
                if arr is not None:
                    for item in arr:
                        if isinstance(item, bytes):
                            tm = _show_text(doc, canvas, st, tm, item,
                                            resources, budget, depth)
                        elif isinstance(item, (int, float)):
                            tx = -float(item) / 1000.0 * st.size \
                                * st.hscale
                            tm = _mul(_mat(1, 0, 0, 1, tx, 0), tm)
            # ------------------------------------------------- XObjects
            elif op == "BI":
                # inline image: skip to EI
                e = content.find(b"EI", lex.p)
                lex.p = len(content) if e < 0 else e + 2
            elif op == "Do":
                name = operands[-1] if operands else None
                xo = xobjects.get(str(name)) if isinstance(
                    name, Name) else None
                if isinstance(xo, Ref):
                    xd = doc.resolve(xo)
                    sub = str(doc.resolve(xd.get("Subtype"))) \
                        if isinstance(xd, dict) else ""
                    if sub == "Image":
                        raw = doc.objs.get(xo.num, (None, None))[1]
                        if raw is not None:
                            img = _decode_xobject(doc, xd, raw)
                            if img is not None:
                                _composite_image(canvas, img, st.ctm)
                    elif sub == "Form":
                        stream = doc.stream_of(xo)
                        if stream:
                            fst = st.copy()
                            fm = doc.resolve(xd.get("Matrix"))
                            if isinstance(fm, list) and len(fm) == 6:
                                fst.ctm = _mul(
                                    _mat(*[float(doc.resolve(v))
                                           for v in fm]), fst.ctm)
                            fres = doc.resolve(xd.get("Resources"))
                            _exec_content(
                                doc, canvas, stream,
                                fres if isinstance(fres, dict)
                                else resources,
                                fst, budget, depth + 1)
        except Exception:
            pass
        operands.clear()


def _decode_xobject(doc: PdfDoc, d: dict, raw: bytes):
    """Image XObject -> array, through pdfimg's stream decoders."""
    from . import pdfimg

    filt = doc.resolve(d.get("Filter"))
    filters = [str(filt).encode()] if isinstance(filt, Name) else \
        [str(f).encode() for f in (filt or [])]
    info = {b"Width": int(doc.resolve(d.get("Width", 0)) or 0),
            b"Height": int(doc.resolve(d.get("Height", 0)) or 0),
            b"Bits": int(doc.resolve(d.get("BitsPerComponent", 8)) or 8)}
    cs = str(doc.resolve(d.get("ColorSpace")) or "")
    if cs == "DeviceGray":
        info[b"_ncomp"] = 1
    elif cs == "DeviceRGB":
        info[b"_ncomp"] = 3
    dp = doc.resolve(d.get("DecodeParms"))
    if isinstance(dp, dict):
        if "Predictor" in dp:
            info[b"Predictor"] = int(doc.resolve(dp["Predictor"]))
        if "Colors" in dp:
            info[b"Colors"] = int(doc.resolve(dp["Colors"]))
        if "Columns" in dp:
            info[b"Columns"] = int(doc.resolve(dp["Columns"]))
    try:
        return pdfimg._decode_stream(info, filters, raw)
    except Exception:
        return None

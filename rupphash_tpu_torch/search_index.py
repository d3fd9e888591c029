"""In-memory inverted search index over EXIF/derived metadata.

Re-creates src/search_index.rs (1109 LoC) on Python-int bitmaps (CPython
big-int AND/OR are C-speed, the same role roaring bitmaps play in the
reference):

  * string tags: exact index (hash -> bitmap) + linear contains/regex
    fallback over stored values (search_index.rs:132-161)
  * numeric tags: sorted (value, slot) arrays, binary-search ranges with
    epsilon (search_index.rs:357-563)
  * slot reuse on remove via a free list (search_index.rs:157-249)
  * unit-aware number extraction: "f/2.8", "1/250s", "ISO 100", "24mm"
    (search_index.rs:19-69)
  * query language (search_index.rs:713-910): whitespace/';'-separated
    AND criteria of the form  tag:value | tag:op:value  with ops
    = ~ re < <= > >=, ranges "24-70", open "1600-", negative "-3-3",
    and the reference's alias table (iso, aperture, shutter, sun, ...)
"""

from __future__ import annotations

import math
import re

EPSILON = 1e-4

# canonical tag -> numeric? (exif_types.rs:259-285)
SEARCHABLE_TAGS = {
    "Make": False, "Model": False, "LensMake": False, "LensModel": False,
    "Software": False, "Artist": False, "Copyright": False,
    "Country": False, "Subdivision": False, "Timezone": False,
    "ISO": True, "FNumber": True, "FocalLength": True,
    "FocalLength35mm": True, "ExposureTime": True, "ExposureBias": True,
    "Orientation": True, "GPSAltitude": True, "SunAzimuth": True,
    "SunAltitude": True, "Timestamp": True,
    "ImageWidth": True, "ImageHeight": True, "Flash": False,
    "DateTimeOriginal": False, "PdqQuality": True,
    # the remainder of the reference's searchable namespace
    # (exif_types.rs:204-252 name_to_tag_id): camera-setting shorts
    # and rationals range-search numerically, strings exact-match
    "WhiteBalance": True, "MeteringMode": True,
    "ExposureProgram": True, "ColorSpace": True,
    "Contrast": True, "Saturation": True, "Sharpness": True,
    "SubjectDistance": True, "DigitalZoomRatio": True,
    "SceneType": False, "DateTime": False, "DateTimeDigitized": False,
    "GPSLatitude": True, "GPSLongitude": True,
}

# alias -> canonical (search_index.rs:859-910)
ALIASES = {
    "sunazimuth": "SunAzimuth", "sun_azimuth": "SunAzimuth",
    "sun_az": "SunAzimuth", "azimuth": "SunAzimuth", "az": "SunAzimuth",
    "sunposition": "SunAzimuth", "sun_position": "SunAzimuth",
    "sun": "SunAzimuth",
    "sunaltitude": "SunAltitude", "sun_altitude": "SunAltitude",
    "sun_alt": "SunAltitude", "altitude": "SunAltitude",
    "alt": "SunAltitude", "elevation": "SunAltitude",
    "country": "Country", "derivedcountry": "Country",
    "subdivision": "Subdivision", "state": "Subdivision",
    "province": "Subdivision", "region": "Subdivision",
    "timezone": "Timezone", "tz": "Timezone",
    "iso": "ISO", "isospeed": "ISO",
    "aperture": "FNumber", "fnumber": "FNumber", "f": "FNumber",
    "exposure": "ExposureTime", "exposuretime": "ExposureTime",
    "shutter": "ExposureTime",
    "focal": "FocalLength", "focallength": "FocalLength",
    "fl": "FocalLength",
    "focal35": "FocalLength35mm", "focallength35": "FocalLength35mm",
    "focallength35mm": "FocalLength35mm", "fl35": "FocalLength35mm",
    "make": "Make", "manufacturer": "Make", "brand": "Make",
    "model": "Model", "camera": "Model",
    "lens": "LensModel", "lensmodel": "LensModel", "lensmake": "LensMake",
    # reference precedence: name_to_tag_id resolves "datetime" to the
    # plain DateTime tag BEFORE the alias table maps it, so only
    # "date" reaches DateTimeOriginal (search_index.rs:859-866)
    "date": "DateTimeOriginal",
    "datetimeoriginal": "DateTimeOriginal",
    "software": "Software", "app": "Software",
    "artist": "Artist", "photographer": "Artist",
    "copyright": "Copyright", "orientation": "Orientation",
    "width": "ImageWidth", "imagewidth": "ImageWidth",
    "height": "ImageHeight", "imageheight": "ImageHeight",
    "flash": "Flash", "timestamp": "Timestamp",
    "quality": "PdqQuality", "pdqquality": "PdqQuality",
    "gpsaltitude": "GPSAltitude", "gpsalt": "GPSAltitude",
    "whitebalance": "WhiteBalance", "wb": "WhiteBalance",
    "metering": "MeteringMode", "meteringmode": "MeteringMode",
    "exposureprogram": "ExposureProgram", "program": "ExposureProgram",
    "colorspace": "ColorSpace", "contrast": "Contrast",
    "saturation": "Saturation", "sharpness": "Sharpness",
    "subjectdistance": "SubjectDistance",
    "digitalzoomratio": "DigitalZoomRatio", "scenetype": "SceneType",
    "datetimedigitized": "DateTimeDigitized",
    "datetime": "DateTime",
    "gps": "GPSLatitude", "gpslat": "GPSLatitude",
    "gpslatitude": "GPSLatitude", "lat": "GPSLatitude",
    "latitude": "GPSLatitude",
    "gpslon": "GPSLongitude", "gpslongitude": "GPSLongitude",
    "lon": "GPSLongitude", "longitude": "GPSLongitude",
}


def resolve_tag_name(name: str) -> str | None:
    if name in SEARCHABLE_TAGS:
        return name
    return ALIASES.get(name.lower())


def extract_number_from_string(s) -> float | None:
    """Unit-aware extraction (search_index.rs:19-69)."""
    if isinstance(s, (int, float)):
        return float(s)
    if isinstance(s, (list, tuple)):
        # single-rational EXIF tags (SubjectDistance, DigitalZoomRatio)
        # arrive as one-element float lists from the pipeline sweep
        for x in s:
            if isinstance(x, (int, float)):
                return float(x)
        return None
    if not isinstance(s, str):
        return None
    s = s.strip()
    if s.endswith("s") and not s.endswith("ss"):
        s = s[:-1].strip()
    low = s.lower()
    if low.startswith("f/"):
        try:
            return float(s[2:].strip())
        except ValueError:
            pass
    if "/" in s:
        before, _, after = s.partition("/")
        try:
            num, den = float(before.strip()), float(after.strip())
            if den != 0.0:
                return num / den
        except ValueError:
            pass
    # reference semantics (search_index.rs:48-62): collect the first
    # contiguous run of number-ish characters and float-parse it whole —
    # '1e-5' parses as 1e-5 (a regex '[\d.]+' would stop at the
    # mantissa) and '3-4' fails like the reference instead of
    # truncating to 3.0
    run = ""
    for ch in s:
        if ch.isdigit() or ch in ".-eE":
            run += ch
        elif run:
            break
    if run:
        try:
            return float(run)
        except ValueError:
            return None
    return None


def parse_range_value(value: str):
    """'24-70' -> (24, 70); '1600-' -> (1600, inf); '-3-3' -> (-3, 3);
    'f/2.8-f/11' -> (2.8, 11).  None if not a range."""
    # find a splitting hyphen: not at index 0, not part of an exponent
    # or fraction denominator sign
    for i, c in enumerate(value):
        if c == "-" and i > 0 and value[i - 1] not in "eE/-":
            left, right = value[:i], value[i + 1:]
            lo = extract_number_from_string(left)
            if lo is None:
                return None
            if right.strip() == "":
                return (lo, math.inf)
            hi = extract_number_from_string(right)
            if hi is None:
                return None
            return (min(lo, hi), max(lo, hi))
    return None


class Criterion:
    __slots__ = ("tag", "op", "value", "lo", "hi")

    def __init__(self, tag, op, value=None, lo=None, hi=None):
        self.tag = tag
        self.op = op
        self.value = value
        self.lo = lo
        self.hi = hi


def parse_search_query(query: str) -> list[Criterion]:
    """Whitespace/';'-separated AND criteria (search_index.rs:713-733)."""
    out = []
    for part in re.split(r"[\s;]+", query.strip()):
        if not part:
            continue
        out.append(_parse_single(part))
    if not out:
        raise ValueError("No valid search criteria provided")
    return out


def _parse_single(q: str) -> Criterion:
    parts = q.split(":", 2)
    if not parts or not parts[0]:
        raise ValueError("Empty tag name")
    tag = resolve_tag_name(parts[0])
    if tag is None:
        raise ValueError(f"Unknown tag: '{parts[0]}'")
    if len(parts) == 1:
        raise ValueError(f"Missing value for tag '{parts[0]}'")
    if len(parts) == 2:
        value = parts[1]
        if SEARCHABLE_TAGS.get(tag, False):
            rng = parse_range_value(value)
            if rng is not None:
                return Criterion(tag, "between", lo=rng[0], hi=rng[1])
            num = extract_number_from_string(value)
            if num is not None:
                return Criterion(tag, "eq_num", value=num)
        try:
            float(value)
            return Criterion(tag, "eq_num", value=float(value))
        except ValueError:
            return Criterion(tag, "contains", value=value)
    op_str, value = parts[1], parts[2]
    ops = {"=": "eq", "==": "eq", "eq": "eq",
           "~": "contains", "contains": "contains", "like": "contains",
           "re": "regex", "regex": "regex",
           "<": "lt", "lt": "lt", "<=": "le", "le": "le", "lte": "le",
           ">": "gt", "gt": "gt", ">=": "ge", "ge": "ge", "gte": "ge"}
    if op_str not in ops:
        raise ValueError(f"Unknown operator: '{op_str}'")
    op = ops[op_str]
    if op in ("lt", "le", "gt", "ge", "eq"):
        num = extract_number_from_string(value)
        if num is not None:
            return Criterion(tag, op if op != "eq" else "eq_num", value=num)
        if op != "eq":
            # numeric comparison against an unparseable value matches
            # nothing (search_index.rs:586-590), it must not carry the
            # raw string into arithmetic
            return Criterion(tag, "nothing", value=None)
    if op == "eq":
        op = "contains"
    return Criterion(tag, op, value=value)


class SearchIndex:
    """Insert features per slot; search returns a set of slot ids."""

    def __init__(self):
        self._n = 0
        self._free: list[int] = []
        self._live = 0  # bitmap of live slots
        self._exact: dict[tuple[str, str], int] = {}
        self._strings: dict[str, dict[int, str]] = {}
        self._numeric: dict[str, dict[int, float]] = {}
        self._sorted: dict[str, list[tuple[float, int]]] = {}
        self._dirty = False
        # per-slot reverse index: (exact keys, tags touched) — removal is
        # then O(slot's own tags) instead of O(every exact key in the
        # index) (search_index.rs:157-249 touches per-key only, too)
        self._slot_keys: dict[int, tuple[list, list]] = {}
        # slots whose exact bits are stale (cleared lazily on reuse;
        # queries mask with _live so stale bits are invisible)
        self._pending_scrub: dict[int, list] = {}

    def __len__(self):
        return bin(self._live).count("1")

    def alloc_slot(self) -> int:
        if self._free:
            s = self._free.pop()
            self._scrub(s)
            return s
        s = self._n
        self._n += 1
        return s

    def _scrub(self, slot: int):
        """Clear a removed slot's stale exact bits before reuse."""
        keys = self._pending_scrub.pop(slot, None)
        if not keys:
            return
        mask = ~(1 << slot)
        for k in keys:
            bm = self._exact.get(k)
            if bm is not None:
                bm &= mask
                if bm:
                    self._exact[k] = bm
                else:
                    del self._exact[k]

    def insert(self, slot: int, tags: dict):
        """tags: {tag_name: value}.  Unknown tags are ignored; every value
        is dual-indexed (string exact + numeric when extractable,
        search_index.rs:265-347)."""
        self._scrub(slot)  # defensive: callers may reuse without alloc
        self._live |= 1 << slot
        ekeys, etags = self._slot_keys.setdefault(slot, ([], []))
        for raw_name, value in tags.items():
            tag = resolve_tag_name(raw_name) or (
                raw_name if raw_name in SEARCHABLE_TAGS else None)
            if tag is None:
                continue
            sval = str(value).strip()
            if sval:
                key = (tag, sval.lower())
                self._exact[key] = self._exact.get(key, 0) | (1 << slot)
                self._strings.setdefault(tag, {})[slot] = sval
                ekeys.append(key)
                etags.append(tag)
            num = extract_number_from_string(value)
            if num is not None:
                self._numeric.setdefault(tag, {})[slot] = num
                if tag not in etags:
                    etags.append(tag)
                self._dirty = True

    def _teardown_slot(self, slot: int):
        """Per-slot removal body shared by remove/remove_many (the
        _live mask update is the caller's, so bulk removal can batch
        it)."""
        ekeys, etags = self._slot_keys.pop(slot, ((), ()))
        for tag in etags:
            d = self._strings.get(tag)
            if d is not None:
                d.pop(slot, None)
            d = self._numeric.get(tag)
            if d is not None and slot in d:
                del d[slot]
                self._dirty = True
        if ekeys:
            self._pending_scrub[slot] = list(ekeys)
        self._free.append(slot)

    def remove(self, slot: int):
        """Frees the slot for reuse (search_index.rs:157-249).
        O(the slot's own tags): exact bits are masked out by _live at
        query time and scrubbed lazily when the slot is reused."""
        if not (self._live >> slot) & 1:
            return  # double remove would double-free the slot id
        self._live &= ~(1 << slot)
        self._teardown_slot(slot)

    def remove_many(self, slots) -> int:
        """Bulk removal (directory deletion under the watcher): one
        _live mask update for the whole batch."""
        slots = [s for s in slots if (self._live >> s) & 1]
        if not slots:
            return 0
        mask = 0
        for s in slots:
            mask |= 1 << s
        self._live &= ~mask
        for s in slots:
            self._teardown_slot(s)
        return len(slots)

    def finalize(self):
        """Sort numeric posting lists (search_index.rs:357-380)."""
        self._sorted = {tag: sorted((v, s) for s, v in d.items())
                        for tag, d in self._numeric.items()}
        self._dirty = False

    # -- evaluation ---------------------------------------------------------
    def _numeric_bitmap(self, tag, lo, hi) -> int:
        """Slots with lo - eps <= value <= hi + eps."""
        if self._dirty:
            self.finalize()
        import bisect
        lst = self._sorted.get(tag, [])
        i0 = bisect.bisect_left(lst, (lo - EPSILON, -1))
        i1 = bisect.bisect_right(lst, (hi + EPSILON, 1 << 62))
        bm = 0
        for _, s in lst[i0:i1]:
            bm |= 1 << s
        return bm

    def _eval(self, c: Criterion) -> int:
        inf = math.inf
        if c.op == "nothing":  # unparseable numeric comparison value
            return 0
        if c.op == "between":
            return self._numeric_bitmap(c.tag, c.lo, c.hi)
        if c.op == "eq_num":
            return self._numeric_bitmap(c.tag, c.value, c.value)
        if c.op == "lt":
            return self._numeric_bitmap(c.tag, -inf, c.value - EPSILON * 2)
        if c.op == "le":
            return self._numeric_bitmap(c.tag, -inf, c.value)
        if c.op == "gt":
            return self._numeric_bitmap(c.tag, c.value + EPSILON * 2, inf)
        if c.op == "ge":
            return self._numeric_bitmap(c.tag, c.value, inf)
        if c.op == "contains":
            needle = str(c.value).lower()
            exact = self._exact.get((c.tag, needle), 0)
            bm = exact
            for slot, sval in self._strings.get(c.tag, {}).items():
                if needle in sval.lower():
                    bm |= 1 << slot
            return bm
        if c.op == "regex":
            rx = re.compile(str(c.value), re.IGNORECASE)
            bm = 0
            for slot, sval in self._strings.get(c.tag, {}).items():
                if rx.search(sval):
                    bm |= 1 << slot
            return bm
        raise ValueError(c.op)

    def search(self, query: str) -> set[int]:
        """AND of all criteria; returns live slot ids."""
        criteria = parse_search_query(query)
        bm = self._live
        for c in criteria:
            bm &= self._eval(c)
            if bm == 0:
                break
        out = set()
        s = bm
        while s:
            low = s & -s
            out.add(low.bit_length() - 1)
            s ^= low
        return out

    def stats(self) -> dict:
        return {
            "live": len(self),
            "exact_keys": len(self._exact),
            "numeric_tags": {t: len(d) for t, d in self._numeric.items()},
        }


def features_to_tags(features: dict, quality: int | None = None) -> dict:
    """Map a pipeline features record (pipeline/exif.py) + derived values
    into the searchable tag namespace."""
    tags = dict(features.get("tags", {}))
    out = {}
    for k, v in tags.items():
        if resolve_tag_name(k):
            out[k] = v
    if features.get("width"):
        out["ImageWidth"] = features["width"]
        out["ImageHeight"] = features["height"]
    if features.get("orientation"):
        out["Orientation"] = features["orientation"]
    if features.get("exif_timestamp"):
        out["Timestamp"] = features["exif_timestamp"]
    if features.get("altitude") is not None:
        out["GPSAltitude"] = features["altitude"]
    if features.get("gps"):
        out["GPSLatitude"] = round(float(features["gps"][0]), 6)
        out["GPSLongitude"] = round(float(features["gps"][1]), 6)
    if quality is not None:
        out["PdqQuality"] = quality
    sun = None
    try:
        from .pipeline import exif as exif_mod
        sun = exif_mod.derive_sun_position(features)
    except Exception:
        pass
    if sun:
        out["SunAzimuth"] = round(sun["sun_azimuth"], 4)
        out["SunAltitude"] = round(sun["sun_altitude"], 4)
    try:
        from .pipeline import exif as exif_mod
        loc = exif_mod.derive_location(features)
    except Exception:
        loc = {}
    if loc.get("country"):
        out["Country"] = loc["country"]
    if loc.get("subdivision"):
        out["Subdivision"] = loc["subdivision"]
    if loc.get("timezone"):
        out["Timezone"] = loc["timezone"]
    return out

"""EXIF extraction and derived metadata.

Re-creates the reference's metadata subsystem (src/exif_extract.rs,
src/exif_types.rs, src/raw_exif.rs) on PIL's EXIF reader:

  GPS DMS -> decimal with hemisphere refs       exif_extract.rs:48-90
  GPS validity (Null Island, NaN, range)        raw_exif.rs:122-128
  GPS-UTC vs DateTimeOriginal timestamps        exif_extract.rs:93-169
  altitude with below-sea-level ref             exif_extract.rs:172-193
  full-tag sweep skipping thumbnail blobs       exif_extract.rs:209-354
  derived values: sun azimuth/altitude          exif_extract.rs:477-506
  feature record (width/height/tags)            image_features.rs

Derived tags use the reference's synthetic ID range 0xF001-0xF007
(exif_types.rs:62-74).  Country/Subdivision/Timezone (0xF001/2/5) come
from the offline tzdata-anchor lookup in utils.geonames (the reference
uses polygon DBs from the country-boundaries + tzf-rs crates, which
have no offline equivalent in this image; see geonames docstring for
the substitution).
"""

from __future__ import annotations

import datetime
import math
from pathlib import Path

# Derived-tag IDs (exif_types.rs:62-74)
TAG_COUNTRY = 0xF001
TAG_SUBDIVISION = 0xF002
TAG_SUN_AZIMUTH = 0xF003
TAG_SUN_ALTITUDE = 0xF004
TAG_TIMEZONE = 0xF005
TAG_TIMESTAMP = 0xF006
TAG_PDQ_QUALITY = 0xF007

MAX_TAG_SIZE = 1024  # exif_types.rs:7

# Large binary blobs excluded from the searchable sweep (exif_types.rs:136-147)
_EXCLUDED_TAGS = {
    0x0201, 0x0202,          # JPEGInterchangeFormat(+Length) thumbnails
    0x927C,                  # MakerNote
    0x9286,                  # UserComment (often binary)
    0x02BC,                  # XMP
    0x8773,                  # ICC profile
}

_ORIENTATION = 0x0112
_EXIF_IFD = 0x8769
_GPS_IFD = 0x8825
_DT_ORIGINAL = 0x9003
_DT_DIGITIZED = 0x9004
_DT = 0x0132


def _ratio(v):
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def dms_to_decimal(dms, ref: str | None):
    """3 rationals + hemisphere ref -> signed decimal degrees
    (exif_extract.rs:48-90)."""
    try:
        d, m, s = (_ratio(x) for x in dms)
        if d is None or m is None or s is None:
            return None
        val = d + m / 60.0 + s / 3600.0
    except (TypeError, ValueError):
        return None
    if ref and ref.upper() in ("S", "W"):
        val = -val
    return val


def gps_valid(lat, lon) -> bool:
    """Reject Null Island, NaN, out-of-range (raw_exif.rs:122-128)."""
    if lat is None or lon is None:
        return False
    if math.isnan(lat) or math.isnan(lon):
        return False
    if abs(lat) > 90.0 or abs(lon) > 180.0:
        return False
    if abs(lat) < 0.01 and abs(lon) < 0.01:
        return False
    return True


def _parse_exif_datetime(s: str):
    """'YYYY:MM:DD HH:MM:SS' -> unix epoch (naive local, like the
    reference, exif_extract.rs:147-169)."""
    try:
        dt = datetime.datetime.strptime(s.strip()[:19], "%Y:%m:%d %H:%M:%S")
        return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp())
    except (ValueError, TypeError):
        return None


def _gps_utc_timestamp(gps: dict):
    """GPSDateStamp + GPSTimeStamp -> unix epoch UTC
    (exif_extract.rs:93-144): satellite time beats the camera clock."""
    date = gps.get(29)
    tstamp = gps.get(7)
    if not date or tstamp is None:
        return None
    try:
        y, m, d = (int(x) for x in str(date).split(":")[:3])
        h, mi = int(_ratio(tstamp[0])), int(_ratio(tstamp[1]))
        s = _ratio(tstamp[2]) or 0.0
        dt = datetime.datetime(y, m, d, h, mi, int(s),
                               tzinfo=datetime.timezone.utc)
        return int(dt.timestamp())
    except (ValueError, TypeError, IndexError):
        return None


def _png_exif_scan(data: bytes) -> tuple[bytes | None, bool]:
    """(eXIf TIFF payload | None, has_text_metadata) via a cheap chunk
    walk.  has_text_metadata flags the Pillow-recognized text-chunk
    carriers — ImageMagick's 'Raw profile type exif' (tEXt/zTXt/iTXt)
    and XMP ('XML:com.adobe.xmp') — whose presence sends extract()
    down the exact im.getexif() path; PNGs with neither (the common
    case) skip the full image decode that path costs."""
    import struct
    blob = None
    has_text = False
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack_from(">I", data, pos)
        typ = data[pos + 4:pos + 8]
        if typ == b"eXIf" and blob is None:
            blob = bytes(data[pos + 8:pos + 8 + length])
        elif typ in (b"tEXt", b"zTXt", b"iTXt"):
            kw = bytes(data[pos + 8:pos + 8 + min(length, 32)])
            kw = kw.split(b"\x00", 1)[0]
            if kw in (b"Raw profile type exif", b"Raw profile type APP1",
                      b"XML:com.adobe.xmp"):
                has_text = True
        elif typ == b"IEND":
            break
        pos += 12 + length
    return blob, has_text


def extract(path: str | Path | None = None, data: bytes | None = None) -> dict:
    """Extract features from a file path or raw bytes.

    Returns {width, height, orientation, gps, altitude, exif_timestamp,
    gps_timestamp, tags {name: value}} — the analogue of ImageFeatures
    (image_features.rs:31-112).  Missing EXIF yields an empty record,
    never an exception.
    """
    from PIL import ExifTags, Image
    import io

    out: dict = {"width": 0, "height": 0, "orientation": 1, "gps": None,
                 "altitude": None, "exif_timestamp": None,
                 "gps_timestamp": None, "tags": {}}
    try:
        src = io.BytesIO(data) if data is not None else path
        with Image.open(src) as im:
            out["width"], out["height"] = im.width, im.height
            if data is not None \
                    and data[:8] == b"\x89PNG\r\n\x1a\n":
                # PIL's PNG getexif() fully DECODES the image when no
                # eXIf chunk precedes IDAT (post-IDAT chunk search) —
                # a redundant multi-ms decode per PNG at scan rate.
                # A direct chunk walk reads the same blob for free.
                # Pillow-recognized TEXT metadata (ImageMagick's 'Raw
                # profile type exif', XMP orientation) routes to the
                # exact im.getexif() path so those files keep their
                # pre-walk semantics.
                blob, has_text = _png_exif_scan(data)
                if has_text:
                    exif = im.getexif()
                elif blob is None:
                    return out
                else:
                    exif = Image.Exif()
                    exif.load(blob)
            else:
                exif = im.getexif()
    except Exception:
        return out
    if not exif:
        return out

    try:
        orient = exif.get(_ORIENTATION)
        if isinstance(orient, int) and 1 <= orient <= 8:
            out["orientation"] = orient
    except Exception:
        pass

    # base + Exif IFD sweep into the searchable tag map
    def sweep(ifd, names):
        for tag_id, val in ifd.items():
            if tag_id in _EXCLUDED_TAGS:
                continue
            name = names.get(tag_id)
            if name is None:
                continue
            if isinstance(val, bytes):
                if len(val) > MAX_TAG_SIZE:
                    continue
                try:
                    val = val.decode("utf-8", "replace").strip("\x00 ")
                except Exception:
                    continue
            elif isinstance(val, (tuple, list)):
                val = [
                    (float(x) if _ratio(x) is not None else str(x))
                    for x in val[:16]]
            elif not isinstance(val, (int, float, str)):
                val = str(val)
            if isinstance(val, str):
                val = val.strip("\x00 ")
                if len(val) > MAX_TAG_SIZE:
                    continue
            out["tags"][name] = val

    sweep(exif, ExifTags.TAGS)
    try:
        sweep(exif.get_ifd(_EXIF_IFD), ExifTags.TAGS)
    except Exception:
        pass

    # timestamps: DateTimeOriginal > DateTimeDigitized > DateTime
    try:
        exif_ifd = exif.get_ifd(_EXIF_IFD)
    except Exception:
        exif_ifd = {}
    for tag in (_DT_ORIGINAL, _DT_DIGITIZED):
        v = exif_ifd.get(tag)
        if v:
            out["exif_timestamp"] = _parse_exif_datetime(str(v))
            if out["exif_timestamp"]:
                break
    if out["exif_timestamp"] is None and exif.get(_DT):
        out["exif_timestamp"] = _parse_exif_datetime(str(exif.get(_DT)))

    # GPS
    try:
        gps = exif.get_ifd(_GPS_IFD)
    except Exception:
        gps = {}
    if gps:
        lat = dms_to_decimal(gps.get(2), gps.get(1)) if gps.get(2) else None
        lon = dms_to_decimal(gps.get(4), gps.get(3)) if gps.get(4) else None
        if gps_valid(lat, lon):
            out["gps"] = [lat, lon]
        alt = _ratio(gps.get(6)) if gps.get(6) is not None else None
        if alt is not None:
            ref = gps.get(5)
            if isinstance(ref, (bytes, int)) and (
                    ref == 1 or ref == b"\x01"):
                alt = -alt
            out["altitude"] = alt
        out["gps_timestamp"] = _gps_utc_timestamp(gps)
    return out


def derive_sun_position(features: dict, use_gps_time: bool = True):
    """Sun (altitude, azimuth) at the capture position/time, or None.
    Mirrors exif_extract.rs:477-506: GPS-UTC time preferred (the fixture
    note tests/Kaanapali_*.txt documents why the camera clock lies)."""
    from ..utils import sunpos

    if not features.get("gps"):
        return None
    ts = (features.get("gps_timestamp") if use_gps_time else None) \
        or features.get("exif_timestamp")
    if ts is None:
        return None
    lat, lon = features["gps"]
    dt = datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)
    alt, az = sunpos.solar_position(lat, lon, dt)
    return {"sun_altitude": alt, "sun_azimuth": az}


def derive_location(features: dict) -> dict:
    """Country / Subdivision / Timezone derived tags from GPS
    (exif_extract.rs:435-474), via the offline tzdata-anchor lookup in
    utils.geonames.  Empty dict when there is no (valid) GPS fix or no
    tzdata tables on this host."""
    if not features.get("gps"):
        return {}
    from ..utils import geonames

    lat, lon = features["gps"]
    try:
        return geonames.derive_location(lat, lon)
    except Exception:
        return {}

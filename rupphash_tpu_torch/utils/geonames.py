"""Offline reverse geocoding: timezone / country / subdivision from GPS.

The reference derives three tags from GPS coordinates
(exif_extract.rs:435-474, position.rs:14-30):

  Timezone (0xF005)    via tzf-rs polygon lookup, Etc/* fallback
  Country (0xF001)     via the country-boundaries polygon DB + ISO-3166
  Subdivision (0xF002) same DB (admin-1, e.g. "Florida")

Those crates embed polygon databases that do not exist in this image
(zero egress), so this module rebuilds the capability from data that
*is* here — the IANA tzdata tables shipped with every Linux:

  /usr/share/zoneinfo/zone1970.tab   ~340 zones with principal
                                     coordinates + country code lists
  /usr/share/zoneinfo/iso3166.tab    country code -> English name

Method: nearest-anchor great-circle lookup over the zone1970 principal
locations *plus* embedded worldwide admin-1 anchor tables
(state/province/region centroids and major cities with their dominant
timezone): US/CA/AU below, ~60 more countries in utils/admin1_data.py.
Points farther than `OCEAN_KM` from every anchor fall back to the
nautical Etc/GMT± zone by longitude (the reference's own fallback,
position.rs:21-29).  Nearest-anchor is approximate near land borders —
a documented substitution with the same tag surface.
"""

from __future__ import annotations

import math
import threading
from pathlib import Path

ZONEINFO = Path("/usr/share/zoneinfo")
OCEAN_KM = 500.0      # farther than this from any anchor -> Etc/GMT±
COUNTRY_KM = 500.0    # farther than this -> no country tag
TZ_LOCAL_KM = 100.0   # a FOREIGN anchor is a valid tz proxy only this
                      # close (the El Paso / Cd. Juarez class); farther
                      # foreign anchors lose to the ring country's zones

# ISO-3166 *official* English names where they differ from the tzdata
# short names; the reference's iso3166 crate prints these forms
# (the reference's own regression: derive_country(28.68, -81.31) ==
# "Florida, United States of America (the)", scanner.rs:2854-2866).
_OFFICIAL = {
    "US": "United States of America (the)",
    "GB": "United Kingdom of Great Britain and Northern Ireland (the)",
    "NL": "Netherlands (Kingdom of the)",
    "RU": "Russian Federation (the)",
    "KR": "Korea (the Republic of)",
    "KP": "Korea (the Democratic People's Republic of)",
    "PH": "Philippines (the)",
    "AE": "United Arab Emirates (the)",
    "VN": "Viet Nam",
    "LA": "Lao People's Democratic Republic (the)",
    "SY": "Syrian Arab Republic (the)",
    "IR": "Iran (Islamic Republic of)",
    "BO": "Bolivia (Plurinational State of)",
    "VE": "Venezuela (Bolivarian Republic of)",
    "TZ": "Tanzania (the United Republic of)",
    "MD": "Moldova (the Republic of)",
    "CD": "Congo (the Democratic Republic of the)",
    "CG": "Congo (the)",
    "DO": "Dominican Republic (the)",
    "NE": "Niger (the)",
    "SD": "Sudan (the)",
    "GM": "Gambia (the)",
    "BS": "Bahamas (the)",
    "CF": "Central African Republic (the)",
    "BN": "Brunei Darussalam",
}

# Admin-1 anchors: name -> (dominant tz, [(lat, lon), ...]).  Each
# subdivision carries its centroid plus major cities so coastal metros
# resolve to the right state (a single centroid puts Sydney in the ACT).
_E, _C, _M, _P = ("America/New_York", "America/Chicago",
                  "America/Denver", "America/Los_Angeles")
_US_STATES = {
    "Alabama": (_C, [(32.8, -86.8)]),
    "Alaska": ("America/Anchorage", [(64.0, -152.0), (61.2, -149.9)]),
    "Arizona": ("America/Phoenix", [(34.3, -111.7), (33.45, -112.07)]),
    "Arkansas": (_C, [(34.9, -92.4)]),
    "California": (_P, [(37.2, -119.3), (34.05, -118.24),
                        (37.77, -122.42), (32.72, -117.16)]),
    "Colorado": (_M, [(39.0, -105.5), (39.74, -104.98)]),
    "Connecticut": (_E, [(41.6, -72.7)]),
    "Delaware": (_E, [(39.0, -75.5)]),
    "Florida": (_E, [(28.6, -82.4), (25.77, -80.19), (28.54, -81.38),
                     (30.33, -81.66)]),
    "Georgia": (_E, [(32.6, -83.4), (33.75, -84.39)]),
    "Hawaii": ("Pacific/Honolulu", [(20.3, -156.4), (21.31, -157.86)]),
    "Idaho": (_M, [(44.4, -114.6), (43.62, -116.2)]),
    "Illinois": (_C, [(40.0, -89.2), (41.85, -87.65)]),
    "Indiana": (_E, [(39.9, -86.3)]),
    "Iowa": (_C, [(42.1, -93.5)]),
    "Kansas": (_C, [(38.5, -98.4)]),
    "Kentucky": (_E, [(37.5, -85.3)]),
    "Louisiana": (_C, [(31.0, -92.0), (29.95, -90.07)]),
    "Maine": (_E, [(45.4, -69.2)]),
    "Maryland": (_E, [(39.0, -76.8)]),
    "Massachusetts": (_E, [(42.3, -71.8), (42.36, -71.06)]),
    "Michigan": (_E, [(44.3, -85.4), (42.33, -83.05)]),
    "Minnesota": (_C, [(46.3, -94.3), (44.98, -93.27)]),
    "Mississippi": (_C, [(32.7, -89.7)]),
    "Missouri": (_C, [(38.4, -92.5), (38.63, -90.2)]),
    "Montana": (_M, [(47.0, -109.6)]),
    "Nebraska": (_C, [(41.5, -99.8), (41.26, -95.93)]),
    "Nevada": (_P, [(39.3, -116.6), (36.17, -115.14)]),
    "New Hampshire": (_E, [(43.7, -71.6)]),
    "New Jersey": (_E, [(40.2, -74.7)]),
    "New Mexico": (_M, [(34.4, -106.1), (35.08, -106.65)]),
    "New York": (_E, [(43.0, -75.5), (40.71, -74.01)]),
    "North Carolina": (_E, [(35.5, -79.4), (35.23, -80.84)]),
    "North Dakota": (_C, [(47.4, -100.5)]),
    "Ohio": (_E, [(40.3, -82.8), (39.96, -83.0)]),
    "Oklahoma": (_C, [(35.6, -97.5)]),
    "Oregon": (_P, [(43.9, -120.6), (45.52, -122.68)]),
    "Pennsylvania": (_E, [(40.9, -77.8), (39.95, -75.17),
                          (40.44, -80.0)]),
    "Rhode Island": (_E, [(41.7, -71.6)]),
    "South Carolina": (_E, [(33.9, -80.9)]),
    "South Dakota": (_C, [(44.4, -100.2)]),
    "Tennessee": (_C, [(35.8, -86.4), (36.16, -86.78),
                       (35.15, -90.05)]),
    "Texas": (_C, [(31.5, -99.3), (29.76, -95.37), (32.78, -96.8),
                   (30.27, -97.74), (29.42, -98.49), (31.8, -106.4)]),
    "Utah": (_M, [(39.3, -111.7), (40.76, -111.89)]),
    "Vermont": (_E, [(44.1, -72.7)]),
    "Virginia": (_E, [(37.5, -78.9), (36.85, -75.98)]),
    "Washington": (_P, [(47.4, -120.5), (47.6, -122.33)]),
    "West Virginia": (_E, [(38.6, -80.6)]),
    # Superior anchor: the MN ring excludes the WI side of the
    # Duluth/Superior bay, so the fallback must not grab it for MN
    "Wisconsin": (_C, [(44.6, -90.0), (43.04, -87.91),
                       (46.72, -92.08)]),
    "Wyoming": (_M, [(43.0, -107.6)]),
    "District of Columbia": (_E, [(38.9, -77.0)]),
}
_CA_PROVINCES = {
    "Alberta": ("America/Edmonton", [(53.9, -114.7), (51.05, -114.07),
                                     (53.55, -113.49)]),
    "British Columbia": ("America/Vancouver",
                         [(54.7, -125.6), (49.28, -123.12),
                          (48.43, -123.37)]),
    "Manitoba": ("America/Winnipeg", [(54.4, -97.5), (49.9, -97.14)]),
    "New Brunswick": ("America/Halifax", [(46.6, -66.4)]),
    "Newfoundland and Labrador": ("America/St_Johns",
                                  [(53.2, -59.9), (47.56, -52.71)]),
    "Northwest Territories": ("America/Yellowknife",
                              [(64.5, -119.2), (62.45, -114.37)]),
    "Nova Scotia": ("America/Halifax", [(45.1, -63.2), (44.65, -63.57)]),
    "Nunavut": ("America/Iqaluit", [(66.0, -92.0), (63.75, -68.52)]),
    # Thunder Bay / Kenora anchors keep the Rainy River border towns
    # (Fort Frances, Rainy River) and the north Superior shore in
    # Ontario once the MN ring stops claiming that side
    "Ontario": ("America/Toronto", [(50.0, -86.0), (43.65, -79.38),
                                    (45.42, -75.7), (48.38, -89.25),
                                    (49.77, -94.49)]),
    "Prince Edward Island": ("America/Halifax", [(46.4, -63.3)]),
    "Quebec": ("America/Toronto", [(53.0, -70.0), (45.51, -73.56),
                                   (46.81, -71.21)]),
    "Saskatchewan": ("America/Regina", [(54.4, -105.9), (50.45, -104.6),
                                        (52.13, -106.67)]),
    "Yukon": ("America/Whitehorse", [(63.6, -135.5), (60.72, -135.06)]),
}
_AU_STATES = {
    "New South Wales": ("Australia/Sydney",
                        [(-32.2, 147.0), (-33.87, 151.21)]),
    "Victoria": ("Australia/Melbourne",
                 [(-36.9, 144.3), (-37.81, 144.96)]),
    "Queensland": ("Australia/Brisbane",
                   [(-22.5, 144.4), (-27.47, 153.03), (-16.92, 145.77)]),
    "South Australia": ("Australia/Adelaide",
                        [(-30.0, 135.8), (-34.93, 138.6)]),
    "Western Australia": ("Australia/Perth",
                          [(-25.5, 122.3), (-31.95, 115.86)]),
    "Tasmania": ("Australia/Hobart", [(-42.0, 146.6), (-42.88, 147.33)]),
    "Northern Territory": ("Australia/Darwin",
                           [(-19.4, 133.4), (-12.46, 130.84)]),
    "Australian Capital Territory": ("Australia/Sydney",
                                     [(-35.31, 149.13)]),
}
_SUBDIVISIONS = {"US": _US_STATES, "CA": _CA_PROVINCES, "AU": _AU_STATES}

_lock = threading.Lock()
_anchors = None     # list of (lat, lon, tzname, code, subdivision|None)
_countries = None   # code -> name
_country_zones = None  # code -> [(lat, lon, tzname)] from the FULL
                       # zone1970 country list (an anchor tuple keeps
                       # only the first code, so e.g. Mali's canonical
                       # Africa/Abidjan zone is reachable only here)
_anchor_xyz = None  # (N, 3) unit vectors for vectorized nearest lookup
_sub_idx = None     # indices of subdivision-bearing anchors
_sub_idx_cc: dict = {}  # ... filtered per country code


def _parse_iso6709(s: str):
    """±DDMM±DDDMM or ±DDMMSS±DDDMMSS -> (lat, lon) degrees."""
    split = 5 if s[5] in "+-" else 7

    def _deg(part, dd):
        sign = -1.0 if part[0] == "-" else 1.0
        d = int(part[1:1 + dd])
        m = int(part[1 + dd:3 + dd])
        sec = int(part[3 + dd:5 + dd]) if len(part) > 3 + dd else 0
        return sign * (d + m / 60.0 + sec / 3600.0)

    return _deg(s[:split], 2), _deg(s[split:], 3)


def _load():
    global _anchors, _countries, _country_zones
    if _anchors is not None:
        return _anchors, _countries
    with _lock:
        if _anchors is not None:
            return _anchors, _countries
        anchors, countries = [], {}
        czones: dict = {}
        try:
            for line in (ZONEINFO / "iso3166.tab").read_text(
                    encoding="utf-8").splitlines():
                if line.startswith("#") or "\t" not in line:
                    continue
                code, name = line.split("\t", 1)
                countries[code.strip()] = name.strip()
            for line in (ZONEINFO / "zone1970.tab").read_text(
                    encoding="utf-8").splitlines():
                if line.startswith("#"):
                    continue
                parts = line.split("\t")
                if len(parts) < 3:
                    continue
                try:
                    lat, lon = _parse_iso6709(parts[1])
                except (ValueError, IndexError):
                    continue
                anchors.append((lat, lon, parts[2],
                                parts[0].split(",")[0], None))
                for c in parts[0].split(","):
                    czones.setdefault(c.strip(), []).append(
                        (lat, lon, parts[2]))
        except OSError:
            pass
        if anchors:  # only add admin-1 anchors when tzdata is present
            for code, table in _SUBDIVISIONS.items():
                for name, (tz, points) in table.items():
                    for lat, lon in points:
                        anchors.append((lat, lon, tz, code, name))
                        czones.setdefault(code, []).append(
                            (lat, lon, tz))
            # worldwide admin-1 anchor tables (admin1_data.py): the
            # offline substitution for the reference's polygon DB
            # (exif_extract.rs:435-474)
            from .admin1_data import ADMIN1
            for code, (default_tz, subs) in ADMIN1.items():
                for entry in subs:
                    name, lat, lon = entry[0], entry[1], entry[2]
                    tz = entry[3] if len(entry) > 3 else default_tz
                    anchors.append((lat, lon, tz, code, name))
                    czones.setdefault(code, []).append((lat, lon, tz))
        _country_zones = czones
        _anchors, _countries = anchors, countries
        return _anchors, _countries


def available() -> bool:
    anchors, _ = _load()
    return bool(anchors)


def _haversine_km(lat1, lon1, lat2, lon2) -> float:
    r = 6371.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dl = math.radians(lon2 - lon1)
    a = (math.sin((p2 - p1) / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
    return 2 * r * math.asin(min(1.0, math.sqrt(a)))


def _xyz_table():
    """(N, 3) unit vectors of every anchor, built once — the anchor set
    is ~1.3k points now, so per-photo lookups are one numpy matvec."""
    global _anchor_xyz
    if _anchor_xyz is None:
        import numpy as np
        anchors, _ = _load()
        lats = np.radians([a[0] for a in anchors])
        lons = np.radians([a[1] for a in anchors])
        _anchor_xyz = np.stack([np.cos(lats) * np.cos(lons),
                                np.cos(lats) * np.sin(lons),
                                np.sin(lats)], axis=1)
    return _anchor_xyz


def _point_xyz(lat: float, lon: float):
    import numpy as np
    la, lo = math.radians(lat), math.radians(lon)
    return np.array([math.cos(la) * math.cos(lo),
                     math.cos(la) * math.sin(lo), math.sin(la)])


def nearest_anchor(lat: float, lon: float):
    """(tzname, country_code, subdivision|None, distance_km) of the
    nearest anchor, or None when tzdata tables are missing."""
    import numpy as np
    anchors, _ = _load()
    if not anchors:
        return None
    dots = _xyz_table() @ _point_xyz(lat, lon)
    i = int(np.argmax(dots))  # max cos(angle) == min great circle
    best = anchors[i]
    return best[2], best[3], best[4], _haversine_km(lat, lon,
                                                    best[0], best[1])


def nearest_subdivision(lat: float, lon: float, country: str | None = None):
    """(subdivision, country_code, distance_km) of the nearest anchor
    that *carries* an admin-1 name — a plain zone1970 city anchor can
    sit closer without shadowing the subdivision table.  With
    `country`, only that country's subdivision anchors compete: a
    point PROVEN inside a country ring must not lose its admin-1 to a
    closer foreign anchor (Woodlands SG sits nearer the Johor anchor
    than any Singapore one)."""
    import numpy as np
    global _sub_idx
    anchors, _ = _load()
    if not anchors:
        return None
    if country is None:
        if _sub_idx is None:
            _sub_idx = np.array([i for i, a in enumerate(anchors)
                                 if a[4] is not None], dtype=np.int64)
        idx = _sub_idx
    else:
        idx = _sub_idx_cc.get(country)
        if idx is None:
            idx = np.array([i for i, a in enumerate(anchors)
                            if a[4] is not None and a[3] == country],
                           dtype=np.int64)
            _sub_idx_cc[country] = idx
    if idx.size == 0:
        return None
    dots = _xyz_table()[idx] @ _point_xyz(lat, lon)
    best = anchors[int(idx[int(np.argmax(dots))])]
    return best[4], best[3], _haversine_km(lat, lon, best[0], best[1])


def timezone_name(lat: float, lon: float) -> str | None:
    """IANA zone name; nautical Etc/GMT± fallback offshore
    (reference fallback: position.rs:21-29).

    A point beyond anchor range that sits INSIDE an exact country ring
    is land, not ocean: it takes the nearest of its own country's
    zone1970 zones (tzdb's canonical covering zone — e.g. interior
    Mali is Africa/Abidjan, which zone1970 lists for
    CI,BF,...,ML,MR,...) instead of the nautical fallback.

    A nearby foreign anchor beats the ring country's own zone list
    only within TZ_LOCAL_KM: El Paso sits 4 km from the Ciudad Juarez
    zone point and shares its Mountain offset (the US list would send
    it to Chicago time), but Yerevan 370 km from Silopi must NOT drag
    southeastern Turkey to UTC+4 when the TR ring already proves the
    point is Turkish land."""
    hit = nearest_anchor(lat, lon)
    from . import geopoly
    poly = None
    if hit is not None and hit[3] <= OCEAN_KM:
        poly = geopoly.lookup(lat, lon)
        if poly is None or hit[1] == poly[0] or hit[3] <= TZ_LOCAL_KM:
            return hit[0]
        # inside a ring whose country disagrees with a FAR anchor:
        # prefer the ring country's own zones (fall through)
    elif hit is None or hit[3] > OCEAN_KM:
        poly = geopoly.lookup(lat, lon)
    if poly is not None:
        _load()
        zones = (_country_zones or {}).get(poly[0])
        if zones:
            import math
            la, lo = math.radians(lat), math.radians(lon)

            def d2(z):
                zla, zlo = math.radians(z[0]), math.radians(z[1])
                return ((zla - la) ** 2
                        + (math.cos(la) * (zlo - lo)) ** 2)
            return min(zones, key=d2)[2]
        if hit is not None and hit[3] <= OCEAN_KM:
            # ringed country with no zone list: the far foreign
            # anchor is still better than the nautical guess
            return hit[0]
    # nautical convention: Etc/GMT signs are inverted (POSIX)
    offset = int(round(-lon / 15.0))
    if offset == 0:
        return "Etc/GMT"
    return f"Etc/GMT{offset:+d}"


def country_name(lat: float, lon: float) -> str | None:
    hit = nearest_anchor(lat, lon)
    if hit is None or hit[3] > COUNTRY_KM:
        return None
    _, countries = _load()
    return _OFFICIAL.get(hit[1]) or countries.get(hit[1])


def _subdivision_for(hit, lat: float, lon: float) -> str | None:
    """The admin-1 name for a point whose nearest anchor is `hit`: the
    nearest subdivision anchor, accepted only when it agrees with the
    nearest anchor's country (no cross-border grabs) and is in range."""
    if hit[2] is not None:
        return hit[2]
    sub = nearest_subdivision(lat, lon)
    if sub is not None and sub[1] == hit[1] and sub[2] <= COUNTRY_KM:
        return sub[0]
    return None


def _ring_subdivision(code: str, lat: float, lon: float) -> str | None:
    """Admin-1 for a point inside a country-level ring: the nearest
    subdivision anchor, accepted only within the ring's country (the
    exact border must never be crossed by a nearest-subdivision grab)
    and in range.  Shared by subdivision_name and derive_location so
    the two can never disagree about the same coordinates."""
    sub = nearest_subdivision(lat, lon, country=code)
    if sub is not None and sub[2] <= COUNTRY_KM:
        return sub[0]
    return None


def subdivision_name(lat: float, lon: float) -> str | None:
    from . import geopoly
    poly = geopoly.lookup(lat, lon)
    if poly is not None:
        if poly[1] is not None:
            return poly[1]
        return _ring_subdivision(poly[0], lat, lon)
    hit = nearest_anchor(lat, lon)
    if hit is None or hit[3] > COUNTRY_KM:
        return None
    return _subdivision_for(hit, lat, lon)


def derive_location(lat: float, lon: float) -> dict:
    """All three derived tags at once; the reference formats country as
    'Subdivision, Country' when a subdivision exists
    (scanner.rs:2854-2866)."""
    out: dict = {}
    hit = nearest_anchor(lat, lon)
    tz = timezone_name(lat, lon)
    if tz:
        out["timezone"] = tz
    # exact point-in-polygon assignment first (the reference's
    # country-boundaries mechanism, exif_extract.rs:435-474); anchors
    # only decide where no shipped ring covers the point
    from . import geopoly
    poly = geopoly.lookup(lat, lon)
    if poly is not None:
        code, sub = poly
        _, countries = _load()
        country = _OFFICIAL.get(code) or countries.get(code)
        if sub is None:
            # country-level ring: exact country, anchor-resolved
            # admin-1 constrained to that country
            sub = _ring_subdivision(code, lat, lon)
        if country:
            out["country"] = f"{sub}, {country}" if sub else country
        if sub:
            out["subdivision"] = sub
        return out
    if hit is not None and hit[3] <= COUNTRY_KM:
        _, countries = _load()
        country = _OFFICIAL.get(hit[1]) or countries.get(hit[1])
        sub = _subdivision_for(hit, lat, lon)
        if country:
            out["country"] = f"{sub}, {country}" if sub else country
        if sub:
            out["subdivision"] = sub
    return out

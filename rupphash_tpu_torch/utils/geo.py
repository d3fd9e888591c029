"""GPS marker utilities: path ordering and geo distance filters.

Library form of the reference GUI's map logic (src/gui/gps_map.rs):

  order_markers       connect-the-dots path ordering: NN-greedy +
                      deadline-bounded 2-opt for small sets, Morton
                      (Z-order) curve for large ones, or chronological
                      by EXIF timestamp (gps_map.rs:44-243,456-539)
  antimeridian        longitude unwrapping so Pacific tracks don't zig
                      across the map (gps_map.rs:182-243)
  GeoDistanceFilter   `DistanceFrom:NAME:RANGE` /
                      `distancelonlat:LON:LAT:RANGE` search filters
                      against config locations (gui/dialogs.rs:1680-1900)
"""

from __future__ import annotations

import math
import time

from . import sunpos

MORTON_THRESHOLD = 2000  # gps_map.rs: 2-opt below, Z-order above
TWO_OPT_DEADLINE_S = 0.25


def _unwrap_lons(points):
    """Shift longitudes so a track crossing the antimeridian stays
    contiguous (gps_map.rs:182-243)."""
    lons = [p[1] for p in points]
    if not lons:
        return points
    span = max(lons) - min(lons)
    if span <= 180.0:
        return points
    return [(lat, lon + 360.0 if lon < 0 else lon) for lat, lon in points]


def _dist2(a, b):
    dlat = a[0] - b[0]
    dlon = (a[1] - b[1]) * math.cos(math.radians((a[0] + b[0]) / 2))
    return dlat * dlat + dlon * dlon


def _nn_greedy(points):
    n = len(points)
    unvisited = set(range(1, n))
    order = [0]
    cur = 0
    while unvisited:
        nxt = min(unvisited, key=lambda j: _dist2(points[cur], points[j]))
        unvisited.discard(nxt)
        order.append(nxt)
        cur = nxt
    return order


def _two_opt(points, order, deadline_s=TWO_OPT_DEADLINE_S):
    """Deadline-bounded 2-opt improvement (gps_map.rs:88-152)."""
    n = len(order)
    t0 = time.monotonic()
    improved = True
    while improved and time.monotonic() - t0 < deadline_s:
        improved = False
        for i in range(1, n - 1):
            if time.monotonic() - t0 > deadline_s:
                break
            for j in range(i + 1, n):
                a, b = points[order[i - 1]], points[order[i]]
                c = points[order[j]]
                d = points[order[(j + 1) % n]] if j + 1 < n else None
                before = _dist2(a, b) + (_dist2(c, d) if d else 0.0)
                after = _dist2(a, c) + (_dist2(b, d) if d else 0.0)
                if after + 1e-15 < before:
                    order[i:j + 1] = order[i:j + 1][::-1]
                    improved = True
    return order


def _morton_key(lat: float, lon: float) -> int:
    """Interleave 21-bit quantized lat/lon into a Z-order key
    (gps_map.rs:155-169; scalar equivalent of the BMI2 _pdep_u64 path)."""
    # mod guards the 21-bit quantization against out-of-domain input
    # (overflow used to corrupt the interleave entirely); the caller
    # re-centers unwrapped antimeridian tracks so adjacency survives
    x = int(((lon + 180.0) % 360.0) / 360.0 * ((1 << 21) - 1))
    y = int((max(-90.0, min(90.0, lat)) + 90.0) / 180.0
            * ((1 << 21) - 1))

    def spread(v):
        v &= (1 << 21) - 1
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v
    return spread(x) | (spread(y) << 1)


def order_markers(points, timestamps=None, mode: str = "auto"):
    """Return an index ordering for a list of (lat, lon) markers.

    mode: "auto" (NN+2-opt below MORTON_THRESHOLD, else Morton),
    "chronological" (by timestamps, None-timestamps last),
    "morton", "nn".  Mirrors gps_map.rs:44-243.
    """
    n = len(points)
    if n <= 1:
        return list(range(n))
    if mode == "chronological":
        if timestamps is None:
            raise ValueError("chronological ordering needs timestamps")
        return sorted(range(n),
                      key=lambda i: (timestamps[i] is None,
                                     timestamps[i] or 0))
    pts = _unwrap_lons(points)
    if mode == "morton" or (mode == "auto" and n >= MORTON_THRESHOLD):
        # re-center the (possibly unwrapped past 180) longitudes onto
        # the quantization domain: without this a track crossing the
        # antimeridian splits into two runs at opposite curve ends —
        # exactly the jump the unwrap exists to prevent
        lon0 = min(p[1] for p in pts)
        return sorted(range(n),
                      key=lambda i: _morton_key(
                          pts[i][0], pts[i][1] - lon0 - 180.0))
    order = _nn_greedy(pts)
    return _two_opt(pts, order)


def fit_bounds(points):
    """(center, span) for map fit-to-markers (gps_map.rs:332)."""
    pts = _unwrap_lons(points)
    lats = [p[0] for p in pts]
    lons = [p[1] for p in pts]
    center = ((min(lats) + max(lats)) / 2, (min(lons) + max(lons)) / 2)
    if center[1] > 180.0:
        center = (center[0], center[1] - 360.0)
    return center, (max(lats) - min(lats), max(lons) - min(lons))


class GeoDistanceFilter:
    """Search filter: files within range_km of a point
    (gui/dialogs.rs:15-19, 1680-1900)."""

    def __init__(self, lat: float, lon: float, range_km: float):
        self.lat = lat
        self.lon = lon
        self.range_m = range_km * 1000.0

    @classmethod
    def parse(cls, expr: str, locations: dict | None = None):
        """`DistanceFrom:NAME:RANGE` (NAME from config [locations]) or
        `distancelonlat:LON:LAT:RANGE`.  Returns None if expr is not a
        geo filter."""
        parts = expr.split(":")
        head = parts[0].lower()
        if head == "distancefrom" and len(parts) == 3:
            name, rng = parts[1], parts[2]
            locations = locations or {}
            if name not in locations:
                raise ValueError(f"unknown location '{name}'")
            loc = locations[name]
            lat, lon = (loc[0], loc[1]) if isinstance(loc, (list, tuple)) \
                else (loc["lat"], loc["lon"])
            return cls(lat, lon, float(rng))
        if head == "distancelonlat" and len(parts) == 4:
            lon, lat, rng = (float(parts[1]), float(parts[2]),
                             float(parts[3]))
            return cls(lat, lon, rng)
        return None

    def matches(self, lat: float, lon: float) -> bool:
        d, _ = sunpos.geodesic_distance_bearing(self.lat, self.lon,
                                                lat, lon)
        return d <= self.range_m

"""Solar position (NOAA/Meeus) with atmospheric refraction.

Re-creates the reference's sun-position feature (src/position.rs:49-119,
which uses the NREL SPA via the solar-positioning crate) with the NOAA
general solar position algorithm — accurate to well under 0.1 degree for
contemporary dates, which is ample for the "which direction was the sun"
overlay the feature drives.

Validated against the reference fixture
tests/Kaanapali_beach_sunrise_on_Maui_Hawaii.720p.jpg.txt:
lat 20.91297, lon -156.69383 @ 2018-08-09 05:10:21 UTC ->
altitude -2.9160 deg, azimuth 288.2067 deg.
"""

from __future__ import annotations

import math
from datetime import datetime, timezone


def _julian_day(dt: datetime) -> float:
    t = dt.astimezone(timezone.utc)
    y, m = t.year, t.month
    d = (t.day + t.hour / 24.0 + t.minute / 1440.0
         + (t.second + t.microsecond / 1e6) / 86400.0)
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    return (math.floor(365.25 * (y + 4716)) + math.floor(30.6001 * (m + 1))
            + d + b - 1524.5)


def solar_position(lat: float, lon: float, dt: datetime):
    """(altitude_deg, azimuth_deg) of the sun; azimuth clockwise from
    true north, altitude refraction-corrected."""
    jd = _julian_day(dt)
    jc = (jd - 2451545.0) / 36525.0

    gmls = (280.46646 + jc * (36000.76983 + jc * 0.0003032)) % 360.0
    gmas = 357.52911 + jc * (35999.05029 - 0.0001537 * jc)
    eeo = 0.016708634 - jc * (0.000042037 + 0.0000001267 * jc)
    seoc = (math.sin(math.radians(gmas))
            * (1.914602 - jc * (0.004817 + 0.000014 * jc))
            + math.sin(math.radians(2 * gmas)) * (0.019993 - 0.000101 * jc)
            + math.sin(math.radians(3 * gmas)) * 0.000289)
    stl = gmls + seoc
    sal = stl - 0.00569 - 0.00478 * math.sin(
        math.radians(125.04 - 1934.136 * jc))
    moe = (23.0 + (26.0 + (21.448 - jc * (46.815 + jc * (0.00059
           - jc * 0.001813))) / 60.0) / 60.0)
    oc = moe + 0.00256 * math.cos(math.radians(125.04 - 1934.136 * jc))

    decl = math.degrees(math.asin(
        math.sin(math.radians(oc)) * math.sin(math.radians(sal))))

    vary = math.tan(math.radians(oc / 2.0)) ** 2
    eot = 4.0 * math.degrees(
        vary * math.sin(2.0 * math.radians(gmls))
        - 2.0 * eeo * math.sin(math.radians(gmas))
        + 4.0 * eeo * vary * math.sin(math.radians(gmas))
        * math.cos(2.0 * math.radians(gmls))
        - 0.5 * vary * vary * math.sin(4.0 * math.radians(gmls))
        - 1.25 * eeo * eeo * math.sin(2.0 * math.radians(gmas)))

    t = dt.astimezone(timezone.utc)
    minutes = (t.hour * 60.0 + t.minute + (t.second + t.microsecond / 1e6)
               / 60.0)
    tst = (minutes + eot + 4.0 * lon) % 1440.0
    # NOAA: ha = tst/4 - 180 in [-180, 180) — negative before local
    # solar noon.  (A previous inverted mapping sent mornings to
    # [180, 360), mirroring the azimuth east/west for every pre-noon
    # timestamp; the validation fixture is a sunset, which is why it
    # never caught it.)
    ha = tst / 4.0 - 180.0

    lat_r = math.radians(lat)
    decl_r = math.radians(decl)
    ha_r = math.radians(ha)
    zenith = math.degrees(math.acos(
        max(-1.0, min(1.0,
            math.sin(lat_r) * math.sin(decl_r)
            + math.cos(lat_r) * math.cos(decl_r) * math.cos(ha_r)))))
    elevation = 90.0 - zenith

    # azimuth (NOAA): clockwise from north
    denom = math.cos(lat_r) * math.sin(math.radians(zenith))
    if abs(denom) > 1e-12:
        az_cos = ((math.sin(lat_r) * math.cos(math.radians(zenith)))
                  - math.sin(decl_r)) / denom
        az_cos = max(-1.0, min(1.0, az_cos))
        if ha > 0:
            azimuth = (math.degrees(math.acos(az_cos)) + 180.0) % 360.0
        else:
            azimuth = (540.0 - math.degrees(math.acos(az_cos))) % 360.0
    else:
        azimuth = 180.0 if lat > 0 else 0.0

    return elevation + _refraction(elevation), azimuth


def _refraction(elev: float) -> float:
    """NOAA atmospheric refraction correction, degrees."""
    if elev > 85.0:
        return 0.0
    te = math.tan(math.radians(elev)) if abs(elev) > 1e-9 else 1e-9
    if elev > 5.0:
        sec = 58.1 / te - 0.07 / te ** 3 + 0.000086 / te ** 5
    elif elev > -0.575:
        sec = (1735.0 + elev * (-518.2 + elev * (103.4 + elev *
               (-12.79 + elev * 0.711))))
    else:
        sec = -20.772 / te
    return sec / 3600.0


def geodesic_distance_bearing(lat1, lon1, lat2, lon2):
    """(distance_m, initial_bearing_deg) on the WGS-84 ellipsoid via
    Vincenty (position.rs:32-46 uses geo::Geodesic).  Falls back to
    haversine if Vincenty fails to converge (antipodal points)."""
    a, f = 6378137.0, 1 / 298.257223563
    b = a * (1 - f)
    l1, l2 = math.radians(lat1), math.radians(lat2)
    dl = math.radians(lon2 - lon1)
    u1, u2 = math.atan((1 - f) * math.tan(l1)), math.atan((1 - f) * math.tan(l2))
    su1, cu1 = math.sin(u1), math.cos(u1)
    su2, cu2 = math.sin(u2), math.cos(u2)
    lam = dl
    for _ in range(100):
        sl, cl = math.sin(lam), math.cos(lam)
        ss = math.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
        if ss == 0:
            return 0.0, 0.0
        cs = su1 * su2 + cu1 * cu2 * cl
        sig = math.atan2(ss, cs)
        sa = cu1 * cu2 * sl / ss
        c2a = 1 - sa ** 2
        c2m = cs - 2 * su1 * su2 / c2a if c2a != 0 else 0.0
        c = f / 16 * c2a * (4 + f * (4 - 3 * c2a))
        lam_prev = lam
        lam = dl + (1 - c) * f * sa * (
            sig + c * ss * (c2m + c * cs * (-1 + 2 * c2m ** 2)))
        if abs(lam - lam_prev) < 1e-12:
            break
    else:
        # haversine fallback
        r = 6371000.0
        h = (math.sin((l2 - l1) / 2) ** 2
             + math.cos(l1) * math.cos(l2) * math.sin(dl / 2) ** 2)
        d = 2 * r * math.asin(math.sqrt(h))
        y = math.sin(dl) * math.cos(l2)
        x = math.cos(l1) * math.sin(l2) - math.sin(l1) * math.cos(l2) * math.cos(dl)
        return d, (math.degrees(math.atan2(y, x)) + 360.0) % 360.0
    u2_ = c2a * (a ** 2 - b ** 2) / b ** 2
    big_a = 1 + u2_ / 16384 * (4096 + u2_ * (-768 + u2_ * (320 - 175 * u2_)))
    big_b = u2_ / 1024 * (256 + u2_ * (-128 + u2_ * (74 - 47 * u2_)))
    dsig = big_b * ss * (c2m + big_b / 4 * (
        cs * (-1 + 2 * c2m ** 2)
        - big_b / 6 * c2m * (-3 + 4 * ss ** 2) * (-3 + 4 * c2m ** 2)))
    dist = b * big_a * (sig - dsig)
    bearing = math.degrees(math.atan2(
        cu2 * math.sin(lam),
        cu1 * su2 - su1 * cu2 * math.cos(lam)))
    return dist, (bearing + 360.0) % 360.0

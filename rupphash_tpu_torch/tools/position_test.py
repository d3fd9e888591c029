"""Sun-position / EXIF-GPS debugging tool: the equivalent of the
reference's `position_test` binary (src/position_test.rs).

Usage: python -m rupphash_tpu_torch.tools.position_test [--gpstime] IMG
"""

from __future__ import annotations

import datetime
import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    gpstime = "--gpstime" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print("Usage: python -m rupphash_tpu_torch.tools.position_test "
              "[--gpstime] <image>", file=sys.stderr)
        return 1
    filename = paths[0]

    from ..pipeline import exif
    from ..utils import sunpos

    # fixed sanity check, mirrors position_test.rs:26-33
    dist, bearing = sunpos.geodesic_distance_bearing(
        60.1699, 24.9384, 61.4978, 23.7610)
    print(f"Helsinki to Tampere Distance: {dist / 1000.0:.3f} km, "
          f"Compass Bearing: {bearing:.3f}°")

    feats = exif.extract(filename)
    if not feats.get("gps"):
        print("Error: no GPS coordinates in EXIF", file=sys.stderr)
        return 1
    lat, lon = feats["gps"]
    alt = feats.get("altitude") or 0.0
    ts = (feats.get("gps_timestamp") if gpstime else None) \
        or feats.get("exif_timestamp")
    if ts is None:
        print("Error: no usable timestamp in EXIF", file=sys.stderr)
        return 1
    dt = datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)

    print("--- Input Data ---")
    print(f"File:       {filename}")
    print(f"Lat/Lon:    {lat:.5f}, {lon:.5f}")
    print(f"Altitude:   {alt:.1f} m")
    suffix = " (GPS UTC)" if gpstime and feats.get("gps_timestamp") else ""
    print(f"Date Clean: '{dt.strftime('%Y-%m-%d %H:%M:%S')}'{suffix}")

    sun_alt, sun_az = sunpos.solar_position(lat, lon, dt)
    print("\n--- Result ---")
    print(f"Sun Altitude:  {sun_alt:.4f} deg")
    print(f"Sun Azimuth:   {sun_az:.4f} deg")
    print("Timezone:      UTC (+00:00)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

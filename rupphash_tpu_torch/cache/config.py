"""TOML configuration with self-healing master key management.

Mirrors the reference's phdupes.conf handling (src/db.rs:104-211,351-518):
a TOML file in the user config dir holding the 32-byte master key (hex),
cache sizing, grouping preferences, and UI sections.  Writes are atomic
(tmp + rename, db.rs:355-378); a missing or corrupt key is regenerated
and missing sections are backfilled without destroying user edits.

Override the location with RUPPHASH_CONFIG_DIR (used by tests).
"""

from __future__ import annotations

import os
import secrets
import tomllib
from pathlib import Path

APP_NAME = "rupphash"
DEFAULTS = {
    "db_size_mb": 2048,              # db.rs:546 default map size
    "grouping": {
        "ignore_same_stem": False,
        "extensions": ["jpg", "jpeg", "png", "webp", "avif", "heic",
                       "tiff", "tif", "bmp", "gif"],
    },
    "gui": {
        "preload_count": 8,
        "decimal_coords": True,
        "dominant_colors": 6,
        "saturation_bias": 1.0,
        "palette_sort": "hue",
        "sdr_peak_nits": 203.0,
        "exif_tags": ["Make", "Model", "DateTimeOriginal", "FNumber",
                      "ExposureTime", "ISOSpeedRatings", "FocalLength"],
    },
    "locations": {},
    # slippy-tile URL templates (gps_map.rs:14-42); the web GUI fetches
    # tiles client-side and falls back to the offline canvas when they
    # fail to load
    "selected_provider": "openstreetmap",
    "map_providers": {
        "openstreetmap": "https://tile.openstreetmap.org/{z}/{x}/{y}.png",
        "opentopomap": "https://tile.opentopomap.org/{z}/{x}/{y}.png",
    },
}


def config_dir() -> Path:
    env = os.environ.get("RUPPHASH_CONFIG_DIR")
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(xdg) / APP_NAME


def cache_dir() -> Path:
    env = os.environ.get("RUPPHASH_CACHE_DIR")
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache"))
    return Path(xdg) / f"{APP_NAME}_pdqhash"


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"unsupported TOML value {type(v)}")


_BARE_KEY = None  # compiled lazily (module imports stay cheap)


def _toml_key(k: str) -> str:
    """Quote keys that aren't bare (user entries like
    '[locations] \"New York\"' must round-trip: emitting them unquoted
    writes invalid TOML, and the next load's parse failure would wipe
    every user setting)."""
    global _BARE_KEY
    if _BARE_KEY is None:
        import re
        _BARE_KEY = re.compile(r"^[A-Za-z0-9_-]+$")
    if _BARE_KEY.match(k):
        return k
    esc = k.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{esc}"'


def _dump_toml(cfg: dict) -> str:
    lines = []
    tables = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{_toml_key(k)} = {_toml_value(v)}")
    def emit_entries(prefix: str, tbl: dict):
        # arbitrary nesting depth via dotted keys so nothing is silently
        # dropped on a save/load round-trip
        for k, v in tbl.items():
            key = f"{prefix}{_toml_key(k)}"
            if isinstance(v, dict):
                emit_entries(key + ".", v)
            else:
                lines.append(f"{key} = {_toml_value(v)}")

    for name, tbl in tables:
        lines.append("")
        lines.append(f"[{_toml_key(name)}]")
        emit_entries("", tbl)
    return "\n".join(lines) + "\n"


def _atomic_write(path: Path, text: str):
    # 0600: the file holds the cache master key (db.rs stores it in the
    # user config too, but must never be world-readable)
    tmp = path.with_suffix(".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)  # atomic on POSIX (db.rs:355-378)


def _salvage_master_key(text: str) -> str | None:
    """Best-effort key recovery from an unparseable config: losing the
    key silently invalidates the whole encrypted cache (db.rs:500-513
    regenerates only the invalid key, preserving the rest)."""
    import re
    m = re.search(r'master_key\s*=\s*"([0-9a-fA-F]{64})"', text)
    return m.group(1) if m else None


def load_config() -> dict:
    """Load (or create) the config, healing missing/corrupt entries."""
    cdir = config_dir()
    cdir.mkdir(parents=True, exist_ok=True)
    path = cdir / f"{APP_NAME}.conf"
    cfg: dict = {}
    if path.exists():
        try:
            os.chmod(path, 0o600)  # heal pre-existing loose permissions
        except OSError:
            pass
        try:
            text = path.read_text()
        except OSError:
            text = ""
        try:
            cfg = tomllib.loads(text)
        except tomllib.TOMLDecodeError:
            # keep the evidence and salvage what we can instead of
            # silently wiping every user setting
            try:
                path.with_suffix(".conf.bak").write_text(text)
            except OSError:
                pass
            cfg = {}
            salvaged = _salvage_master_key(text)
            if salvaged:
                cfg["master_key"] = salvaged

    changed = False
    key_hex = cfg.get("master_key", "")
    try:
        key = bytes.fromhex(key_hex)
        if len(key) != 32:
            raise ValueError
    except (ValueError, TypeError):
        key = secrets.token_bytes(32)  # regenerate (db.rs:500-518)
        cfg["master_key"] = key.hex()
        changed = True

    for k, v in DEFAULTS.items():
        if k not in cfg:
            cfg[k] = v
            changed = True
        elif isinstance(v, dict):
            for kk, vv in v.items():
                if kk not in cfg[k]:
                    cfg[k][kk] = vv
                    changed = True

    if changed:
        _atomic_write(path, _dump_toml(cfg))
    cfg["_master_key_bytes"] = key
    cfg["_path"] = str(path)
    return cfg


def save_config(cfg: dict):
    clean = {k: v for k, v in cfg.items() if not k.startswith("_")}
    _atomic_write(Path(cfg["_path"]), _dump_toml(clean))

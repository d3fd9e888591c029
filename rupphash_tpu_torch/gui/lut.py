"""3D LUT (.cube) parsing and tetrahedral application.

The reference parses .cube files and applies them with a tetrahedral-
interpolation WGSL shader (gui/image.rs:124-240 parser, :382-426
shader).  Here the parser is the same format grammar and the
interpolation is vectorized numpy over the whole image — the server
applies it once per (image, LUT) render, cached.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Lut3D:
    title: str
    size: int
    table: np.ndarray            # (N, N, N, 3) float32, indexed [b][g][r]
    domain_min: np.ndarray       # (3,)
    domain_max: np.ndarray       # (3,)
    path: str = ""


def parse_cube(text: str, path: str = "") -> Lut3D | None:
    """Parse a .cube 3D LUT (Adobe/Resolve grammar, gui/image.rs:124-240).
    Returns None on malformed input."""
    title = ""
    size = 0
    dmin = np.zeros(3, np.float32)
    dmax = np.ones(3, np.float32)
    rows: list[tuple[float, float, float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        up = line.upper()
        if up.startswith("TITLE"):
            title = line[5:].strip().strip('"')
        elif up.startswith("LUT_3D_SIZE"):
            try:
                size = int(line.split()[1])
            except (IndexError, ValueError):
                return None
        elif up.startswith("LUT_1D_SIZE"):
            return None  # 1D LUTs unsupported, as in the reference
        elif up.startswith("DOMAIN_MIN"):
            try:
                dmin = np.array([float(v) for v in line.split()[1:4]],
                                np.float32)
            except ValueError:
                return None
        elif up.startswith("DOMAIN_MAX"):
            try:
                dmax = np.array([float(v) for v in line.split()[1:4]],
                                np.float32)
            except ValueError:
                return None
        else:
            parts = line.split()
            if len(parts) >= 3:
                try:
                    rows.append((float(parts[0]), float(parts[1]),
                                 float(parts[2])))
                except ValueError:
                    return None
    if size < 2 or len(rows) != size ** 3:
        return None
    if dmin.shape != (3,) or dmax.shape != (3,):
        return None  # DOMAIN_* with a wrong token count
    # .cube data order: R fastest, then G, then B
    table = np.asarray(rows, np.float32).reshape(size, size, size, 3)
    if np.any(dmax - dmin <= 0):
        return None
    return Lut3D(title=title, size=size, table=table,
                 domain_min=dmin, domain_max=dmax, path=path)


def load_cube(path: str | Path) -> Lut3D | None:
    try:
        return parse_cube(Path(path).read_text(encoding="utf-8",
                                               errors="replace"),
                          str(path))
    except OSError:
        return None
    except Exception:
        # malformed grammar beyond what parse_cube's own checks catch
        # (e.g. a 2-token DOMAIN_MIN broadcasting error) must surface
        # as "could not parse", not crash the GUI at startup
        return None


def apply_lut_u8(rgb: np.ndarray, lut: Lut3D) -> np.ndarray:
    """Tetrahedral interpolation of an (H, W, 3) uint8 image through the
    LUT (the shader's algorithm, gui/image.rs:382-426, vectorized)."""
    out = apply_lut_f32(rgb.astype(np.float32) / 255.0, lut)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def apply_lut_f32(x01: np.ndarray, lut: Lut3D) -> np.ndarray:
    """Float core shared by the 8-bit and deep (16-bit) render paths:
    (H, W, 3) in [0,1] -> LUT output in [0,1] (unclamped)."""
    n = lut.size
    x = (x01 - lut.domain_min) / (lut.domain_max - lut.domain_min)
    x = np.clip(x, 0.0, 1.0) * (n - 1)
    i0 = np.minimum(x.astype(np.int32), n - 2)
    f = x - i0
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = f[..., 0], f[..., 1], f[..., 2]

    t = lut.table  # [b, g, r]

    def at(dr, dg, db):
        return t[b0 + db, g0 + dg, r0 + dr]

    c000 = at(0, 0, 0)
    c111 = at(1, 1, 1)
    out = np.empty_like(c000)

    # six tetrahedra by ordering of (fr, fg, fb)
    masks = [
        ((fr >= fg) & (fg >= fb), (1, 0, 0), (1, 1, 0), "rgb"),
        ((fr >= fb) & (fb > fg), (1, 0, 0), (1, 0, 1), "rbg"),
        ((fb > fr) & (fr >= fg), (0, 0, 1), (1, 0, 1), "brg"),
        ((fg > fr) & (fr >= fb), (0, 1, 0), (1, 1, 0), "grb"),
        ((fg >= fb) & (fb > fr), (0, 1, 0), (0, 1, 1), "gbr"),
        ((fb > fg) & (fg > fr), (0, 0, 1), (0, 1, 1), "bgr"),
    ]
    comp = {"r": fr, "g": fg, "b": fb}
    for mask, e1, e2, order in masks:
        if not np.any(mask):
            continue
        h1, h2, h3 = comp[order[0]], comp[order[1]], comp[order[2]]
        v = (c000 * (1 - h1)[..., None]
             + at(*e1) * (h1 - h2)[..., None]
             + at(*e2) * (h2 - h3)[..., None]
             + c111 * h3[..., None])
        out = np.where(mask[..., None], v, out)
    return out

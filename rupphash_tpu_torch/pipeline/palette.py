"""Dominant-color palette + histogram analysis in Oklab.

Library form of the reference GUI's color analysis
(src/gui/image.rs:2561-3255): sRGB -> Oklab conversion, a bounded
analysis downsample, 256-bin L/a/b histograms, and a weighted k-means
palette with the reference's behaviors — low-color shortcut, dark-floor
culling, chroma boost (`saturation_bias`), zone seeding, and hue or
luminance ordering (PaletteConfig, db.rs:75-90).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ANALYSIS_SIZE = 128  # gui/image.rs 128x128 analysis downsample


@dataclasses.dataclass
class PaletteConfig:
    """Mirrors the [gui] palette options (db.rs:75-90)."""
    dominant_colors: int = 6
    saturation_bias: float = 1.0
    palette_sort: str = "hue"  # "hue" | "luminance"
    # cull near-black clusters; Oklab L is cube-root-scaled, so even
    # rgb(3,3,3) sits near L~0.10
    dark_floor: float = 0.12


# --------------------------------------------------------------------------
# Oklab (Björn Ottosson's published transform)
# --------------------------------------------------------------------------

_LMS = np.array([
    [0.4122214708, 0.5363325363, 0.0514459929],
    [0.2119034982, 0.6806995451, 0.1073969566],
    [0.0883024619, 0.2817188376, 0.6299787005],
])

_LAB = np.array([
    [0.2104542553, 0.7936177850, -0.0040720468],
    [1.9779984951, -2.4285922050, 0.4505937099],
    [0.0259040371, 0.7827717662, -0.8086757660],
])


def srgb_to_linear(rgb_u8: np.ndarray) -> np.ndarray:
    x = rgb_u8.astype(np.float64) / 255.0
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def linear_to_srgb_u8(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    e = np.where(lin <= 0.0031308, 12.92 * lin,
                 1.055 * np.power(lin, 1.0 / 2.4) - 0.055)
    return np.clip(np.rint(e * 255.0), 0, 255).astype(np.uint8)


def rgb_to_oklab(rgb_u8: np.ndarray) -> np.ndarray:
    lin = srgb_to_linear(rgb_u8)
    lms = lin @ _LMS.T
    lms_ = np.cbrt(lms)
    return lms_ @ _LAB.T


def oklab_to_rgb_u8(lab: np.ndarray) -> np.ndarray:
    lms_ = lab @ np.linalg.inv(_LAB).T
    lin = (lms_ ** 3) @ np.linalg.inv(_LMS).T
    return linear_to_srgb_u8(lin)


# --------------------------------------------------------------------------
# Histograms
# --------------------------------------------------------------------------

def analysis_downsample(rgb: np.ndarray, size: int = ANALYSIS_SIZE
                        ) -> np.ndarray:
    """Cheap strided downsample to <= size x size for analysis."""
    h, w = rgb.shape[:2]
    sh = max(1, h // size)
    sw = max(1, w // size)
    return rgb[::sh, ::sw]


def oklab_histograms(rgb: np.ndarray, bins: int = 256):
    """(L_hist, a_hist, b_hist) 256-bin histograms
    (gui/image.rs:2616-2642).  L in [0,1]; a, b in [-0.4, 0.4]."""
    small = analysis_downsample(rgb)
    lab = rgb_to_oklab(small.reshape(-1, 3))
    hl = np.histogram(lab[:, 0], bins=bins, range=(0.0, 1.0))[0]
    ha = np.histogram(lab[:, 1], bins=bins, range=(-0.4, 0.4))[0]
    hb = np.histogram(lab[:, 2], bins=bins, range=(-0.4, 0.4))[0]
    return hl, ha, hb


def luma_histogram(rgb: np.ndarray, bins: int = 256) -> np.ndarray:
    small = analysis_downsample(rgb)
    luma = (0.2126 * small[..., 0].astype(np.float64)
            + 0.7152 * small[..., 1] + 0.0722 * small[..., 2])
    return np.histogram(luma, bins=bins, range=(0, 255))[0]


# --------------------------------------------------------------------------
# Weighted k-means palette
# --------------------------------------------------------------------------

def kmeans_palette(rgb: np.ndarray, config: PaletteConfig | None = None,
                   iters: int = 12, seed: int = 0):
    """Dominant colors as (k, 3) uint8 sRGB, most-weighted ordering per
    config.palette_sort.  Mirrors kmeans_palette (gui/image.rs:2788-3255):
    weighted k-means in Oklab with chroma boost, seeding spread across
    luminance zones, near-black culling, low-color shortcut.
    """
    config = config or PaletteConfig()
    k = max(1, config.dominant_colors)
    small = analysis_downsample(rgb).reshape(-1, 3)

    # low-color shortcut: few distinct colors -> return them directly
    uniq, counts = np.unique(small, axis=0, return_counts=True)
    if len(uniq) <= k:
        order = np.argsort(-counts)
        return uniq[order]

    lab = rgb_to_oklab(small)
    chroma = np.hypot(lab[:, 1], lab[:, 2])
    weights = 1.0 + (config.saturation_bias - 1.0) * np.clip(
        chroma / 0.15, 0, 1)

    # zone seeding: spread initial centers across 4 luminance zones
    rng = np.random.default_rng(seed)
    zones = np.clip((lab[:, 0] * 4).astype(int), 0, 3)
    seeds = []
    for z in range(4):
        members = np.nonzero(zones == z)[0]
        take = max(1, k // 4) if len(members) else 0
        if take:
            seeds.extend(rng.choice(members, size=min(take, len(members)),
                                    replace=False))
    while len(seeds) < k:
        seeds.append(int(rng.integers(0, len(lab))))
    centers = lab[np.asarray(seeds[:k])]

    for _ in range(iters):
        d = ((lab[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(axis=1)
        for c in range(k):
            m = assign == c
            if m.any():
                w = weights[m][:, None]
                ws = w.sum()
                if ws > 1e-12:  # all-zero-weight cluster (e.g.
                    centers[c] = (lab[m] * w).sum(0) / ws
                else:           # saturation_bias=0): plain mean
                    centers[c] = lab[m].mean(0)

    cluster_w = np.array([weights[assign == c].sum() for c in range(k)])

    # dark-floor culling: drop near-black clusters unless everything is dark
    bright = centers[:, 0] >= config.dark_floor
    if bright.any():
        centers, cluster_w = centers[bright], cluster_w[bright]

    order = np.argsort(-cluster_w)
    centers, cluster_w = centers[order], cluster_w[order]

    if config.palette_sort == "hue":
        hue = np.arctan2(centers[:, 2], centers[:, 1])
        chroma_c = np.hypot(centers[:, 1], centers[:, 2])
        grayish = chroma_c < 0.02
        order = np.lexsort((centers[:, 0], np.where(grayish, 10.0, hue)))
        centers = centers[order]
    elif config.palette_sort == "luminance":
        centers = centers[np.argsort(centers[:, 0])]

    return oklab_to_rgb_u8(centers)

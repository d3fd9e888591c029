"""HDR -> SDR color management (the src/hdr.rs subsystem, rebuilt).

Vectorized numpy implementations of:

  cICP (H.273) detection        PNG `cICP` chunk (hdr.rs:191-229),
                                ISOBMFF `colr`/`nclx` byte scan
                                (hdr.rs:73-152), ICC v4 `cicp` tag
                                (hdr.rs:267-307)
  transfer functions            PQ (SMPTE 2084) EOTF/inverse
                                (hdr.rs:314-331,505-511), HLG OETF^-1 +
                                OOTF (hdr.rs:337-350), sRGB, BT.1886
                                (gamma 2.4 for transfer 1/6/14/15,
                                hdr.rs:362-406)
  gamut conversion              BT.2020 -> BT.709, Display-P3 -> BT.709
                                (hdr.rs:430-463)
  tone mapping                  BT.2390 EETF on MaxRGB in PQ space
                                (hdr.rs:477-501,627-710)
  output                        dithered 8-bit (triangular-PDF dither,
                                hdr.rs:712-777) and u16

The scan/hash path never needs this (the reference hashes un-managed
pixels too); it serves viewers and export tooling.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# H.273 code points
TRANSFER_BT709 = 1
TRANSFER_UNSPECIFIED = 2
TRANSFER_GAMMA22 = 4
TRANSFER_GAMMA28 = 5
TRANSFER_BT601 = 6
TRANSFER_LINEAR = 8
TRANSFER_SRGB = 13
TRANSFER_BT2020_10 = 14
TRANSFER_BT2020_12 = 15
TRANSFER_PQ = 16
TRANSFER_HLG = 18

PRIMARIES_BT709 = 1
PRIMARIES_BT2020 = 9
PRIMARIES_P3 = 12

# BT.1886 display gamma is used for the "SDR but not sRGB" transfers
# (hdr.rs:362-406): 1, 6, 14, 15
_BT1886_TRANSFERS = {TRANSFER_BT709, TRANSFER_BT601, TRANSFER_BT2020_10,
                     TRANSFER_BT2020_12}


class Cicp:
    __slots__ = ("primaries", "transfer", "matrix", "full_range")

    def __init__(self, primaries, transfer, matrix=0, full_range=True):
        self.primaries = primaries
        self.transfer = transfer
        self.matrix = matrix
        self.full_range = full_range

    def __repr__(self):
        return (f"Cicp(p={self.primaries}, t={self.transfer}, "
                f"m={self.matrix}, full={self.full_range})")

    @property
    def is_hdr(self) -> bool:
        return self.transfer in (TRANSFER_PQ, TRANSFER_HLG)

    @property
    def needs_conversion(self) -> bool:
        """True when the buffer is not plain sRGB/BT.709-primaries SDR."""
        return (self.is_hdr or self.primaries not in (PRIMARIES_BT709, 0, 2)
                or self.transfer in _BT1886_TRANSFERS
                or self.transfer in (TRANSFER_GAMMA22, TRANSFER_GAMMA28))


# --------------------------------------------------------------------------
# Detection
# --------------------------------------------------------------------------

def detect_cicp_png(data: bytes) -> Cicp | None:
    """Walk PNG chunks for `cICP` (hdr.rs:191-229)."""
    if len(data) < 8 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        if ctype == b"cICP" and length >= 4:
            p, t, m, fr = data[pos + 8:pos + 12]
            return Cicp(p, t, m, fr == 1)
        if ctype == b"IDAT":
            return None  # cICP must precede image data
        pos += 12 + length
    return None


def detect_cicp_isobmff(data: bytes) -> Cicp | None:
    """Fast byte-scan for `colr` nclx in HEIF/AVIF containers
    (hdr.rs:73-152)."""
    idx = data.find(b"colrnclx")
    if idx >= 0 and idx + 15 <= len(data):
        p, t, m = struct.unpack(">HHH", data[idx + 8:idx + 14])
        fr = bool(data[idx + 14] & 0x80)
        if p < 256 and t < 256:
            return Cicp(p, t, m, fr)
    return None


def detect_cicp_icc(icc: bytes) -> Cicp | None:
    """ICC v4.4 `cicp` tag (hdr.rs:267-307)."""
    if len(icc) < 132:
        return None
    (tag_count,) = struct.unpack(">I", icc[128:132])
    for i in range(min(tag_count, 256)):
        off = 132 + 12 * i
        if off + 12 > len(icc):
            break
        sig, data_off, size = struct.unpack(">4sII", icc[off:off + 12])
        if sig == b"cicp" and data_off + 12 <= len(icc) and size >= 12:
            if icc[data_off:data_off + 4] != b"cicp":
                continue
            p, t, m, fr = icc[data_off + 8:data_off + 12]
            return Cicp(p, t, m, fr == 1)
    return None


def detect_cicp(data: bytes) -> Cicp | None:
    """Dispatcher (hdr.rs:155-182)."""
    cicp = detect_cicp_png(data)
    if cicp is None and (data[4:8] == b"ftyp" or b"ftyp" in data[:64]):
        cicp = detect_cicp_isobmff(data)
    return cicp


# --------------------------------------------------------------------------
# Transfer functions (all vectorized over float arrays in [0, 1])
# --------------------------------------------------------------------------

_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def pq_eotf(e: np.ndarray) -> np.ndarray:
    """PQ signal -> linear luminance in units of 10000 nits (SMPTE 2084)."""
    e = np.clip(e, 0.0, 1.0)
    p = np.power(e, 1.0 / _PQ_M2)
    num = np.maximum(p - _PQ_C1, 0.0)
    den = _PQ_C2 - _PQ_C3 * p
    return np.power(num / den, 1.0 / _PQ_M1)


def pq_inverse_eotf(y: np.ndarray) -> np.ndarray:
    """Linear luminance (1.0 == 10000 nits) -> PQ signal."""
    y = np.clip(y, 0.0, 1.0)
    p = np.power(y, _PQ_M1)
    return np.power((_PQ_C1 + _PQ_C2 * p) / (1.0 + _PQ_C3 * p), _PQ_M2)


_HLG_A = 0.17883277
_HLG_B = 1.0 - 4.0 * _HLG_A
_HLG_C = 0.5 - _HLG_A * np.log(4.0 * _HLG_A)


def hlg_oetf_inverse(e: np.ndarray) -> np.ndarray:
    """HLG signal -> linear scene light in [0, 1] (BT.2100)."""
    e = np.clip(e, 0.0, 1.0)
    lo = (e * e) / 3.0
    hi = (np.exp((e - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
    return np.where(e <= 0.5, lo, hi)


def hlg_ootf(scene: np.ndarray, luma: np.ndarray,
             gamma: float = 1.2) -> np.ndarray:
    """HLG OOTF: display light = scene * Y^(gamma-1) (BT.2100)."""
    return scene * np.power(np.maximum(luma, 1e-6), gamma - 1.0)[..., None]


def srgb_oetf(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(lin <= 0.0031308, 12.92 * lin,
                    1.055 * np.power(lin, 1.0 / 2.4) - 0.055)


def srgb_eotf(e: np.ndarray) -> np.ndarray:
    e = np.clip(e, 0.0, 1.0)
    return np.where(e <= 0.04045, e / 12.92,
                    np.power((e + 0.055) / 1.055, 2.4))


def bt1886_eotf(e: np.ndarray) -> np.ndarray:
    """Display gamma 2.4 for SDR broadcast transfers (hdr.rs:362-406)."""
    return np.power(np.clip(e, 0.0, 1.0), 2.4)


def decode_transfer(e: np.ndarray, transfer: int) -> np.ndarray:
    if transfer == TRANSFER_PQ:
        return pq_eotf(e)  # absolute, in 10000-nit units
    if transfer == TRANSFER_HLG:
        return hlg_oetf_inverse(e)
    if transfer == TRANSFER_SRGB:
        return srgb_eotf(e)
    if transfer in _BT1886_TRANSFERS:
        return bt1886_eotf(e)
    if transfer == TRANSFER_GAMMA22:
        return np.power(np.clip(e, 0, 1), 2.2)
    if transfer == TRANSFER_GAMMA28:
        return np.power(np.clip(e, 0, 1), 2.8)
    if transfer == TRANSFER_LINEAR:
        return np.clip(e, 0, 1)
    return srgb_eotf(e)


# --------------------------------------------------------------------------
# Gamut conversion (linear light)
# --------------------------------------------------------------------------

BT2020_TO_BT709 = np.array([
    [1.6605, -0.5876, -0.0728],
    [-0.1246, 1.1329, -0.0083],
    [-0.0182, -0.1006, 1.1187],
])

P3_TO_BT709 = np.array([
    [1.2249, -0.2247, 0.0000],
    [-0.0420, 1.0419, 0.0000],
    [-0.0197, -0.0786, 1.0979],
])


def convert_gamut(lin: np.ndarray, primaries: int) -> np.ndarray:
    if primaries == PRIMARIES_BT2020:
        return lin @ BT2020_TO_BT709.T
    if primaries == PRIMARIES_P3:
        return lin @ P3_TO_BT709.T
    return lin


# --------------------------------------------------------------------------
# BT.2390 EETF tone mapping
# --------------------------------------------------------------------------

def bt2390_eetf(e_pq: np.ndarray, max_lum_pq: float,
                min_lum_pq: float = 0.0) -> np.ndarray:
    """Map PQ-space values in [0,1] into the display range
    [min_lum_pq, max_lum_pq] with the BT.2390 hermite knee
    (hdr.rs:477-501)."""
    ml = float(max_lum_pq)
    ks = 1.5 * ml - 0.5
    e = np.clip(e_pq, 0.0, 1.0)
    t = (e - ks) / max(1.0 - ks, 1e-6)
    t2 = t * t
    t3 = t2 * t
    p = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (1 - ks)
         + (-2 * t3 + 3 * t2) * ml)
    e2 = np.where(e < ks, e, p)
    if min_lum_pq > 0:
        e2 = e2 + min_lum_pq * np.power(np.clip(1 - e2, 0, 1), 4.0)
    return e2


def tonemap_pq_maxrgb(lin: np.ndarray, peak_nits: float = 203.0
                      ) -> np.ndarray:
    """Tone map linear 10000-nit-relative RGB by scaling MaxRGB through
    the BT.2390 EETF in PQ space (hdr.rs:627-710), then normalize so the
    SDR peak maps to 1.0."""
    maxrgb = lin.max(axis=-1)
    sig_pq = pq_inverse_eotf(maxrgb)
    max_pq = float(pq_inverse_eotf(np.float64(peak_nits / 10000.0)))
    # the EETF maps the full source PQ range onto [0, max_pq]: ks =
    # 1.5*max_pq - 0.5 places the hermite knee below peak so highlights
    # roll off.  (Pre-normalizing and passing max_lum=1.0 makes ks=1.0,
    # the knee region vanishes, and the curve degenerates to identity
    # + hard clip — 1000-4000 nit highlights crush to flat white.)
    mapped_pq = bt2390_eetf(sig_pq, max_pq)
    mapped = pq_eotf(mapped_pq)
    scale = np.where(maxrgb > 1e-8, mapped / np.maximum(maxrgb, 1e-8), 1.0)
    out = lin * scale[..., None]
    return np.clip(out / (peak_nits / 10000.0), 0.0, 1.0)


# --------------------------------------------------------------------------
# Full conversion + dithered output
# --------------------------------------------------------------------------

def hdr_to_sdr(rgb: np.ndarray, cicp: Cicp,
               peak_nits: float = 203.0) -> np.ndarray:
    """Normalized float RGB (0..1 signal) + cICP -> linear BT.709 in
    [0, 1] ready for sRGB encode."""
    e = rgb.astype(np.float64)
    lin = decode_transfer(e, cicp.transfer)
    if cicp.transfer == TRANSFER_HLG:
        # scene -> display light at 1000 nits, then into PQ units
        luma = (0.2627 * lin[..., 0] + 0.6780 * lin[..., 1]
                + 0.0593 * lin[..., 2])
        lin = hlg_ootf(lin, luma) * (1000.0 / 10000.0)
        lin = tonemap_pq_maxrgb(lin, peak_nits)
    elif cicp.transfer == TRANSFER_PQ:
        lin = tonemap_pq_maxrgb(lin, peak_nits)
    lin = convert_gamut(lin, cicp.primaries)
    return np.clip(lin, 0.0, 1.0)


_BLUE_NOISE_SIDE = 64
_blue_noise_cache: dict = {}


def blue_noise_tile(side: int | None = None) -> np.ndarray:
    """Tileable blue-noise rank matrix in [0, 1) via Ulichney's
    void-and-cluster method.  The reference ships a pre-baked 256x256
    tile (assets/blue-noise-256.bin, hdr.rs:712-742); we ship our own
    256x256 rank tile generated by tools/gen_bluenoise.py (same
    algorithm at sigma 1.9).  side=None (the dither paths) prefers the
    shipped asset and falls back to generating a 64x64 tile in-process
    when it is absent; an explicit side always returns exactly that
    size (from the asset when it matches, else generated)."""
    want_asset = side is None or side == 256
    if side is None:
        side = _BLUE_NOISE_SIDE
    cached = _blue_noise_cache.get(("asset", None) if want_asset
                                   else side)
    if cached is not None:
        return cached
    if want_asset:
        asset = Path(__file__).resolve().parents[1] / "assets" / \
            "blue-noise-256.npy"
        if asset.is_file():
            try:
                rank = np.load(asset)
                n = rank.size
                if rank.ndim == 2 and rank.shape[0] == rank.shape[1] \
                        and len(np.unique(rank)) == n:
                    tile = (rank.astype(np.float64) + 0.5) / n
                    _blue_noise_cache[("asset", None)] = tile
                    return tile
            except Exception:
                pass  # corrupt asset: generate below
    n = side * side
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    # toroidal gaussian energy splat
    d = np.minimum(yy, side - yy) ** 2 + np.minimum(xx, side - xx) ** 2
    kernel = np.exp(-d / (2.0 * 1.5 ** 2))

    rng = np.random.default_rng(0x9E3779B9)
    binary = np.zeros((side, side), dtype=bool)
    energy = np.zeros((side, side), dtype=np.float64)

    def splat(y, x, sign):
        energy[:] += sign * np.roll(np.roll(kernel, y, 0), x, 1)

    # seed ~10% random points, then swap tightest-cluster -> largest-void
    # until stable (classic initialization)
    seeds = rng.choice(n, size=n // 10, replace=False)
    for s in seeds:
        binary[s // side, s % side] = True
        splat(s // side, s % side, +1)
    for _ in range(n):
        masked = np.where(binary, energy, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), energy.shape)
        binary[cy, cx] = False
        splat(cy, cx, -1)
        masked = np.where(binary, np.inf, energy)
        vy, vx = np.unravel_index(np.argmin(masked), energy.shape)
        if (vy, vx) == (cy, cx):  # stable: removing it re-creates it
            binary[cy, cx] = True
            splat(cy, cx, +1)
            break
        binary[vy, vx] = True
        splat(vy, vx, +1)

    rank = np.zeros((side, side), dtype=np.int64)
    # phase 1: peel the seed points off tightest-cluster-first
    work = binary.copy()
    e1 = energy.copy()
    k = int(work.sum())
    for r in range(k - 1, -1, -1):
        masked = np.where(work, e1, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), e1.shape)
        work[cy, cx] = False
        e1 -= np.roll(np.roll(kernel, cy, 0), cx, 1)
        rank[cy, cx] = r
    # phase 2: fill the remaining voids largest-void-first
    work = binary.copy()
    e2 = energy.copy()
    for r in range(k, n):
        masked = np.where(work, np.inf, e2)
        vy, vx = np.unravel_index(np.argmin(masked), e2.shape)
        work[vy, vx] = True
        e2 += np.roll(np.roll(kernel, vy, 0), vx, 1)
        rank[vy, vx] = r
    tile = (rank.astype(np.float64) + 0.5) / n
    _blue_noise_cache[("asset", None) if want_asset else side] = tile
    return tile


def encode_srgb_u8_dithered(lin: np.ndarray, seed: int = 0) -> np.ndarray:
    """Linear BT.709 -> sRGB u8 with a triangular-PDF remap of a tiled
    blue-noise threshold shared across RGB (hdr.rs:712-742: the
    reference remaps its blue-noise tile u in [0,1) to a triangular
    distribution in (-1, 1) and adds it before rounding)."""
    e = srgb_oetf(lin) * 255.0
    h, w = lin.shape[:2]
    bn = blue_noise_tile()
    side = bn.shape[0]
    ty = (np.arange(h) + seed * 17) % side
    tx = (np.arange(w) + seed * 29) % side
    u = bn[np.ix_(ty, tx)]
    # triangular-PDF remap (same formula family as hdr.rs:724-736)
    noise = np.where(u < 0.5, np.sqrt(2.0 * u) - 1.0,
                     1.0 - np.sqrt(2.0 * (1.0 - u)))
    e = e + noise[..., None]
    return np.clip(np.rint(e), 0, 255).astype(np.uint8)


def encode_u16(lin: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(srgb_oetf(lin) * 65535.0), 0,
                   65535).astype(np.uint16)

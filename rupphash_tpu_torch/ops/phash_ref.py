"""Golden classic pHash (64-bit) reference implementation.

Replicates the Rust reference's src/phash.rs:

  bilinear (Triangle) resize of the RGB image to exactly 32x32   phash.rs:48-53
  Rec.709 luma                                                    (image crate to_luma8)
  unnormalized 2-D DCT-II (rows then columns)                     phash.rs:95-118
  top-left 8x8 crop                                               phash.rs:121-128
  median excluding the DC term (sorted[31] of 63)                 phash.rs:67-71
  bit i = coeff[i] > median, big-endian (bit 63 = (0,0))          phash.rs:74-82

plus the packed-u64 dihedral bit operations (phash.rs:137-255):
rotate 90/180/270, horizontal flip, rotation-invariant min-hash, and the
store-1/query-8 dihedral set.

Like the reference (phash.rs:5-8), 1-2 bit differences versus Python
imagehash on rotated variants are expected resampling noise; the bit ops
transform DCT coefficients exactly.
"""

from __future__ import annotations

import numpy as np

DCT_SIZE = 32
HASH_SIZE = 8

F32 = np.float32


# --------------------------------------------------------------------------
# Triangle (bilinear) resize, standard convolution semantics
# --------------------------------------------------------------------------

def triangle_kernel_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 row-normalized triangle-filter resampling matrix.

    Standard convolution resize as used by the image crate's
    FilterType::Triangle: support 1.0 scaled by max(src/dst, 1), sample
    centers at (i + 0.5) * src/dst."""
    scale = src / dst
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    m = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), src)
        for k in range(lo, hi):
            x = abs((k + 0.5 - center) / fscale)
            if x < 1.0:
                m[i, k] = 1.0 - x
        s = m[i].sum()
        if s > 0:
            m[i] /= s
    return m.astype(F32)


def resize_triangle_u8(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Resize (H, W[, C]) uint8 with the triangle filter, rounding to u8
    per channel (mirrors image::resize_exact + u8 quantization)."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    mh = triangle_kernel_matrix(h, new_h).astype(np.float64)
    mw = triangle_kernel_matrix(w, new_w).astype(np.float64)
    out = np.einsum("ih,hwc,jw->ijc", mh, img.astype(np.float64), mw)
    out = np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.squeeze(-1) if out.shape[-1] == 1 else out


def to_luma709(rgb: np.ndarray) -> np.ndarray:
    """Rec.709 luma as the image crate's to_luma8 computes it."""
    if rgb.ndim == 2:
        return rgb.astype(np.uint8)
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    l = 0.2126 * r + 0.7152 * g + 0.0722 * b
    return np.clip(np.floor(l + 0.5), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# Unnormalized DCT-II (rustdct semantics: plain cosine sums, no scaling)
# --------------------------------------------------------------------------

def dct2_matrix(n: int = DCT_SIZE) -> np.ndarray:
    """(n, n) float32 unnormalized DCT-II: out[k] = sum_j x[j] cos(pi k (2j+1) / 2n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    return np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n)).astype(F32)


_D32 = dct2_matrix()


def phash_from_luma32(luma32: np.ndarray) -> int:
    """32x32 u8/f32 plane -> 64-bit pHash (phash.rs:48-83)."""
    x = luma32.astype(F32)
    d = _D32.astype(np.float64)
    full = d @ x.astype(np.float64) @ d.T
    low = full[:HASH_SIZE, :HASH_SIZE].reshape(-1).astype(F32)
    sorted_no_dc = np.sort(low[1:], kind="stable")
    median = sorted_no_dc[sorted_no_dc.size // 2]  # index 31 of 63
    h = 0
    for i, v in enumerate(low):
        if v > median:
            h |= 1 << (63 - i)
    return h


def hash_image(img: np.ndarray) -> int:
    """Full golden pipeline from an (H, W[, C]) uint8 image."""
    small = resize_triangle_u8(img, DCT_SIZE, DCT_SIZE)
    luma = to_luma709(small)
    return phash_from_luma32(luma)


# --------------------------------------------------------------------------
# Packed-u64 dihedral bit operations (exact; phash.rs:137-255)
# --------------------------------------------------------------------------

def _map_bits(hash64: int, dst_of_src, flip_of_dst) -> int:
    out = 0
    for y in range(8):
        for x in range(8):
            src_idx = 8 * y + x
            dst_x, dst_y = dst_of_src(x, y)
            dst_idx = 8 * dst_y + dst_x
            bit = (hash64 >> (63 - src_idx)) & 1
            if flip_of_dst(dst_x, dst_y):
                bit ^= 1
            out |= bit << (63 - dst_idx)
    return out


def rotate_hash_90(h: int) -> int:
    return _map_bits(h, lambda x, y: (y, x), lambda dx, dy: dx % 2 != 0)


def rotate_hash_180(h: int) -> int:
    return _map_bits(h, lambda x, y: (x, y), lambda dx, dy: (dx + dy) % 2 != 0)


def rotate_hash_270(h: int) -> int:
    return _map_bits(h, lambda x, y: (y, x), lambda dx, dy: dy % 2 != 0)


def flip_hash_horizontal(h: int) -> int:
    return _map_bits(h, lambda x, y: (x, y), lambda dx, dy: dx % 2 != 0)


def rotation_invariant_hash(h: int) -> int:
    """min over the four 90-degree rotations (phash.rs:137-143)."""
    return min(h, rotate_hash_90(h), rotate_hash_180(h), rotate_hash_270(h))


def dihedral_hashes(h: int) -> list[int]:
    """[h0, h90, h180, h270, hf, hf90, hf180, hf270] (phash.rs:242-255)."""
    hf = flip_hash_horizontal(h)
    return [h, rotate_hash_90(h), rotate_hash_180(h), rotate_hash_270(h),
            hf, rotate_hash_90(hf), rotate_hash_180(hf), rotate_hash_270(hf)]


def hamming64(a: int, b: int) -> int:
    return bin(a ^ b).count("1")

"""Golden PDQ reference (numpy, exact float32 semantics): a frozen copy.

A copy of rupphash_tpu_torch/ops/pdq_ref.py as it stood when the
benchmark was defined, kept under the benchmark so that the yardstick
does not move with the program.  The rest of this docstring is the
original's.

Golden PDQ reference implementation (numpy, exact float32 semantics).

This module is the framework's *authoritative spec* for the 256-bit PDQ
perceptual hash.  It replicates, stage by stage and in the same float32
accumulation order, the semantics of the reference implementation
(the Rust reference's `src/pdqhash.rs`, itself facebook/ThreatExchange-compatible
modulo its 512px pre-downsample speedup):

  luma (Rec.601 integer)                  pdqhash.rs:268-284
  optional box downsample to <=512 px     pdqhash.rs:181-235
  two-pass Jarosz box blur                pdqhash.rs:340-426
  decimation to 64x64                     pdqhash.rs:428-443
  image-domain quality metric             pdqhash.rs:445-460
  16x64 DCT-II (frequencies 1..16)        pdqhash.rs:287-336
  lower-median threshold + bit packing    pdqhash.rs:91-162
  dihedral D4 hash set in DCT space       pdqhash.rs:71-151

Everything is pure numpy with explicit, ordered accumulation so the result
is deterministic and serves as the golden against which the TPU fast paths
(`pdq_jax.py`, `pdq_pallas.py`) are validated bit-for-bit.

Float-exactness notes:
* All per-element arithmetic runs in float32, in the reference's order.
* The DCT basis angles are accumulated in float32 exactly like the
  reference, but the final cosine is evaluated in float64 and rounded to
  float32 (correctly rounded; libm `cosf` used by the reference is
  faithfully rounded, so entries agree to <=1 ulp).
* The pre-downsample (only for images >512px) is specified here as an
  exact area-average box resample with float64 accumulation rounded
  half-away-from-zero to u8.  The reference delegates this step to the
  `fast_image_resize` crate's Box convolution; the two agree on the u8
  output for all but pathological half-ULP ties.  Downstream of the u8
  luma plane the pipeline is exact.
"""

from __future__ import annotations

import numpy as np

MIN_HASHABLE_DIM = 5
PDQ_NUM_JAROSZ_XY_PASSES = 2
DOWNSAMPLE_DIMS = 512
BUFFER_W_H = 64
DCT_OUTPUT_W_H = 16
DCT_OUTPUT_MATRIX_SIZE = DCT_OUTPUT_W_H * DCT_OUTPUT_W_H
HASH_LENGTH = DCT_OUTPUT_MATRIX_SIZE // 8  # 32 bytes
JAROSZ_WINDOW_DIVISOR = BUFFER_W_H
DCT_FREQ_OFFSET = 1

F32 = np.float32


# --------------------------------------------------------------------------
# Luma + pre-downsample
# --------------------------------------------------------------------------

def to_luma601(rgb: np.ndarray) -> np.ndarray:
    """Integer Rec.601 luma, mirrors pdqhash.rs:268-284.

    Accepts (H, W, 3) or (H, W, 4) uint8; alpha is ignored (the reference
    reads only the first three channel bytes).  (H, W) uint8 passes through.
    """
    if rgb.ndim == 2:
        return np.ascontiguousarray(rgb, dtype=np.uint8)
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.uint8)


def calculate_target_dimensions(w: int, h: int, max_dim: int = DOWNSAMPLE_DIMS):
    """Integer aspect-preserving thumbnail dims, mirrors pdqhash.rs:224-235."""
    if w == 0 or h == 0:
        return (max(w, 1), max(h, 1))
    if w > h:
        return (max_dim, max((h * max_dim) // w, 1))
    return (max((w * max_dim) // h, 1), max_dim)


def _box_resample_axis_weights(src: int, dst: int):
    """Area-average box resample: per-dst-index (start, weights) pairs.

    Exact area overlap of dst pixel i's footprint [i*s, (i+1)*s) with the
    source grid, s = src/dst.  Weights are float64 and sum to s.
    """
    s = src / dst
    out = []
    for i in range(dst):
        lo = i * s
        hi = (i + 1) * s
        k0 = int(np.floor(lo))
        k1 = int(np.ceil(hi))
        k1 = min(k1, src)
        w = np.empty(k1 - k0, dtype=np.float64)
        for k in range(k0, k1):
            w[k - k0] = min(hi, k + 1) - max(lo, k)
        out.append((k0, w))
    return out


def box_resample_u8(luma: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Aspect-naive box (area-average) resample of a u8 plane to u8.

    Spec replacement for the reference's fast_image_resize Box convolution
    (pdqhash.rs:203-220).  float64 accumulation, round-half-away to u8.
    """
    h, w = luma.shape
    acc = luma.astype(np.float64)
    if new_h != h:
        rows = _box_resample_axis_weights(h, new_h)
        tmp = np.empty((new_h, acc.shape[1]), dtype=np.float64)
        for i, (k0, wts) in enumerate(rows):
            tmp[i] = wts @ acc[k0:k0 + len(wts)]
            tmp[i] /= wts.sum()
        acc = tmp
    if new_w != w:
        cols = _box_resample_axis_weights(w, new_w)
        tmp = np.empty((acc.shape[0], new_w), dtype=np.float64)
        for j, (k0, wts) in enumerate(cols):
            tmp[:, j] = acc[:, k0:k0 + len(wts)] @ wts
            tmp[:, j] /= wts.sum()
        acc = tmp
    # round half away from zero (values are non-negative -> floor(x + 0.5))
    return np.floor(acc + 0.5).clip(0, 255).astype(np.uint8)


def prepare_luma(image: np.ndarray):
    """Luma + conditional downsample; mirrors generate_pdq_features
    (pdqhash.rs:166-196).  Returns a u8 plane or None if too small."""
    h, w = image.shape[:2]
    if w < MIN_HASHABLE_DIM or h < MIN_HASHABLE_DIM:
        return None
    luma = to_luma601(image)
    if w > DOWNSAMPLE_DIMS or h > DOWNSAMPLE_DIMS:
        new_w, new_h = calculate_target_dimensions(w, h, DOWNSAMPLE_DIMS)
        luma = box_resample_u8(luma, new_w, new_h)
    return luma


# --------------------------------------------------------------------------
# Jarosz two-pass box filter (exact 4-phase running sums, float32)
# --------------------------------------------------------------------------

def _box_1d_lines(lines: np.ndarray, win: int) -> np.ndarray:
    """Box-filter every row of `lines` (N, L) float32 along axis 1.

    Per-lane arithmetic order is exactly pdqhash.rs:340-396 (4-phase
    running sum: grow, slide, shrink); vectorized across the N lanes.
    """
    n, length = lines.shape
    win = max(1, min(win, max(length, 1)))
    half_win = (win + 2) // 2
    phase_1 = half_win - 1
    phase_2 = win - half_win + 1
    phase_3 = max(length - win, 0)
    phase_4 = half_win - 1

    out = np.empty_like(lines)
    s = np.zeros(n, dtype=F32)
    li = 0
    ri = 0
    oi = 0
    curr_win = F32(0.0)
    for _ in range(phase_1):
        s = s + lines[:, ri]
        curr_win = F32(curr_win + F32(1.0))
        ri += 1
    for _ in range(phase_2):
        s = s + lines[:, ri]
        curr_win = F32(curr_win + F32(1.0))
        out[:, oi] = s / curr_win
        ri += 1
        oi += 1
    for _ in range(phase_3):
        s = s + lines[:, ri]
        s = s - lines[:, li]
        out[:, oi] = s / curr_win
        li += 1
        ri += 1
        oi += 1
    for _ in range(phase_4):
        s = s - lines[:, li]
        curr_win = F32(curr_win - F32(1.0))
        out[:, oi] = s / curr_win
        li += 1
        oi += 1
    return out


def jarosz_filter(buf: np.ndarray, w_rows: int, w_cols: int,
                  nreps: int = PDQ_NUM_JAROSZ_XY_PASSES) -> np.ndarray:
    """Two-pass Jarosz blur on a (rows, cols) float32 plane.

    Mirrors jarosz_filter_float (pdqhash.rs:410-426): each rep box-filters
    along rows (window w_rows over the column index) then along columns
    (window w_cols over the row index).
    """
    out = buf.astype(F32, copy=True)
    for _ in range(nreps):
        out = _box_1d_lines(out, w_rows)          # along each row
        out = _box_1d_lines(out.T.copy(), w_cols).T  # along each column
    return np.ascontiguousarray(out)


def decimate(buf: np.ndarray, out_r: int = BUFFER_W_H,
             out_c: int = BUFFER_W_H) -> np.ndarray:
    """Point-sample decimation, mirrors decimate_float (pdqhash.rs:428-443)."""
    in_r, in_c = buf.shape
    ri = ((2 * np.arange(out_r) + 1) * in_r) // (out_r * 2)
    ci = ((2 * np.arange(out_c) + 1) * in_c) // (out_c * 2)
    return buf[np.ix_(ri, ci)].astype(F32)


def quality_metric(buf64: np.ndarray) -> float:
    """Image-domain quality in [0, 1], mirrors pdqhash.rs:445-460.

    Every term trunc(|(a-b)*100/255|) is an exact small integer in f32, so
    the sum is order-independent and exact.
    """
    b = buf64.astype(F32)
    vert = b[:-1, :] - b[1:, :]
    horiz = b[:, :-1] - b[:, 1:]
    terms = []
    for d in (vert, horiz):
        t = np.trunc(np.abs((d * F32(100.0)) / F32(255.0)))
        terms.append(t.sum(dtype=np.float64))
    q = F32(np.float64(terms[0] + terms[1])) / F32(90.0)
    return float(min(q, F32(1.0)))


# --------------------------------------------------------------------------
# DCT 64 -> 16
# --------------------------------------------------------------------------

_DCT_MATRIX_CACHE: np.ndarray | None = None


def dct_matrix() -> np.ndarray:
    """(16, 64) float32 DCT-II basis rows for frequencies 1..16.

    Mirrors compute_dct_matrix (pdqhash.rs:287-304): the angle is
    accumulated in f32, the cosine is evaluated exactly and rounded to f32.
    """
    global _DCT_MATRIX_CACHE
    if _DCT_MATRIX_CACHE is not None:
        return _DCT_MATRIX_CACHE
    n = BUFFER_W_H
    inv_sqrt_cols = F32(1.0) / np.sqrt(F32(n))
    norm = F32(inv_sqrt_cols * np.sqrt(F32(2.0)))
    pi = F32(np.pi)
    m = np.empty((DCT_OUTPUT_W_H, n), dtype=F32)
    for i in range(DCT_OUTPUT_W_H):
        freq = F32(i + DCT_FREQ_OFFSET)
        for j in range(n):
            angle = F32(F32(pi * freq) * F32(F32(2.0) * F32(j) + F32(1.0)))
            angle = F32(angle / F32(2.0 * n))
            m[i, j] = F32(np.cos(np.float64(angle)))
    _DCT_MATRIX_CACHE = m * norm  # f32 elementwise product, same as reference
    return _DCT_MATRIX_CACHE


def dct64_to_16(buf64: np.ndarray) -> np.ndarray:
    """(64, 64) f32 -> flat (256,) f32 coefficients.

    Accumulation order matches dct64_to_16 (pdqhash.rs:306-336): pass 1
    accumulates over k with k as the outer loop (vectorized over j, which
    preserves each element's accumulation chain); pass 2 sums over k
    sequentially.
    """
    d = dct_matrix()
    b = buf64.astype(F32)
    inter = np.zeros((DCT_OUTPUT_W_H, BUFFER_W_H), dtype=F32)
    for k in range(BUFFER_W_H):
        inter += d[:, k:k + 1] * b[k:k + 1, :]
    out = np.zeros((DCT_OUTPUT_W_H, DCT_OUTPUT_W_H), dtype=F32)
    for k in range(BUFFER_W_H):
        out += inter[:, k:k + 1] * d[:, k][None, :]
    return out.reshape(-1)


# --------------------------------------------------------------------------
# Median threshold, bit packing, dihedral variants
# --------------------------------------------------------------------------

_ROW_FREQ_ODD = ((np.arange(DCT_OUTPUT_W_H) + DCT_FREQ_OFFSET) % 2 == 1)


def _signed(coeffs: np.ndarray, neg_rows: bool, neg_cols: bool) -> np.ndarray:
    """apply_sign over the 16x16 block (pdqhash.rs:127-137): a mirror negates
    odd DCT *frequencies* (index + DCT_FREQ_OFFSET), not odd indices."""
    c = coeffs.reshape(DCT_OUTPUT_W_H, DCT_OUTPUT_W_H)
    flip_r = _ROW_FREQ_ODD if neg_rows else np.zeros(DCT_OUTPUT_W_H, bool)
    flip_c = _ROW_FREQ_ODD if neg_cols else np.zeros(DCT_OUTPUT_W_H, bool)
    flip = flip_r[:, None] ^ flip_c[None, :]
    return np.where(flip, -c, c).astype(F32)


def _lower_median(vals: np.ndarray) -> F32:
    """torben-compatible lower median: the 128th smallest of 256
    (pdqhash.rs:116-124)."""
    flat = np.sort(vals.reshape(-1), kind="stable")
    return flat[(flat.size - 1) // 2]


def _bit_matrix(coeffs: np.ndarray, neg_rows: bool, neg_cols: bool) -> np.ndarray:
    """(16, 16) bool: bit (r, c) = signed coefficient > that variant's median
    (pdqhash.rs:91-106)."""
    signed = _signed(coeffs, neg_rows, neg_cols)
    return signed > _lower_median(signed)


def pack_bits(bits: np.ndarray) -> bytes:
    """Pack a (16, 16) bool bit matrix into the reference's 32-byte layout:
    coefficient idx = r*16+c lands in byte 31 - idx//8, bit idx%8
    (pdqhash.rs:153-162 / naive_to_hash pdqhash.rs:470-486)."""
    flat = bits.reshape(-1)
    out = bytearray(HASH_LENGTH)
    for i in range(HASH_LENGTH):
        byte = 0
        for j in range(8):
            if flat[i * 8 + j]:
                byte |= 1 << j
        out[HASH_LENGTH - 1 - i] = byte
    return bytes(out)


def coeffs_to_hash(coeffs: np.ndarray) -> bytes:
    return pack_bits(_bit_matrix(coeffs, False, False))


def dihedral_hashes(coeffs: np.ndarray) -> list[bytes]:
    """All 8 dihedral-variant hashes from one coefficient block, in the
    reference order: identity, rot90, rot180, rot270, mirror-x, mirror-y,
    transpose, anti-transpose (pdqhash.rs:71-87).

    A transpose only permutes coefficients (median invariant), so the
    transposed variants are bit-transposes of the plain ones.
    """
    ident = _bit_matrix(coeffs, False, False)
    neg_c = _bit_matrix(coeffs, False, True)
    neg_r = _bit_matrix(coeffs, True, False)
    neg_b = _bit_matrix(coeffs, True, True)
    return [
        pack_bits(ident),
        pack_bits(neg_r.T),
        pack_bits(neg_b),
        pack_bits(neg_c.T),
        pack_bits(neg_c),
        pack_bits(neg_r),
        pack_bits(ident.T),
        pack_bits(neg_b.T),
    ]


def dihedral_hashes_batch(coeffs_batch: np.ndarray) -> np.ndarray:
    """(B, 256) f32 coefficient blocks -> (B, 8, 32) uint8 dihedral
    hashes, bit-identical to per-file dihedral_hashes (asserted in
    tests).  Vectorized for the cached-rescan path, where regenerating
    variants one file at a time (pack_bits is a 256-step Python loop
    per call) dominated the probe cost at scan rate."""
    c = np.asarray(coeffs_batch, F32).reshape(-1, DCT_OUTPUT_W_H,
                                              DCT_OUTPUT_W_H)
    b = len(c)
    flip_r = _ROW_FREQ_ODD[:, None]
    flip_c = _ROW_FREQ_ODD[None, :]
    zeros = np.zeros_like(flip_r, bool)
    # sign-variant order matches _bit_matrix calls in dihedral_hashes:
    # ident, neg_c, neg_r, neg_b
    flips = np.stack([
        zeros ^ zeros.T, zeros ^ flip_c, flip_r ^ zeros.T,
        flip_r ^ flip_c])                              # (4, 16, 16)
    signed = np.where(flips[None], -c[:, None], c[:, None])  # (B,4,16,16)
    flat = signed.reshape(b, 4, 256)
    med = np.sort(flat, axis=-1, kind="stable")[:, :, (256 - 1) // 2]
    bits = flat > med[:, :, None]                      # (B, 4, 256)
    bm = bits.reshape(b, 4, 16, 16)
    ident, neg_c, neg_r, neg_b = (bm[:, k] for k in range(4))
    t = lambda m: np.swapaxes(m, 1, 2)
    variants = np.stack([ident, t(neg_r), neg_b, t(neg_c),
                         neg_c, neg_r, t(ident), t(neg_b)],
                        axis=1)                        # (B, 8, 16, 16)
    vb = variants.reshape(b, 8, 32, 8)
    packed = np.packbits(vb, axis=-1, bitorder="little")[..., 0]
    return packed[:, :, ::-1].copy()                   # byte 31-i layout


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def pdq_from_luma(luma: np.ndarray):
    """u8 luma plane -> (coeffs float32[256], buffer64 float32[64,64],
    quality float).  Mirrors generate_pdq_from_luma (pdqhash.rs:238-262)."""
    rows, cols = luma.shape
    buf = luma.astype(F32)
    w_rows = -(-cols // JAROSZ_WINDOW_DIVISOR)   # ceil(cols / 64)
    w_cols = -(-rows // JAROSZ_WINDOW_DIVISOR)   # ceil(rows / 64)
    blurred = jarosz_filter(buf, w_rows, w_cols)
    buf64 = decimate(blurred)
    quality = quality_metric(buf64)
    coeffs = dct64_to_16(buf64)
    return coeffs, buf64, quality


def generate_pdq_features(image: np.ndarray):
    """Full golden pipeline from an (H, W[, C]) uint8 image.

    Returns (coeffs float32[256], quality float) or None for images smaller
    than MIN_HASHABLE_DIM, mirroring generate_pdq_features
    (pdqhash.rs:166-196).
    """
    luma = prepare_luma(image)
    if luma is None:
        return None
    coeffs, _, quality = pdq_from_luma(luma)
    return coeffs, quality


def generate_pdq(image: np.ndarray):
    """(hash bytes[32], quality float) or None (pdqhash.rs:199-201)."""
    feats = generate_pdq_features(image)
    if feats is None:
        return None
    coeffs, quality = feats
    return coeffs_to_hash(coeffs), quality


def hamming_distance(a: bytes, b: bytes) -> int:
    return int(bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1"))

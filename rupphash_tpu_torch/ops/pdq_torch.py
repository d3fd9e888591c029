"""PDQ hashing in PyTorch: operators, plain stages and the batch API.

Counterpart of rupphash_tpu/ops/pdq_jax.py.  Everything the reference
does between the u8 luma plane and the DCT input is linear and
separable, so buffer64 = L . X . R^T with per-shape operators composed
in float64 on the host (the builders below are copied from the JAX
package, which cannot be imported here), and one image's PDQ is two
matmuls, the 16x64 DCT, a lower median and bit packing.

The public functions return a dict of tensors on the input's device:
hash (B, 32) u8, dihedral (B, 8, 32) u8, quality (B,) f32 and
coeffs (B, 256) f32.  A CUDA batch is hashed by the fused kernel K1
(ops/pdq_cuda.py); a CPU batch by the plain stages here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device
from . import pdq_ref

BUFFER_W_H = pdq_ref.BUFFER_W_H
DCT_OUTPUT_W_H = pdq_ref.DCT_OUTPUT_W_H


# --------------------------------------------------------------------------
# Host-side operator construction (float64, cached per working shape)
# --------------------------------------------------------------------------

def box_filter_matrix(length: int, win: int) -> np.ndarray:
    """(length, length) float64 matrix of the reference's 4-phase box filter.

    Closed form of box_one_d_float (pdqhash.rs:340-396): with
    half = (win + 2) // 2, output o averages input [lo, hi) where
    lo = max(0, o + half - win), hi = min(length, o + half).
    """
    win = max(1, min(win, max(length, 1)))
    half = (win + 2) // 2
    m = np.zeros((length, length), dtype=np.float64)
    for o in range(length):
        lo = max(0, o + half - win)
        hi = min(length, o + half)
        m[o, lo:hi] = 1.0 / (hi - lo)
    return m


def decimation_indices(in_len: int, out_len: int = BUFFER_W_H) -> np.ndarray:
    i = np.arange(out_len)
    return ((2 * i + 1) * in_len) // (2 * out_len)


@functools.lru_cache(maxsize=512)
def linear_operators(rows: int, cols: int):
    """(L, R): float32 (64, rows) and (64, cols) operators with
    buffer64 = L @ X @ R.T for a (rows, cols) luma plane X."""
    w_rows = -(-cols // pdq_ref.JAROSZ_WINDOW_DIVISOR)  # window along rows
    w_cols = -(-rows // pdq_ref.JAROSZ_WINDOW_DIVISOR)  # window along cols
    bh = box_filter_matrix(rows, w_cols)
    bw = box_filter_matrix(cols, w_rows)
    bh2 = bh @ bh
    bw2 = bw @ bw
    l_op = bh2[decimation_indices(rows)]          # D_r @ B_h^2
    r_op = bw2[decimation_indices(cols)]          # D_c @ B_w^2
    return (np.asarray(l_op, dtype=np.float32),
            np.asarray(r_op, dtype=np.float32))


@functools.lru_cache(maxsize=1)
def dct16x64() -> np.ndarray:
    return np.asarray(pdq_ref.dct_matrix())


def _sign_patterns() -> np.ndarray:
    """(4, 16, 16) float32 sign masks for (neg_rows, neg_cols) in
    [(F,F), (F,T), (T,F), (T,T)].  A mirror negates odd DCT *frequencies*
    (index + 1), i.e. even array indices (pdqhash.rs:127-137)."""
    odd_freq = ((np.arange(DCT_OUTPUT_W_H) + pdq_ref.DCT_FREQ_OFFSET) % 2 == 1)
    pats = np.empty((4, DCT_OUTPUT_W_H, DCT_OUTPUT_W_H), dtype=np.float32)
    for v, (nr, nc) in enumerate([(False, False), (False, True),
                                  (True, False), (True, True)]):
        fr = odd_freq if nr else np.zeros_like(odd_freq)
        fc = odd_freq if nc else np.zeros_like(odd_freq)
        pats[v] = np.where(fr[:, None] ^ fc[None, :], -1.0, 1.0)
    return pats


def _pack_matrices():
    """(256, 32) packing matrices, plain and bit-transposed: coefficient
    idx = r*16+c lands in byte 31 - idx//8 with weight 1 << (idx%8); the
    transposed variants first move idx to c*16+r."""
    plain = np.zeros((256, 32), dtype=np.float32)
    trans = np.zeros((256, 32), dtype=np.float32)
    for idx in range(256):
        plain[idx, 31 - idx // 8] = float(1 << (idx % 8))
        r, c = divmod(idx, 16)
        dst = c * 16 + r
        trans[idx, 31 - dst // 8] = float(1 << (dst % 8))
    return plain, trans


_SIGNS = _sign_patterns()
_PACK_PLAIN, _PACK_TRANS = _pack_matrices()

# reference variant order (pdqhash.rs:77-86) as (sign-variant index in
# _SIGNS order [id, neg_c, neg_r, neg_b], transposed?) pairs
_VARIANT_ORDER = [(0, False), (2, True), (3, False), (1, True),
                  (1, False), (2, False), (0, True), (3, True)]


# --------------------------------------------------------------------------
# Plain stages (the CPU path, and the reference K1 is checked against)
# --------------------------------------------------------------------------

def quality_from_buffer(buf64: torch.Tensor) -> torch.Tensor:
    """(B, 64, 64) -> (B,) quality in [0, 1]; every term is an exact small
    integer in f32 so the reduction order is irrelevant (pdqhash.rs:445-460)."""
    vert = buf64[:, :-1, :] - buf64[:, 1:, :]
    horiz = buf64[:, :, :-1] - buf64[:, :, 1:]
    tv = torch.trunc(torch.abs(vert * 100.0 / 255.0)).sum(dim=(1, 2))
    th = torch.trunc(torch.abs(horiz * 100.0 / 255.0)).sum(dim=(1, 2))
    return torch.clamp((tv + th) / 90.0, max=1.0)


_SIGN_BIT = 1 << 31


def _median_lower_bisect(flat: torch.Tensor) -> torch.Tensor:
    """(B, 4, 256) -> (B, 4) lower median (128th smallest,
    pdqhash.rs:116-124) by a 32-step binary search over the
    order-preserving float -> uint32 key map, held in int64.  Selects
    exactly the element a sort would (ties at +/-0.0 compare identically
    downstream)."""
    i = flat.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(i >= 0, i + _SIGN_BIT, -i - 1)    # ~i == -i - 1
    lo = torch.zeros(flat.shape[:2], dtype=torch.int64, device=flat.device)
    hi = torch.full(flat.shape[:2], 0xFFFFFFFF, dtype=torch.int64,
                    device=flat.device)
    for _ in range(32):
        # invariant: count(<= lo-1) < 128 <= count(<= hi)
        mid = lo + (hi - lo) // 2
        take_hi = (key <= mid[:, :, None]).sum(dim=2) >= 128
        lo = torch.where(take_hi, lo, mid + 1)
        hi = torch.where(take_hi, mid, hi)
    as_int = torch.where(lo >= _SIGN_BIT, lo - _SIGN_BIT, -lo - 1)
    return as_int.to(torch.int32).view(torch.float32)


def dihedral_from_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """(B, 16, 16) float32 coefficients -> (B, 8, 32) uint8 dihedral
    hashes in the reference order (pdqhash.rs:71-87): identity, rot90,
    rot180, rot270, mirror-x, mirror-y, transpose, anti-transpose.  The
    packing products are exact: sums of distinct powers of two <= 255."""
    b = coeffs.shape[0]
    dev = coeffs.device
    flat = (coeffs.reshape(b, 1, 256)
            * torch.from_numpy(_SIGNS).to(dev).reshape(1, 4, 256))
    med = _median_lower_bisect(flat)
    bits = (flat > med[:, :, None]).to(torch.float32)          # (B,4,256)
    pp = torch.einsum("bvc,ck->bvk", bits, torch.from_numpy(_PACK_PLAIN).to(dev))
    pt = torch.einsum("bvc,ck->bvk", bits, torch.from_numpy(_PACK_TRANS).to(dev))
    outs = [(pt if tr else pp)[:, v, :] for v, tr in _VARIANT_ORDER]
    return torch.stack(outs, dim=1).to(torch.int32).to(torch.uint8)


def _finish(buf64: torch.Tensor, d16: torch.Tensor) -> dict:
    quality = quality_from_buffer(buf64)
    coeffs = d16 @ (buf64 @ d16.T)                               # (B,16,16)
    dihedral = dihedral_from_coeffs(coeffs)
    return {"hash": dihedral[:, 0, :], "dihedral": dihedral,
            "quality": quality, "coeffs": coeffs.reshape(-1, 256)}


def pdq_core(lumas: torch.Tensor, l_op: torch.Tensor, r_op: torch.Tensor,
             d16: torch.Tensor) -> dict:
    """(B, H, W) u8 lumas + one shape's operators -> output dict."""
    x = lumas.to(torch.float32)
    buf64 = l_op @ (x @ r_op.T)                                  # (B,64,64)
    return _finish(buf64, d16)


def pdq_core_mixed(lumas: torch.Tensor, l_ops: torch.Tensor,
                   r_ops: torch.Tensor, d16: torch.Tensor) -> dict:
    """Mixed-shape variant: per-image operators over zero-padded planes.
    lumas (B, Hp, Wp) u8; l_ops (B, 64, Hp); r_ops (B, 64, Wp).  The
    padded columns of L/R multiply only zero pixels."""
    x = lumas.to(torch.float32)
    buf64 = torch.bmm(l_ops, torch.bmm(x, r_ops.transpose(1, 2)))
    return _finish(buf64, d16)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def _as_device_u8(lumas) -> torch.Tensor:
    if isinstance(lumas, torch.Tensor):
        return lumas
    return torch.from_numpy(np.require(lumas, np.uint8, ["C", "W"])).to(
        device.get())


def _run(planes: torch.Tensor, l_unique: np.ndarray, r_unique: np.ndarray,
         shape_idx: np.ndarray) -> dict:
    from . import pdq_cuda

    dev = planes.device
    return pdq_cuda.pdq_hash(
        planes, torch.from_numpy(l_unique).to(dev),
        torch.from_numpy(r_unique).to(dev),
        torch.from_numpy(shape_idx),   # checked on the host, then uploaded
        torch.from_numpy(dct16x64()).to(dev))


def pdq_hash_batch(lumas) -> dict:
    """Hash a batch of same-shape u8 luma planes (B, rows, cols), given as
    numpy (moved to the port's device) or as a tensor (hashed where it
    lies).  The working shape must already respect the reference's
    pre-downsample contract (<=512 px per side)."""
    planes = _as_device_u8(lumas)
    b, rows, cols = planes.shape
    l_op, r_op = linear_operators(rows, cols)
    return _run(planes, l_op[None], r_op[None], np.zeros(b, np.int32))


def _bucket_dim(n: int, quantum: int = 64) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def pad_mixed(lumas: list):
    """Pack planes of arbitrary working shapes into K1's mixed-batch
    inputs: (planes (Bpad, Hp, Wp) u8, l_unique (Spad, 64, Hp) f32,
    r_unique (Spad, 64, Wp) f32, shape_idx (Bpad,) int32), numpy.
    Planes pad to 64-pixel buckets, the batch to a power of two (at
    least 8) and the unique-shape count to a power of two, as the JAX
    package does; operators are built once per unique (rows, cols)."""
    b = len(lumas)
    hp = _bucket_dim(max(l.shape[0] for l in lumas))
    wp = _bucket_dim(max(l.shape[1] for l in lumas))
    bpad = max(8, 1 << (b - 1).bit_length())
    planes = np.zeros((bpad, hp, wp), dtype=np.uint8)
    shape_id: dict[tuple[int, int], int] = {}
    idx = np.zeros(bpad, dtype=np.int32)
    for k, luma in enumerate(lumas):
        rows, cols = luma.shape
        planes[k, :rows, :cols] = luma
        idx[k] = shape_id.setdefault((rows, cols), len(shape_id))
    spad = 1 << (len(shape_id) - 1).bit_length()
    l_unique = np.zeros((spad, BUFFER_W_H, hp), dtype=np.float32)
    r_unique = np.zeros((spad, BUFFER_W_H, wp), dtype=np.float32)
    for (rows, cols), sid in shape_id.items():
        lo, ro = linear_operators(rows, cols)
        l_unique[sid, :, :rows] = lo
        r_unique[sid, :, :cols] = ro
    return planes, l_unique, r_unique, idx


def pdq_hash_batch_mixed(lumas: list) -> dict:
    """Hash a list of u8 luma planes of arbitrary working shapes as one
    padded batch (see pad_mixed) on the port's device; results are
    bit-identical to the per-shape path."""
    b = len(lumas)
    dev = device.get()
    if b == 0:
        return {"hash": torch.zeros((0, 32), dtype=torch.uint8, device=dev),
                "dihedral": torch.zeros((0, 8, 32), dtype=torch.uint8,
                                        device=dev),
                "quality": torch.zeros((0,), dtype=torch.float32, device=dev),
                "coeffs": torch.zeros((0, 256), dtype=torch.float32,
                                      device=dev)}
    planes, l_unique, r_unique, idx = pad_mixed(lumas)
    out = _run(torch.from_numpy(planes).to(dev), l_unique, r_unique, idx)
    if len(planes) == b:
        return out
    return {k: v[:b] for k, v in out.items()}


def pdq_hash_image(image: np.ndarray):
    """Single-image convenience mirroring generate_pdq (pdqhash.rs:199):
    returns (hash bytes, quality float) or None."""
    luma = pdq_ref.prepare_luma(image)
    if luma is None:
        return None
    out = pdq_hash_batch(luma[None])
    return bytes(out["hash"][0].cpu().numpy()), float(out["quality"][0])

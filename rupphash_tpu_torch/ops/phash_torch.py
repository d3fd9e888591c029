"""Batched 64-bit pHash in PyTorch.

Counterpart of rupphash_tpu/ops/phash_jax.py.  From a u8 luma working
plane X, the classic pHash's triangle resize to 32x32 and the top-left
8x8 of its DCT fold into two skinny operators,

    low8x8 = P . X . Q,   P = D32[:8] . T_h (8, rows),  Q = T_w^T . D32[:8]^T (cols, 8),

so one image is two float32 matmuls (TF32 off, the device policy), a
median over the 63 non-DC coefficients and bit packing.  The JAX module
has no Pallas kernel, so neither has this one.  The operators and the
golden come from ops/phash_ref.py, the port's copy of the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device
from . import phash_ref
from .pdq_torch import _as_device_u8

HASH_SIZE = phash_ref.HASH_SIZE


@functools.lru_cache(maxsize=512)
def phash_operators(rows: int, cols: int):
    """(P, Q): float32 (8, rows) and (cols, 8) fused resize+DCT operators,
    composed in float64 as the reference composes them."""
    d8 = phash_ref.dct2_matrix().astype(np.float64)[:HASH_SIZE]
    th = phash_ref.triangle_kernel_matrix(rows, 32).astype(np.float64)
    tw = phash_ref.triangle_kernel_matrix(cols, 32).astype(np.float64)
    return (d8 @ th).astype(np.float32), (tw.T @ d8.T).astype(np.float32)


_BYTE_WEIGHTS = 1 << np.arange(7, -1, -1)


def bits_to_u64_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) bool -> (..., 8) uint8, big-endian: bit 63 is (0, 0),
    i.e. byte 0 is the first row with its first column in the MSB."""
    weights = torch.tensor(_BYTE_WEIGHTS, dtype=torch.int32,
                           device=bits.device)
    return (bits.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)


_Y = np.arange(8)
_COL_ODD = np.broadcast_to(_Y % 2 == 1, (8, 8))              # dst_x odd
_ROW_ODD = np.ascontiguousarray(_COL_ODD.T)                 # dst_y odd
_SUM_ODD = (_Y[:, None] + _Y[None, :]) % 2 == 1


def dihedral_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) bool -> (B, 8, 8, 8) bool: the 8 dihedral variants in the
    reference order [id, r90, r180, r270, fh, fh+r90, fh+r180, fh+r270],
    as exact bit-matrix operations (phash.rs:150-255)."""
    dev = bits.device
    col_odd, row_odd, sum_odd = (torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                                 for m in (_COL_ODD, _ROW_ODD, _SUM_ODD))

    def r90(b):
        return b.transpose(-1, -2) ^ col_odd

    def r180(b):
        return b ^ sum_odd

    def r270(b):
        return b.transpose(-1, -2) ^ row_odd

    f = bits ^ col_odd
    return torch.stack([bits, r90(bits), r180(bits), r270(bits),
                        f, r90(f), r180(f), r270(f)], dim=1)


def phash_core(lumas: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> dict:
    """(B, H, W) u8 lumas -> {hash (B, 8) u8, dihedral (B, 8, 8) u8}."""
    x = lumas.to(torch.float32)
    low = torch.matmul(p, torch.matmul(x, q))                  # (B, 8p, 8q)
    flat = low.reshape(-1, 64)
    # median excluding DC: sorted[31] of the 63 non-DC coefficients
    median = torch.sort(flat[:, 1:], dim=-1).values[:, 31]
    bits = (flat > median[:, None]).reshape(-1, 8, 8)
    packed = bits_to_u64_bytes(dihedral_bits(bits))            # (B, 8, 8)
    return {"hash": packed[:, 0, :], "dihedral": packed}


def phash_batch(lumas) -> dict:
    """Hash a batch of same-shape u8 luma planes (B, rows, cols), numpy
    (moved to the port's device) or a tensor (hashed where it lies)."""
    device.set_precision_flags()
    planes = _as_device_u8(lumas)
    _, rows, cols = planes.shape
    p, q = (torch.from_numpy(a).to(planes.device)
            for a in phash_operators(rows, cols))
    return phash_core(planes, p, q)


def u64_from_bytes(b) -> int:
    return int.from_bytes(bytes(np.asarray(b, dtype=np.uint8)), "big")

"""K1: the fused PDQ hashing kernel (csrc/pdq.cu) and its plain version.

Replaces rupphash_tpu/ops/pdq_pallas.py::_pdq_kernel.  One launch
hashes a batch of u8 planes zero-padded to (Hp, Wp); each image picks
its (L, R) operators from the S unique pairs by shape_idx, so a
same-shape batch (S = 1) and a mixed-shape batch share one kernel.
"""

from __future__ import annotations

import torch

from . import _build, pdq_torch


def pdq_hash_plain(lumas, l_unique, r_unique, shape_idx, d16) -> dict:
    """Plain PyTorch version of the kernel, same arguments and outputs."""
    if l_unique.shape[0] == 1:
        return pdq_torch.pdq_core(lumas, l_unique[0], r_unique[0], d16)
    idx = shape_idx.long()
    return pdq_torch.pdq_core_mixed(lumas, l_unique[idx], r_unique[idx], d16)


def _check(lumas, l_unique, r_unique, shape_idx, d16):
    if lumas.dtype != torch.uint8 or lumas.dim() != 3:
        raise ValueError(f"lumas must be (B, Hp, Wp) uint8, got "
                         f"{tuple(lumas.shape)} {lumas.dtype}")
    b, hp, wp = lumas.shape
    if not (1 <= hp <= 512 and 1 <= wp <= 512):
        raise ValueError(f"working shape {hp}x{wp} exceeds 512 px per side")
    s = l_unique.shape[0]
    expect = {"l_unique": (l_unique, (s, 64, hp), torch.float32),
              "r_unique": (r_unique, (s, 64, wp), torch.float32),
              "shape_idx": (shape_idx, (b,), torch.int32),
              "d16": (d16, (16, 64), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != lumas.device:
            raise ValueError(f"{name} is on {t.device}, lumas on {lumas.device}")
    for name, t in (("lumas", lumas), *((k, v[0]) for k, v in expect.items())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pdq_hash(lumas, l_unique, r_unique, shape_idx, d16) -> dict:
    """lumas (B, Hp, Wp) u8; l_unique (S, 64, Hp), r_unique (S, 64, Wp)
    f32; shape_idx (B,) int32 in [0, S); d16 (16, 64) f32 ->
    {hash (B, 32) u8, dihedral (B, 8, 32) u8, quality (B,) f32,
    coeffs (B, 256) f32}.  CUDA tensors launch K1; CPU tensors take
    the plain version."""
    _check(lumas, l_unique, r_unique, shape_idx, d16)
    if not lumas.is_cuda:
        return pdq_hash_plain(lumas, l_unique, r_unique, shape_idx, d16)
    b, hp, wp = lumas.shape
    dev = lumas.device
    if b:
        lo, hi = (int(v) for v in torch.aminmax(shape_idx))
        if lo < 0 or hi >= l_unique.shape[0]:
            raise ValueError(f"shape_idx spans [{lo}, {hi}], outside "
                             f"[0, {l_unique.shape[0]})")
    dihedral = torch.empty((b, 8, 32), dtype=torch.uint8, device=dev)
    quality = torch.empty((b,), dtype=torch.float32, device=dev)
    coeffs = torch.empty((b, 256), dtype=torch.float32, device=dev)
    lib = _build.load().lib
    err = lib.rupp_pdq_hash(
        lumas.data_ptr(), b, hp, wp, l_unique.data_ptr(), r_unique.data_ptr(),
        shape_idx.data_ptr(), d16.data_ptr(), dihedral.data_ptr(),
        quality.data_ptr(), coeffs.data_ptr(), _build.stream_ptr(lumas))
    _build.check(err, "pdq_hash_kernel")
    pdq_hash.launches += 1
    return {"hash": dihedral[:, 0, :], "dihedral": dihedral,
            "quality": quality, "coeffs": coeffs}


pdq_hash.launches = 0

"""K1: the fused PDQ hashing kernel (csrc/pdq.cu) and its plain version.

Replaces rupphash_tpu/ops/pdq_pallas.py::_pdq_kernel.  One launch
hashes a batch of u8 planes zero-padded to (Hp, Wp); each image picks
its (L, R) operators from the S unique pairs by shape_idx, so a
same-shape batch (S = 1) and a mixed-shape batch share one kernel.  The
kernel stages 16-byte pieces, so the wrapper pads Wp to a multiple of 16
and Hp to one of 4 with zero pixels and zero operator columns, which
leaves every hash bit-identical (the zero terms come last in each sum),
and hands it the operators transposed (k-major), as its tiles read them.
"""

from __future__ import annotations

import torch

from . import _build, pdq_torch

_ALIGN_W, _ALIGN_H = 16, 4


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
        if t.device != lumas.device and not (name == "shape_idx"
                                              and t.device.type == "cpu"):
            raise ValueError(f"{name} is on {t.device}, lumas on {lumas.device}")
    for name, t in (("lumas", lumas), *((k, v[0]) for k, v in expect.items())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_operands(lumas, l_unique, r_unique):
    """The kernel's operands: lumas padded up to its alignment with zeros
    and the operators transposed, L^T (S, Hp, 64) and R^T (S, Wp, 64),
    with zero rows for the padding; 16-byte aligned data pointers."""
    _, hp, wp = lumas.shape
    dh, dw = -hp % _ALIGN_H, -wp % _ALIGN_W
    if dh or dw:
        pad = torch.nn.functional.pad
        lumas, l_unique, r_unique = (pad(lumas, (0, dw, 0, dh)),
                                     pad(l_unique, (0, dh)),
                                     pad(r_unique, (0, dw)))
    return (_aligned(lumas), l_unique.transpose(1, 2).contiguous(),
            r_unique.transpose(1, 2).contiguous())


def pdq_hash(lumas, l_unique, r_unique, shape_idx, d16) -> dict:
    """lumas (B, Hp, Wp) u8; l_unique (S, 64, Hp), r_unique (S, 64, Wp)
    f32; shape_idx (B,) int32 in [0, S); d16 (16, 64) f32 ->
    {hash (B, 32) u8, dihedral (B, 8, 32) u8, quality (B,) f32,
    coeffs (B, 256) f32}.  CUDA tensors launch K1; CPU tensors take
    the plain version.  shape_idx may lie on the host beside CUDA
    operands (as the scan passes it): it is then range-checked there,
    without waiting for the card, and uploaded only when S > 1."""
    _check(lumas, l_unique, r_unique, shape_idx, d16)
    if not lumas.is_cuda:
        return pdq_hash_plain(lumas, l_unique, r_unique, shape_idx, d16)
    b = lumas.shape[0]
    dev = lumas.device
    if b:
        lo, hi = (int(v) for v in torch.aminmax(shape_idx))
        if lo < 0 or hi >= l_unique.shape[0]:
            raise ValueError(f"shape_idx spans [{lo}, {hi}], outside "
                             f"[0, {l_unique.shape[0]})")
    # one operator pair (a same-shape batch): the kernel needs no index
    idx = shape_idx.to(dev) if l_unique.shape[0] > 1 else None
    dihedral = torch.empty((b, 8, 32), dtype=torch.uint8, device=dev)
    quality = torch.empty((b,), dtype=torch.float32, device=dev)
    coeffs = torch.empty((b, 256), dtype=torch.float32, device=dev)
    lumas, lt, rt = _kernel_operands(lumas, l_unique, r_unique)
    _, hp, wp = lumas.shape
    _build.launch(
        pdq_hash, "pdq_hash_kernel", "rupp_pdq_hash", lumas,
        lumas.data_ptr(), b, hp, wp, lt.data_ptr(), rt.data_ptr(),
        0 if idx is None else idx.data_ptr(), d16.data_ptr(),
        dihedral.data_ptr(), quality.data_ptr(), coeffs.data_ptr())
    return {"hash": dihedral[:, 0, :], "dihedral": dihedral,
            "quality": quality, "coeffs": coeffs}


pdq_hash.launches = 0

"""K2: the hybrid PDQ front half (csrc/pdq_coeffs.cu) and its plain
version.

Counterpart of rupphash_tpu/ops/pdq_pallas.py's hybrid path
(`_split3`, `_coeffs_kernel`, `_build_hybrid`, `pdq_hash_batch_hybrid`).
The kernel maps u8 lumas to the 16x16 DCT coefficients and the quality;
the float32 row operator L rides along as three bf16 terms (`split3`)
so that the dominant product L . X runs on bf16 tensor cores while
keeping L's full mantissa.  The median, dihedral variants and packing
are pdq_torch.dihedral_from_coeffs, as the reference pairs its kernel
with pdq_jax.dihedral_from_coeffs.  Same output contract as
pdq_torch.pdq_hash_batch.
"""

from __future__ import annotations

import functools

import torch

from . import _build, pdq_torch

KERNEL_MAX_ROWS = 512   # csrc/pdq_coeffs.cu kMaxRows: L's terms fit in shared memory


def split3(a: torch.Tensor):
    """float32 tensor -> three bf16 terms with a1 + a2 + a3 carrying its
    full mantissa; each cast rounds to nearest even, as ml_dtypes does
    in the reference's _split3."""
    a = a.to(torch.float32)
    a1 = a.to(torch.bfloat16)
    r1 = a - a1.float()
    a2 = r1.to(torch.bfloat16)
    r2 = r1 - a2.float()
    return a1, a2, r2.to(torch.bfloat16)


@functools.lru_cache(maxsize=64)
def _host_operators(rows: int, cols: int):
    l_op, r_op = pdq_torch.linear_operators(rows, cols)
    l1, l2, l3 = split3(torch.from_numpy(l_op))
    return l1, l2, l3, torch.from_numpy(r_op)


def operators(rows: int, cols: int, dev) -> tuple:
    """(l1, l2, l3 (64, rows) bf16, r (64, cols) f32, d16 (16, 64) f32)
    on dev."""
    l1, l2, l3, r_op = _host_operators(rows, cols)
    d16 = torch.from_numpy(pdq_torch.dct16x64())
    return tuple(t.to(dev) for t in (l1, l2, l3, r_op, d16))


def pdq_coeffs_plain(lumas, l1, l2, l3, r_op, d16):
    """Plain PyTorch version of K2: the three split products in float32
    matmuls (each bf16 x bf16 product is exact in float32), then the
    rest in float32.  Returns (coeffs (B, 256) f32, quality (B,) f32)."""
    x = lumas.to(torch.float32)
    t1 = ((torch.matmul(l1.float(), x) + torch.matmul(l2.float(), x))
          + torch.matmul(l3.float(), x))                          # (B,64,cols)
    buf64 = torch.matmul(t1, r_op.T)                              # (B,64,64)
    quality = pdq_torch.quality_from_buffer(buf64)
    coeffs = d16 @ (buf64 @ d16.T)
    return coeffs.reshape(-1, 256), quality


def _check(lumas, l1, l2, l3, r_op, d16):
    if lumas.dtype != torch.uint8 or lumas.dim() != 3:
        raise ValueError(f"lumas must be (B, rows, cols) uint8, got "
                         f"{tuple(lumas.shape)} {lumas.dtype}")
    _, rows, cols = lumas.shape
    if rows < 1 or cols < 1:
        raise ValueError(f"empty plane {rows}x{cols}")
    expect = {"l1": (l1, (64, rows), torch.bfloat16),
              "l2": (l2, (64, rows), torch.bfloat16),
              "l3": (l3, (64, rows), torch.bfloat16),
              "r_op": (r_op, (64, cols), torch.float32),
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


def pdq_coeffs(lumas, l1, l2, l3, r_op, d16):
    """lumas (B, rows, cols) u8; l1..l3 (64, rows) bf16 (split3 of L);
    r_op (64, cols) f32; d16 (16, 64) f32 -> (coeffs (B, 256) f32,
    quality (B,) f32).  CUDA tensors launch K2; CPU tensors take the
    plain version."""
    _check(lumas, l1, l2, l3, r_op, d16)
    if not lumas.is_cuda:
        return pdq_coeffs_plain(lumas, l1, l2, l3, r_op, d16)
    b, rows, cols = lumas.shape
    if rows > KERNEL_MAX_ROWS:
        raise ValueError(f"K2 takes at most {KERNEL_MAX_ROWS} rows, got {rows}")
    coeffs = torch.empty((b, 256), dtype=torch.float32, device=lumas.device)
    quality = torch.empty((b,), dtype=torch.float32, device=lumas.device)
    err = _build.load().lib.rupp_pdq_coeffs(
        lumas.data_ptr(), b, rows, cols, l1.data_ptr(), l2.data_ptr(),
        l3.data_ptr(), r_op.data_ptr(), d16.data_ptr(), coeffs.data_ptr(),
        quality.data_ptr(), _build.stream_ptr(lumas))
    _build.check(err, "pdq_coeffs_kernel")
    _build.count_launch(pdq_coeffs)
    return coeffs, quality


pdq_coeffs.launches = 0


def _finish(coeffs, quality) -> dict:
    dihedral = pdq_torch.dihedral_from_coeffs(coeffs.reshape(-1, 16, 16))
    return {"hash": dihedral[:, 0, :], "dihedral": dihedral,
            "quality": quality, "coeffs": coeffs}


def pdq_hash_batch_hybrid_plain(lumas) -> dict:
    """pdq_hash_batch_hybrid through the plain version of K2, on the
    tensor's device (numpy goes to the port's device)."""
    planes = pdq_torch._as_device_u8(lumas)
    _, rows, cols = planes.shape
    return _finish(*pdq_coeffs_plain(planes,
                                     *operators(rows, cols, planes.device)))


def pdq_hash_batch_hybrid(lumas) -> dict:
    """Hash a batch of same-shape u8 luma planes (B, rows, cols), numpy
    (moved to the port's device) or a tensor (hashed where it lies):
    K2's coefficients and quality, then the dihedral epilogue.  Same
    output contract as pdq_torch.pdq_hash_batch.  The kernel takes any
    batch size, so nothing is padded."""
    planes = pdq_torch._as_device_u8(lumas)
    _, rows, cols = planes.shape
    return _finish(*pdq_coeffs(planes, *operators(rows, cols, planes.device)))

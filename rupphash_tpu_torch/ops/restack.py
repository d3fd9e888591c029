"""K5: the column restack kernel (csrc/restack.cu) and its plain version.

Counterpart of the Pallas kernel in rupphash_tpu/tools/mosaic_repro.py
(`build`): a (1, rows, S * W) float32 block becomes (S * rows, W), with
output block s holding input columns [s * W, (s + 1) * W).  The TPU
tool exists because its compiler aborted on widths that are not a
multiple of 128 lanes; tools/mosaic_repro.py drives this port at the
same widths.
"""

from __future__ import annotations

import torch

from . import _build


def restack_plain(x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    slices = x.shape[2] // width
    return torch.cat([x[0, :, s * width:(s + 1) * width]
                      for s in range(slices)], dim=0)


def restack(x: torch.Tensor, width: int) -> torch.Tensor:
    """x (1, rows, S * width) float32 -> (S * rows, width) float32.  CUDA
    tensors launch K5; CPU tensors take the plain version."""
    if (x.dim() != 3 or x.shape[0] != 1 or x.dtype != torch.float32
            or width < 1 or x.shape[2] % width):
        raise ValueError(f"x must be (1, rows, S*{width}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return restack_plain(x, width)
    if not x.is_contiguous():
        raise ValueError("K5 takes a contiguous tensor")
    rows, slices = x.shape[1], x.shape[2] // width
    out = torch.empty((slices * rows, width), dtype=torch.float32,
                      device=x.device)
    _build.launch(restack, "restack_kernel", "rupp_restack", x, x.data_ptr(),
                  rows, slices, width, out.data_ptr())
    return out


restack.launches = 0

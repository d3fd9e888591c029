"""Device policy of the port: one device per process, chosen once.

cuda when PyTorch sees a card, else cpu.  The choice is announced on
stderr.  The float32 flags are set explicitly on the first call: PDQ
hashes must stay bit-exact, so no TF32 anywhere (cuDNN's default allows
it) and full-precision float32 matmuls for the plain versions that the
kernels are checked against.
"""

from __future__ import annotations

import functools

import torch

from rupphash_tpu.utils import trace


def set_precision_flags():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@functools.cache
def get() -> torch.device:
    set_precision_flags()
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        trace.tag("DEVICE", f"cuda ({torch.cuda.get_device_name(dev)})")
    else:
        dev = torch.device("cpu")
        trace.tag("DEVICE", "cpu (no CUDA device visible to PyTorch)")
    return dev


def precision_flags() -> dict:
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}

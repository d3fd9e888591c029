"""Device policy of the port: one device per process, chosen once.

cuda when PyTorch sees a card, else cpu, unless a tool pinned the
choice first (`pin`, e.g. a self-test told to validate the CPU path on
a machine with a card).  The choice is announced on stderr.  The float32 flags are set explicitly on the first call: PDQ
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


_PINNED: list[str] = []   # at most one entry, written by pin() before get()


@functools.cache
def get() -> torch.device:
    set_precision_flags()
    if _PINNED == ["cpu"]:
        dev = torch.device("cpu")
        trace.tag("DEVICE", "cpu (pinned)")
    elif torch.cuda.is_available():
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


def pin(kind: str) -> torch.device:
    """Fix the process's device type ("cuda" or "cpu") before its first
    use; raises if get() already chose another, or if "cuda" is asked
    for without a card."""
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unknown device type {kind!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible to PyTorch")
    if get.cache_info().currsize == 0 and not _PINNED:
        _PINNED.append(kind)
    dev = get()
    if dev.type != kind:
        raise RuntimeError(f"the process already runs on {dev}, not {kind}")
    return dev

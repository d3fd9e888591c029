"""Command-line tools of the port: the hardware self-test and the two
kernel probes carried over from the JAX package (mosaic_repro,
prof_nz).  Each validates the card, so without one it exits 3 unless
told to run the plain versions on the CPU (--device cpu)."""

from __future__ import annotations

import sys


def kernel_launches() -> dict[str, int]:
    """Launch count of every kernel wrapper of the port, by kernel name."""
    from ..ops import hamming_cuda, pdq_cuda, pdq_hybrid, restack

    return {"pdq_hash_kernel": pdq_cuda.pdq_hash.launches,
            "pdq_coeffs_kernel": pdq_hybrid.pdq_coeffs.launches,
            "hamming_rowcount_kernel": hamming_cuda.scan_row_counts.launches,
            "hamming_extract_kernel":
                hamming_cuda.extract_rows_packed.launches,
            "restack_kernel": restack.restack.launches,
            "hamming_rowcount_mma_kernel":
                hamming_cuda.scan_row_counts_pm1.launches}


def launches_line(names) -> str:
    """'kernels: name=count ...' for the named kernels."""
    counts = kernel_launches()
    return "kernels: " + " ".join(f"{k}={counts[k]}" for k in names)


def pick_device(requested: str | None, tool: str):
    """The device a tool runs on: the card, or the CPU when requested.
    Returns None (after saying why on stderr) when no card is visible
    and the CPU was not requested; the tool then exits 3."""
    import torch

    from .. import device

    if requested == "cpu":
        return device.pin("cpu")
    if not torch.cuda.is_available():
        print(f"FAIL: no CUDA device visible to PyTorch: {tool} validates "
              "the card and does not fall back to the CPU (pass --device "
              "cpu to validate the plain CPU path)", file=sys.stderr)
        return None
    return device.pin("cuda")

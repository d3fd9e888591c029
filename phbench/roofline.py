"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and
the least time each measured piece of work could take on it.

A share of a roofline is that least time over the measured time.  The
least time is the larger of the operations over their peak rate and the
bytes over the HBM bandwidth, each input byte read once and each output
byte written once.  The peaks assume the card's full 700 W power limit;
the harness prints the card's own limit beside them.
"""

from __future__ import annotations

# dense rates, NVIDIA's data sheet for the SXM part
FP32_FLOPS = 67e12       # float32 outside the tensor cores
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12      # bytes/s

PEAKS = {"fp32_flops": FP32_FLOPS, "bf16_flops": BF16_FLOPS,
         "int8_ops": INT8_OPS, "hbm_bytes_per_s": HBM_BYTES,
         "power_w": 700.0}


def bound(ops_s: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations'
    time at their peak rate and the bytes moved once over HBM."""
    bytes_s = nbytes / HBM_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def sweep_bound(n: int, v: int, nbits: int, in_bytes: float) -> dict:
    """The count sweep (K3): every pair j > i < n, all v variants, a +/-1
    dot of nbits (2 * nbits int8 operations); the hashes read once, one
    count a row written."""
    return bound(n * (n - 1) / 2 * v * 2 * nbits / INT8_OPS,
                 in_bytes + 8 * n)


def extract_bound(n: int, hot_rows, v: int, nbits: int) -> dict:
    """The hot-row extraction (K4): each hot row i against its later rows
    (n - 1 - i of them), all v variants, 2 * nbits int8 operations a dot;
    the hot rows' variants and the base read once, one bit a pair
    written."""
    later = sum(n - 1 - int(i) for i in hot_rows)
    nbytes = len(hot_rows) * v * nbits / 8 + n * nbits / 8 + later / 8
    return bound(later * v * 2 * nbits / INT8_OPS, nbytes)


def corpus_query_bound(rows: int, v: int, nbits: int) -> dict:
    """One corpus query: v variants of one hash against every row, a +/-1
    dot of nbits each as int8; the packed rows and their one-byte status
    read once."""
    return bound(rows * v * 2 * nbits / INT8_OPS, rows * (nbits / 8 + 1))

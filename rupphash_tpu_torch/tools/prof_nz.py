"""Two A/B probes of the edge search, on the card.

Run on a machine with a CUDA card:

    python -m rupphash_tpu_torch.tools.prof_nz [--device cpu]

Counterpart of the JAX package's root script _prof_nz.py:
  part 1: flat vs hierarchical (block-first) nonzero compaction over a
          (1024, 125056) u8 match mask with ~1,500 scattered nonzero
          bytes, in plain PyTorch; the index sets must be equal;
  part 2: the all-pairs count sweep at N=200,000 hashes, sim 31, as K3
          (XOR + popcount on packed words, the reference's "transpose"
          kernel) and as K6 (+/-1 int8 tensor-core dots contracting the
          base tile on its last dimension, the reference's
          "dot_general" kernel); the counts must be equal, and equal to
          K6's plain version (a float32 +/-1 matmul, untimed).
Times are host clock around synchronized runs, best of 3.  Exits 1 if
a comparison fails; without a card it exits 3 unless --device cpu is
given, which runs the plain versions and part 2 at N=3,000.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import launches_line, pick_device

MPAD, STRIDE = 1024, 125056
KPAD = 4096
SWEEP_N = {"cuda": 200_000, "cpu": 3_000}   # the plain sweep is O(N^2) on the CPU


def _timed(label, fn, sync, reps=3):
    out = fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    print(f"{label}: {min(ts) * 1000:.1f} ms "
          f"(runs {[round(x * 1000, 1) for x in ts]})")
    return out


def _padded(idx, vals, kpad):
    import torch

    k = min(len(idx), kpad)
    out_i = torch.full((kpad,), -1, dtype=torch.int64, device=idx.device)
    out_v = torch.zeros((kpad,), dtype=torch.uint8, device=idx.device)
    out_i[:k] = idx[:k]
    out_v[:k] = vals[:k]
    return out_i, out_v


def flat_nonzero(packed, kpad):
    """(positions, values) of the first kpad nonzero bytes, -1 padded."""
    import torch

    flat = packed.reshape(-1)
    (idx,) = torch.nonzero(flat, as_tuple=True)
    return _padded(idx, flat[idx], kpad)


def hier_nonzero(packed, kpad, blk=1024):
    """flat_nonzero in two steps: find the nonzero blocks of blk bytes,
    then the nonzero bytes inside those blocks only."""
    import torch

    flat = packed.reshape(-1)
    nb = flat.shape[0] // blk
    blocks = flat[:nb * blk].view(nb, blk)
    (bidx,) = torch.nonzero(blocks.amax(dim=1), as_tuple=True)
    bidx = bidx[:min(kpad, nb)]
    sub = blocks[bidx].reshape(-1)
    (sidx,) = torch.nonzero(sub, as_tuple=True)
    return _padded(bidx[sidx // blk] * blk + sidx % blk, sub[sidx], kpad)


def part1(dev, sync) -> bool:
    import torch

    rng = np.random.default_rng(0)
    mask = np.zeros((MPAD, STRIDE), dtype=np.uint8)
    rr = rng.integers(0, MPAD, 1500)
    cc = rng.integers(0, STRIDE, 1500)
    mask[rr, cc] = rng.integers(1, 256, 1500).astype(np.uint8)
    mask_d = torch.from_numpy(mask).to(dev)
    i1, _ = _timed("flat_nonzero", lambda: flat_nonzero(mask_d, KPAD), sync)
    sets = []
    for blk in (256, 1024, 4096):
        i2, _ = _timed(f"hier_nonzero blk={blk}",
                       lambda b=blk: hier_nonzero(mask_d, KPAD, b), sync)
        sets.append(set(i2[i2 >= 0].tolist()))
    sa = set(i1[i1 >= 0].tolist())
    equal = all(s == sa for s in sets)
    print("equal sets:", equal, len(sa))
    return equal


def part2(dev, sync, n) -> bool:
    import torch

    from ..ops import hamming, hamming_cuda

    npad = -(-n // hamming_cuda.ROW_ALIGN) * hamming_cuda.ROW_ALIGN
    gen = torch.Generator(device=dev).manual_seed(2)
    packed = torch.randint(0, 256, (8, npad, 32), generator=gen,
                           dtype=torch.uint8, device=dev)
    # planted duplicates: base row j takes query variant v of row i < j
    rng = np.random.default_rng(2)
    pairs = np.sort(rng.choice(n, (64, 2), replace=False), axis=1)
    for k, (i, j) in enumerate(pairs.tolist()):
        packed[0, j] = packed[k % 8, i]
    pm1 = hamming.unpack_bits_pm1(packed).contiguous()
    low = torch.zeros((npad, 1), dtype=torch.int32, device=dev)
    label = f"{n // 1000}k" if n % 1000 == 0 else str(n)
    c_ref = _timed(f"sweep {label} transpose (K3 popcount)",
                   lambda: hamming_cuda.scan_row_counts(
                       packed, low, sim=31, n_total=n), sync)
    c_mma = _timed(f"sweep {label} dot_general (K6 int8 mma)",
                   lambda: hamming_cuda.scan_row_counts_pm1(
                       pm1, low, sim=31, n_total=n), sync)
    c_plain = hamming_cuda.scan_row_counts_pm1_plain(pm1, low, sim=31,
                                                     n_total=n)
    equal = torch.equal(c_ref, c_mma)
    plain_equal = torch.equal(c_mma, c_plain)
    print("counts equal:", equal, "matches:", int(c_ref.sum()))
    print("K6 counts equal to its plain version:", plain_equal)
    return equal and plain_equal and int(c_ref.sum()) >= len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rupphash_tpu_torch.tools.prof_nz",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="cpu runs the plain versions; default: the card")
    args = ap.parse_args(argv)
    dev = pick_device(args.device, "prof_nz")
    if dev is None:
        return 3

    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    print(f"device={dev}")
    ok = part1(dev, sync)
    ok &= part2(dev, sync, SWEEP_N[dev.type])
    print(launches_line(("hamming_rowcount_kernel",
                         "hamming_rowcount_mma_kernel")))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

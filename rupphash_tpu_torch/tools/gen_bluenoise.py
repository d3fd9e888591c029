"""Build-time generator for the shipped 256x256 blue-noise rank tile.

The reference ships a pre-baked 65536-byte tile
(assets/blue-noise-256.bin, consumed by hdr.rs:712-742); we generate our
own with Ulichney's void-and-cluster method (the same algorithm class)
and ship the rank matrix as a u16 .npy so `pipeline.hdr.blue_noise_tile`
can load it instead of paying the ~1-2 min generation cost per process.

Run:  python -m rupphash_tpu_torch.tools.gen_bluenoise
Writes: rupphash_tpu_torch/assets/blue-noise-256.npy (u16 ranks, row-major)
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def generate_rank_tile(side: int, sigma: float = 1.9,
                       seed: int = 0x9E3779B9,
                       progress: bool = False) -> np.ndarray:
    """Void-and-cluster rank matrix (each rank 0..side^2-1 exactly once).

    Same algorithm as pipeline.hdr.blue_noise_tile but standalone so the
    asset can be regenerated offline at any size; sigma 1.9 is
    Ulichney's published choice for large tiles.
    """
    n = side * side
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    d = np.minimum(yy, side - yy) ** 2 + np.minimum(xx, side - xx) ** 2
    kernel = np.exp(-d / (2.0 * sigma ** 2))

    rng = np.random.default_rng(seed)
    binary = np.zeros((side, side), dtype=bool)
    energy = np.zeros((side, side), dtype=np.float64)

    def splat(y, x, sign):
        energy[:] += sign * np.roll(np.roll(kernel, y, 0), x, 1)

    t0 = time.monotonic()
    seeds = rng.choice(n, size=n // 10, replace=False)
    for s in seeds:
        binary[s // side, s % side] = True
        splat(s // side, s % side, +1)
    # relax: move tightest-cluster point into largest void until stable
    for it in range(n):
        masked = np.where(binary, energy, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), energy.shape)
        binary[cy, cx] = False
        splat(cy, cx, -1)
        masked = np.where(binary, np.inf, energy)
        vy, vx = np.unravel_index(np.argmin(masked), energy.shape)
        if (vy, vx) == (cy, cx):
            binary[cy, cx] = True
            splat(cy, cx, +1)
            break
        binary[vy, vx] = True
        splat(vy, vx, +1)
        if progress and it % 512 == 0:
            print(f"  relax it={it} t={time.monotonic()-t0:.0f}s",
                  file=sys.stderr)

    rank = np.zeros((side, side), dtype=np.int64)
    work = binary.copy()
    e1 = energy.copy()
    k = int(work.sum())
    for r in range(k - 1, -1, -1):
        masked = np.where(work, e1, -np.inf)
        cy, cx = np.unravel_index(np.argmax(masked), e1.shape)
        work[cy, cx] = False
        e1 -= np.roll(np.roll(kernel, cy, 0), cx, 1)
        rank[cy, cx] = r
    if progress:
        print(f"  phase1 done t={time.monotonic()-t0:.0f}s",
              file=sys.stderr)
    work = binary.copy()
    e2 = energy.copy()
    for r in range(k, n):
        masked = np.where(work, np.inf, e2)
        vy, vx = np.unravel_index(np.argmin(masked), e2.shape)
        work[vy, vx] = True
        e2 += np.roll(np.roll(kernel, vy, 0), vx, 1)
        rank[vy, vx] = r
        if progress and r % 4096 == 0:
            print(f"  fill r={r}/{n} t={time.monotonic()-t0:.0f}s",
                  file=sys.stderr)
    assert len(np.unique(rank)) == n
    return rank


def main():
    side = 256
    out = Path(__file__).resolve().parents[1] / "assets" / \
        f"blue-noise-{side}.npy"
    out.parent.mkdir(exist_ok=True)
    rank = generate_rank_tile(side, progress=True)
    np.save(out, rank.astype(np.uint16))
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

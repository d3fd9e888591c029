"""The library generator: a photo library of PDQ-hashed files from a
configuration, a traffic mix's cluster patterns and a seed.

Every file has a random 256-bit hash with 8 random variants (slot 0 is the
hash), as chip_smoke.py's planted_hashes has them.  Each pattern of the
traffic file plants clusters at random rows:

  clusters         number of clusters
  members          [lo, hi]: members a cluster, the first is its seed row
  flips            [lo, hi]: bits a non-seed member's hash differs from the
                   seed's hash by
  exact_every      every k-th member is an exact copy (same hash, variants
                   and content hash) of the seed; 0 for none
  twin_variant_every  every k-th cluster's second member's hash is one of
                   the seed's variants 1-7 (a dihedral twin, such as a
                   rotated export) instead of a flipped copy
  low              every member is low quality (quality 20)
  low_exact_first  the second member is an exact copy (the low pair)
  stem_twin_every  every k-th cluster's second member is the seed's RAW
                   twin: same directory and stem, a raw extension
  stem_link_every  every k-th cluster's seed is the RAW twin of the
                   previous cluster's seed, so the two groups merge by stem

Sizes, flips and members are the same multiset for every seed (they cycle
through their ranges); the seed draws the rows, the bits and the hashes.
Paths look like a camera library: /library/<yyyy>/<mm>/IMG_nnnnn.JPG.
"""

from __future__ import annotations

import numpy as np

RAW_EXTS = (".NEF", ".CR3")


def _cycle(lo: int, hi: int, k: int) -> int:
    return lo + k % (hi - lo + 1)


def _flip(rng, h: np.ndarray, nbits: int) -> np.ndarray:
    out = h.copy()
    for p in rng.choice(h.size * 8, nbits, replace=False):
        out[p // 8] ^= np.uint8(1 << (p % 8))
    return out


def generate(n: int, patterns: list, seed: int):
    """dict of host arrays for n files: var (n, 8, 32) u8, quality (n,)
    int32, content (n,) int64 content ids, dirs (n,) int32, names (n,)
    str, exts (n,) str."""
    rng = np.random.default_rng(seed)
    var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    quality = rng.integers(50, 101, n).astype(np.int32)
    content = np.arange(n, dtype=np.int64)
    # a directory a month over 20 years, files in row order
    months = 20 * 12
    dirs = (np.arange(n, dtype=np.int64) * months // max(n, 1)).astype(
        np.int32)
    stems = np.array([f"IMG_{i % 100000:05d}" for i in range(n)], dtype=object)
    exts = np.full(n, ".JPG", dtype=object)

    sizes = [[_cycle(*p["members"], c) for c in range(p["clusters"])]
             for p in patterns]
    total = sum(sum(s) for s in sizes)
    if total > n:
        raise ValueError(f"patterns plant {total} rows, the library has {n}")
    free = iter(rng.permutation(n).tolist())
    prev_seed = None
    for p, psizes in zip(patterns, sizes):
        flo, fhi = p.get("flips", [0, 0])
        exact_every = p.get("exact_every", 0)
        twin_every = p.get("twin_variant_every", 0)
        for c, size in enumerate(psizes):
            rows = [next(free) for _ in range(size)]
            s = rows[0]
            link = p.get("stem_link_every", 0)
            if link and c % link == link - 1 and prev_seed is not None:
                dirs[s], stems[s] = dirs[prev_seed], stems[prev_seed]
                exts[s] = RAW_EXTS[c % 2]
            prev_seed = s
            for m, r in enumerate(rows[1:], start=1):
                if exact_every and m % exact_every == 0 or (
                        m == 1 and p.get("low_exact_first")):
                    var[r] = var[s]
                    content[r] = content[s]
                elif m == 1 and twin_every and (
                        c % twin_every == twin_every - 1):
                    var[r, 0] = var[s, 1 + (c % 7)]
                else:
                    k = c * 7 + m
                    var[r, 0] = _flip(rng, var[s, 0], _cycle(flo, fhi, k))
            twin = p.get("stem_twin_every", 0)
            if twin and size > 1 and c % twin == twin - 1:
                r = rows[1]
                dirs[r], stems[r] = dirs[s], stems[s]
                exts[r] = RAW_EXTS[c % 2]
            if p.get("low"):
                quality[rows] = 20
    return {"var": var, "quality": quality, "content": content,
            "dirs": dirs, "stems": stems, "exts": exts}


def paths(lib: dict, root: str = "/library") -> list[str]:
    dirs, stems, exts = lib["dirs"], lib["stems"], lib["exts"]
    return [f"{root}/{2005 + int(d) // 12}/{int(d) % 12 + 1:02d}/{st}{ex}"
            for d, st, ex in zip(dirs.tolist(), stems.tolist(),
                                 exts.tolist())]


def content_hash(cid: int, seed: int) -> bytes:
    """A 16-byte stand-in for the keyed blake2b of a file's bytes."""
    return int(cid).to_bytes(8, "little") + (seed & (2**64 - 1)).to_bytes(
        8, "little")

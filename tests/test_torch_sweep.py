"""The tile walk of the count sweep K3 (csrc/hamming.cu): the work items
and base tiles its blocks visit, as ops/hamming_cuda.py builds them, and
the counts that walk gives, held against the plain version, the port's
brute_force_edges and the JAX package's find_edges.  The kernel itself
runs only on a card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

from rupphash_tpu.ops import hamming as jhamming
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import hamming, hamming_cuda

QROWS = hamming_cuda.SWEEP_QROWS
BROWS = hamming_cuda.SWEEP_BROWS


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _hashes(n, v, nbytes, seed):
    """Random hashes with planted exact, near and dihedral pairs across
    tile edges, and low-confidence rows; variant slot 0 is the hash."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    variants = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    if n > 1:
        pairs = rng.integers(0, n, (max(1, n // 40), 2))
        for k, (i, j) in enumerate(pairs):
            base[j] = base[i]
            if k % 3 == 1:
                for p in rng.choice(nbytes * 8, k % (nbytes * 2) + 1,
                                    replace=False):
                    base[j, p // 8] ^= np.uint8(1 << (p % 8))
            if k % 7 == 3:
                low[[i, j]] = True
        for i in (63, 64, 127, 128, 1023, 1024):
            if i + 1 < n:
                base[i + 1] = base[i]
        if v > 1 and n > 3:
            variants[1, v - 1] = base[n - 1]
    variants[:, 0] = base
    return base, variants, low


def _walk_counts(var_bits, low_i32, sim, n):
    """Per-row counts from the kernel's own walk: every (query tile,
    base tile) that sweep_tiles lists, the +/-1 dots of all variants
    against base slot 0, max over variants, the threshold, j > i, j < n.
    Also returns how often each pair was visited."""
    v, npad, nbytes = var_bits.shape
    nbits = nbytes * 8
    pm1 = np.unpackbits(var_bits.numpy(), axis=-1,
                        bitorder="little").astype(np.float32) * 2 - 1
    low = low_i32.numpy()[:, 0] != 0
    counts = np.zeros(npad, dtype=np.int64)
    visits = np.zeros((npad, npad), dtype=np.int8) if npad <= 4096 else None
    for q0, b0, _ in hamming_cuda.sweep_tiles(
            hamming_cuda.sweep_items(n, npad)):
        best = (pm1[:, q0:q0 + QROWS] @ pm1[0, b0:b0 + BROWS].T).max(0)
        i = np.arange(q0, q0 + QROWS)[:, None]
        j = np.arange(b0, b0 + BROWS)[None]
        need = np.where(low[q0:q0 + QROWS, None] | low[None, b0:b0 + BROWS],
                        nbits, nbits - 2 * sim)
        live = (j > i) & (j < n)
        counts[q0:q0 + QROWS] += ((best >= need) & live).sum(1)
        if visits is not None:
            visits[q0:q0 + QROWS, b0:b0 + BROWS] += live
    return counts, visits


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1023, 1025, 3000, 9000,
                               100_000])
def test_items_cover_each_pair_once(n):
    """Items cover exactly the pairs i < j < n: per query tile, runs of
    whole base tiles from the tile holding q0 + 1 to the tile holding
    n - 1, contiguous, never wholly on or below the diagonal, at most
    SWEEP_ITEM_TILES long; the two warpgroups split each run."""
    npad = hamming_cuda._pad_rows(n)
    items = hamming_cuda.sweep_items(n, npad)
    assert items.dtype == np.int32 and items.shape[1:] == (4,)
    if n < 2:
        assert len(items) == 0
        return
    q0s = np.unique(items[:, 0])
    assert np.array_equal(q0s, np.arange(0, n - 1, QROWS))
    last = -(-n // BROWS) * BROWS
    per_row = np.zeros(n, dtype=np.int64)
    for q0 in q0s:
        runs = items[items[:, 0] == q0]
        assert runs[0, 1] == (q0 + 1) // BROWS * BROWS
        assert np.array_equal(runs[1:, 1], runs[:-1, 2])   # contiguous
        assert runs[-1, 2] == last
        assert (runs[:, 1] % BROWS == 0).all()
        lens = runs[:, 2] - runs[:, 1]
        assert (lens > 0).all()
        assert (lens <= BROWS * hamming_cuda.SWEEP_ITEM_TILES).all()
        assert (runs[:, 1] + BROWS - 1 > q0).all()         # above the diagonal
        rows = np.arange(q0, min(q0 + QROWS, n))
        lo = np.maximum(runs[None, :, 1], rows[:, None] + 1)
        hi = np.minimum(runs[None, :, 2], n)
        per_row[rows] += np.maximum(hi - lo, 0).sum(1)
    assert np.array_equal(per_row, n - 1 - np.arange(n))
    if len(items) <= 2000:
        tiles = list(hamming_cuda.sweep_tiles(items))
        assert len(set((q, b) for q, b, _ in tiles)) == len(tiles)
        for q0, b_begin, b_end, _ in items.tolist():
            for g in range(hamming_cuda.SWEEP_GROUPS):
                mine = [b for q, b, gg in tiles if gg == g and q == q0
                        and b_begin <= b < b_end]
                assert mine == list(range(b_begin + g * BROWS, b_end,
                                          hamming_cuda.SWEEP_GROUPS * BROWS))


@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
@pytest.mark.parametrize("n", [1, 1023, 1025, 3000])
def test_walk_counts_equal_plain_and_oracles(n, v, nbytes):
    sim = 40 if nbytes == 32 else 10
    base, variants, low = _hashes(n, v, nbytes, seed=n * 10 + v + nbytes)
    var_bits, low_t, n2, npad = hamming_cuda.prepare_inputs(base, variants,
                                                            low)
    counts, visits = _walk_counts(var_bits, low_t, sim, n)
    plain = hamming_cuda.scan_row_counts(var_bits, low_t, sim=sim, n_total=n)
    assert np.array_equal(counts, plain.numpy()[:, 0])
    if visits is not None:
        iu = np.triu(np.ones((npad, npad), dtype=bool), 1)
        iu[n:] = False
        iu[:, n:] = False
        assert np.array_equal(visits, iu.astype(np.int8))
    ref = jhamming.find_edges(base, variants, low, similarity=sim)
    assert np.array_equal(counts[:n], np.bincount(ref[0], minlength=n))
    if n <= 1025:
        ei, ej = hamming.brute_force_edges(base, variants, low,
                                           similarity=sim)
        assert np.array_equal(counts[:n], np.bincount(ei, minlength=n))
        assert set(zip(ei.tolist(), ej.tolist())) == set(
            zip(ref[0].tolist(), ref[1].tolist()))
    assert counts[:n].sum() > 0 or n < 2

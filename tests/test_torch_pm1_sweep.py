"""The tile walk of the int8 count sweep K6 (csrc/hamming_mma.cu): the
work items its blocks take and the 16 x 64 tiles its warps compute, as
ops/hamming_cuda.py lists them, and the counts that walk gives, held
against K6's and K3's plain versions, the port's brute_force_edges and
the JAX package's count sweep in interpret mode.  The kernel itself runs
only on a card (tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest
import torch

from rupphash_tpu.ops import hamming_pallas
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import hamming, hamming_cuda

COLS = hamming_cuda.PM1_COLS
WCOLS = hamming_cuda.PM1_WARP_COLS
QROWS = hamming_cuda.PM1_QROWS


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _hashes(n, v, nbytes, seed):
    """Random hashes with planted exact, near and variant pairs across
    the edges of K6's tiles, and low-confidence rows; slot 0 is the hash."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    variants = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    if n > 1:
        for k, (i, j) in enumerate(rng.integers(0, n, (max(1, n // 40), 2))):
            base[j] = base[i]
            if k % 3 == 1:
                for p in rng.choice(nbytes * 8, k % (nbytes * 2) + 1,
                                    replace=False):
                    base[j, p // 8] ^= np.uint8(1 << (p % 8))
            if k % 7 == 3:
                low[[i, j]] = True
        for i in (15, 16, 63, 64, 127, 128, 511, 512, 1023, 1024, 2047, 2048):
            if i + 1 < n:
                base[i + 1] = base[i]
        if n > 600:
            base[n - 1] = base[0]              # first row, last column block
        if v > 1 and n > 3:
            variants[1, v - 1] = base[n - 1]
    variants[:, 0] = base
    return base, variants, low


def _walk_counts(var_pm1, low_i32, sim, n):
    """Per-row counts from the kernel's own walk: every tile that
    pm1_sweep_tiles lists, the +/-1 dots of all variants against base slot
    0, the largest over variants, the threshold, j > i and j < n.  Also
    returns how often each pair was visited."""
    v, npad, nbits = var_pm1.shape
    pm1 = var_pm1.numpy().astype(np.float32)
    low = low_i32.numpy()[:, 0] != 0
    counts = np.zeros(npad, dtype=np.int64)
    visits = np.zeros((npad, npad), dtype=np.int8) if npad <= 4096 else None
    items = hamming_cuda.pm1_sweep_items(n, npad)
    for q0, w0 in hamming_cuda.pm1_sweep_tiles(items, n, npad):
        best = (pm1[:, q0:q0 + 16] @ pm1[0, w0:w0 + WCOLS].T).max(0)
        i = np.arange(q0, q0 + 16)[:, None]
        j = np.arange(w0, w0 + WCOLS)[None]
        need = np.where(low[q0:q0 + 16, None] | low[None, w0:w0 + WCOLS],
                        nbits, nbits - 2 * sim)
        live = (j > i) & (j < n)
        assert live.any()                   # no tile is swept for nothing
        counts[q0:q0 + 16] += ((best >= need) & live).sum(1)
        if visits is not None:
            visits[q0:q0 + 16, w0:w0 + WCOLS] += live
    return counts, visits


@pytest.mark.parametrize("n", [1, 2, 17, 127, 128, 129, 511, 512, 513, 1023,
                               1025, 2049, 3000, 9000, 100_000])
def test_pm1_items_cover_each_pair_once(n):
    """Items cover exactly the pairs i < j < n: per column block of
    PM1_COLS base rows, contiguous query runs of whole granules from row
    0 to the end of the block or of the live rows, at most PM1_ITEM_ROWS
    long (PM1_TAIL_ROWS past 0.8 n), listed run-major."""
    npad = hamming_cuda._pad_rows(n)
    items = hamming_cuda.pm1_sweep_items(n, npad)
    assert items.dtype == np.int32 and items.shape[1:] == (4,)
    if n < 2:
        assert len(items) == 0
        return
    c0s = np.unique(items[:, 0])
    assert np.array_equal(c0s, np.arange(0, n, COLS))
    assert (items[:, 1] % QROWS == 0).all() and (items[:, 2] % QROWS == 0).all()
    assert (items[:, 2] <= npad).all() and (items[:, 0] + COLS <= npad).all()
    lens = items[:, 2] - items[:, 1]
    assert (lens > 0).all() and (lens <= hamming_cuda.PM1_ITEM_ROWS).all()
    late = items[:, 1] >= n * 4 // 5
    assert (lens[late] <= hamming_cuda.PM1_TAIL_ROWS).all()
    # run-major: the runs' first rows never decrease along the list
    assert (np.diff(items[:, 1]) >= 0).all()
    per_row = np.zeros(n, dtype=np.int64)
    for c0 in c0s:
        runs = items[items[:, 0] == c0]
        assert runs[0, 1] == 0
        assert np.array_equal(runs[1:, 1], runs[:-1, 2])      # contiguous
        assert runs[-1, 2] == min(c0 + COLS, -(-(n - 1) // QROWS) * QROWS)
        rows = np.arange(0, min(int(runs[-1, 2]), n))
        per_row[rows] += np.maximum(min(c0 + COLS, n)
                                    - np.maximum(c0, rows + 1), 0)
    assert np.array_equal(per_row, n - 1 - np.arange(n))
    if len(items) <= 200:
        tiles = list(hamming_cuda.pm1_sweep_tiles(items, n, npad))
        assert len(set(tiles)) == len(tiles)
        for q0, w0 in tiles:
            assert q0 % 16 == 0 and w0 % WCOLS == 0
            assert q0 < w0 + WCOLS - 1 and w0 < n and q0 < n


@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
@pytest.mark.parametrize("n", [1, 1023, 1025, 3000])
def test_pm1_walk_counts_equal_plain_and_oracles(n, v, nbytes):
    sim = 40 if nbytes == 32 else 10
    base, variants, low = _hashes(n, v, nbytes, seed=n * 10 + v + nbytes)
    var_bits, low_t, _, npad = hamming_cuda.prepare_inputs(base, variants,
                                                           low)
    var_pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    counts, visits = _walk_counts(var_pm1, low_t, sim, n)
    plain = hamming_cuda.scan_row_counts_pm1(var_pm1, low_t, sim=sim,
                                             n_total=n)
    assert np.array_equal(counts, plain.numpy()[:, 0])
    assert torch.equal(plain, hamming_cuda.scan_row_counts_plain(
        var_bits, low_t, sim=sim, n_total=n))
    assert hamming_cuda.scan_row_counts_pm1.launches == 0
    iu = np.triu(np.ones((npad, npad), dtype=bool), 1)
    iu[n:] = False
    iu[:, n:] = False
    assert np.array_equal(visits, iu.astype(np.int8))
    jpm1, jlow, _, _ = hamming_pallas.prepare_inputs(base, variants, low)
    want = np.asarray(hamming_pallas.scan_row_counts(
        jax.device_put(jpm1), jax.device_put(jlow), nbits=nbytes * 8,
        sim=sim, n_total=n, interpret=True))
    assert np.array_equal(counts[:n], want[:n, 0])
    if n <= 1025:
        ei, _ = hamming.brute_force_edges(base, variants, low, similarity=sim)
        assert np.array_equal(counts[:n], np.bincount(ei, minlength=n))
    assert counts[:n].sum() > 0 or n < 2


def test_k6_ablate_edits_match_the_source_and_the_tool_needs_a_card():
    """tools/k6_ablate.py takes parts out of a copy of the kernel's source
    by exact text: every edit must still find its text once."""
    from rupphash_tpu_torch.ops import _build
    from rupphash_tpu_torch.tools import k6_ablate

    source = (_build.CSRC / "hamming_mma.cu").read_text()
    for name, parts in k6_ablate.VARIANTS.items():
        assert (k6_ablate._without(source, *parts) == source) == (name == "shipped")
    with pytest.raises(RuntimeError):
        k6_ablate._without(source, ("no such text", ""))
    if not torch.cuda.is_available():
        assert k6_ablate.main([]) == 3

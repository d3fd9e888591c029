"""PyTorch Hamming edge search (plain CPU paths of K3 and K4) vs the JAX
package's Pallas kernels in interpret mode and the numpy oracle."""
import jax
import numpy as np
import pytest
import torch

from rupphash_tpu.ops import hamming as jhamming
from rupphash_tpu.ops import hamming_pallas
from rupphash_tpu_torch.ops import hamming, hamming_cuda


def _flip(h, positions):
    o = h.copy()
    for p in positions:
        o[p // 8] ^= 1 << (p % 8)
    return o


def _edge_set(ei, ej):
    return set(zip(np.asarray(ei).tolist(), np.asarray(ej).tolist()))


@pytest.fixture(scope="module")
def planted():
    """The JAX package's planted fixture (tests/test_hamming_pallas.py),
    plus low-confidence rows: one exact low pair, one near low pair."""
    rng = np.random.default_rng(0)
    n = 3000
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    base[100] = base[2500]
    base[7] = _flip(base[1800], range(12))
    variants = np.repeat(base[:, None, :], 8, axis=1)
    variants[55, 3] = _flip(base[2222], range(4))
    base[40] = base[2990]
    base[41] = _flip(base[2991], [3])
    variants[[40, 41], 0] = base[[40, 41]]
    low = np.zeros(n, dtype=bool)
    low[[40, 41, 2990, 2991]] = True
    return base, variants, low


@pytest.fixture(scope="module")
def oracle31(planted):
    base, variants, low = planted
    return jhamming.brute_force_edges(base, variants, low, similarity=31)


@pytest.mark.parametrize("sim", [31, 40])
def test_row_counts_equal_jax_kernel(planted, oracle31, sim):
    base, variants, low = planted
    var_pm1, low_j, n, npad = hamming_pallas.prepare_inputs(base, variants,
                                                            low)
    want = np.asarray(hamming_pallas.scan_row_counts(
        jax.device_put(var_pm1), jax.device_put(low_j), nbits=256, sim=sim,
        n_total=n, interpret=True))
    var_bits, low_t, n2, npad2 = hamming_cuda.prepare_inputs(base, variants,
                                                             low)
    assert (n2, npad2) == (n, npad)
    assert np.array_equal(low_t.numpy(), low_j)
    got = hamming_cuda.scan_row_counts(var_bits, low_t, sim=sim, n_total=n)
    assert got.dtype == torch.int32 and got.shape == (npad, 1)
    assert got.numpy().tobytes() == want.tobytes()
    if sim == 31:
        assert np.array_equal(got.numpy()[:n, 0],
                              np.bincount(oracle31[0], minlength=n))
    assert hamming_cuda.scan_row_counts.launches == 0


def test_extract_equal_jax_kernel(planted):
    base, variants, low = planted
    var_pm1, low_j, n, npad = hamming_pallas.prepare_inputs(base, variants,
                                                            low)
    var_bits, low_t, _, _ = hamming_cuda.prepare_inputs(base, variants, low)
    # hot rows, a few cold ones, and inert pad slots (row n-1, qidx n)
    rows = np.array([7, 55, 100, 40, 41, 0, 2999, 1500] + [n - 1] * 8)
    qidx = np.array(rows[:8].tolist() + [n] * 8, dtype=np.int32)[:, None]
    qlow = np.ones((16, 1), dtype=np.int32)
    qlow[:8, 0] = low[rows[:8]]
    want = np.asarray(hamming_pallas.extract_rows_packed(
        jax.device_put(var_pm1[:, rows]), jax.device_put(var_pm1[0]),
        jax.device_put(qlow), jax.device_put(low_j), jax.device_put(qidx),
        nbits=256, sim=31, n_total=n, interpret=True))
    got = hamming_cuda.extract_rows_packed(
        var_bits[:, torch.from_numpy(rows)], var_bits[0],
        torch.from_numpy(qlow), low_t, torch.from_numpy(qidx), sim=31,
        n_total=n)
    assert got.dtype == torch.uint8 and got.shape == (16, npad // 8)
    assert got.numpy().tobytes() == want.tobytes()
    assert got[8:].sum() == 0


def test_find_edges_match_oracle_and_jax(planted, oracle31):
    base, variants, low = planted
    oracle = _edge_set(*oracle31)
    assert (40, 2990) in oracle and (41, 2991) not in oracle
    jx = _edge_set(*jhamming.find_edges_fast(base, variants, low,
                                             similarity=31, interpret=True))
    fast = _edge_set(*hamming.find_edges_fast(base, variants, low,
                                              similarity=31))
    resident = _edge_set(*hamming.find_edges_fast_resident(
        torch.from_numpy(variants), low, similarity=31))
    assert fast == resident == jx == oracle


def test_low_conf_gate():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (1100, 32), dtype=np.uint8)
    base[10] = base[20]                      # exact pair, both low quality
    base[30] = _flip(base[40], [0, 9])       # distance-2 pair, low quality
    base[50] = _flip(base[60], [0, 9])       # distance-2 pair, one low
    base[70] = _flip(base[80], [0, 9])       # distance-2 pair, good quality
    low = np.zeros(1100, dtype=bool)
    low[[10, 20, 30, 40, 50]] = True
    es = _edge_set(*hamming.find_edges_fast(base, None, low, similarity=40))
    assert es == {(10, 20), (70, 80)}


def test_tile_boundaries_and_chunking():
    """Pairs straddling the 1024-row tiles and the plain versions'
    512/2048 tiles, the last real row, and more hot rows than one
    extraction chunk."""
    rng = np.random.default_rng(6)
    n = 2100
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    pairs = [(1023, 1024), (511, 512), (1024, 2047), (2047, 2048),
             (0, n - 1), (1535, 1536)]
    pairs += [(100 + 2 * k, 101 + 2 * k) for k in range(40)]
    for a, b in pairs:
        base[b] = _flip(base[a], range(a % 5))
    variants = np.repeat(base[:, None, :], 8, axis=1)
    oracle = _edge_set(*jhamming.brute_force_edges(base, variants,
                                                   similarity=8))
    assert set(pairs) <= oracle
    ei, ej, stats = hamming.find_edges_fast(base, variants, similarity=8,
                                            row_chunk=32, return_stats=True)
    assert _edge_set(ei, ej) == oracle
    assert stats["hot_rows"] == len({a for a, _ in oracle})


def test_empty_and_no_matches():
    ei, ej = hamming.find_edges_fast(np.empty((0, 32), dtype=np.uint8))
    assert len(ei) == 0 and len(ej) == 0
    ei, ej = hamming.find_edges_fast_resident(
        torch.empty((0, 8, 32), dtype=torch.uint8))
    assert len(ei) == 0 and len(ej) == 0
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (500, 32), dtype=np.uint8)
    ei, ej, stats = hamming.find_edges_fast(base, similarity=0,
                                            return_stats=True)
    assert len(ei) == 0 and stats["hot_rows"] == 0
    assert hamming_cuda.extract_rows_packed.launches == 0


def test_variant_slot0_must_be_base():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    variants = np.repeat(base[:, None, :], 8, axis=1)
    variants[3, 0] ^= 1
    with pytest.raises(ValueError):
        hamming.find_edges_fast(base, variants)


def test_mask_layout_and_pm1_match_jax():
    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    assert np.array_equal(hamming.pm1_encode(hashes),
                          jhamming.pm1_encode(hashes))
    assert np.array_equal(
        hamming.unpack_bits_pm1(torch.from_numpy(hashes)).numpy(),
        np.asarray(jhamming.unpack_bits_pm1(jax.numpy.asarray(hashes))))
    mask = np.zeros((2, 4), dtype=np.uint8)
    mask[0, 1] = 1 << 3          # row 0, column 1*8+3
    mask[1, 3] = 1 << 7          # row 1, column 31
    qi, bj = hamming.unpack_edges_mask(mask, 10, 100, 2, 32)
    assert list(zip(qi.tolist(), bj.tolist())) == [(10, 111), (11, 131)]


def test_wrappers_reject_bad_inputs():
    var_bits = torch.zeros((8, 1024, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hamming_cuda.scan_row_counts(var_bits, torch.zeros((1024, 1)))
    low = torch.zeros((1024, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_cuda.extract_rows_packed(
            var_bits[:, :4], var_bits[0], low[:4], low,
            torch.zeros((4, 1), dtype=torch.int64))


def test_row_match_counts_host_convenience(planted):
    base, variants, low = planted
    counts, n = hamming_cuda.row_match_counts(base, variants, low,
                                              similarity=31)
    want, _ = hamming_pallas.row_match_counts(base, variants, low,
                                              similarity=31, interpret=True)
    assert n == len(base) and np.array_equal(counts, want)

"""PyTorch Hamming edge search (plain CPU paths of K3 and K4) vs the JAX
package's Pallas kernels in interpret mode and the numpy oracle."""
import jax
import numpy as np
import pytest
import torch

from rupphash_tpu.ops import hamming as jhamming
from rupphash_tpu.ops import hamming_pallas
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import hamming, hamming_cuda


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


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


def _extract_both(planted, rows, n_pad_slots, sim):
    """K4's plain version and the JAX kernel (interpret mode) on hot rows
    `rows` followed by inert pad slots (row n-1, qidx n)."""
    base, variants, low = planted
    var_pm1, low_j, n, npad = hamming_pallas.prepare_inputs(base, variants,
                                                            low)
    var_bits, low_t, _, _ = hamming_cuda.prepare_inputs(base, variants, low)
    m = len(rows)
    ridx = np.array(list(rows) + [n - 1] * n_pad_slots)
    qidx = np.array(list(rows) + [n] * n_pad_slots, dtype=np.int32)[:, None]
    qlow = np.ones((len(ridx), 1), dtype=np.int32)
    qlow[:m, 0] = low[ridx[:m]]
    want = np.asarray(hamming_pallas.extract_rows_packed(
        jax.device_put(var_pm1[:, ridx]), jax.device_put(var_pm1[0]),
        jax.device_put(qlow), jax.device_put(low_j), jax.device_put(qidx),
        nbits=256, sim=sim, n_total=n, interpret=True))
    got = hamming_cuda.extract_rows_packed(
        var_bits[:, torch.from_numpy(ridx)], var_bits[0],
        torch.from_numpy(qlow), low_t, torch.from_numpy(qidx), sim=sim,
        n_total=n)
    assert got.dtype == torch.uint8 and got.shape == (len(ridx), npad // 8)
    assert got.numpy().tobytes() == want.tobytes()
    assert got[m:].sum() == 0
    return got


def test_extract_equal_jax_kernel(planted):
    # hot rows, a few cold ones, and inert pad slots (row n-1, qidx n)
    _extract_both(planted, [7, 55, 100, 40, 41, 0, 2999, 1500], 8, sim=31)


def test_extract_equal_jax_kernel_ascending_padded(planted):
    """Hot rows as the edge search hands them over: ascending, padded to
    a multiple of 32 with inert slots."""
    rows = [0, 7, 40, 41, 55, 100, 1500, 1800, 2222, 2500, 2990, 2991, 2999]
    got = _extract_both(planted, rows, 32 - len(rows), sim=31)
    bits = np.unpackbits(got.numpy(), axis=1, bitorder="little")
    hits = {(rows[r], int(c)) for r, c in zip(*np.nonzero(bits))}
    assert hits == {(7, 1800), (40, 2990), (55, 2222), (100, 2500)}


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
    """Variant slot 0 differing from base_hashes: find_edges_fast takes
    the tile path and returns the reference's edges (it used to raise)."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    base[8] = base[2]
    variants = np.repeat(base[:, None], 8, axis=1)
    variants[3, 0] ^= 1
    variants[5, 4] = base[9]
    got = _edge_set(*hamming.find_edges_fast(base, variants))
    want = _edge_set(*jhamming.find_edges_fast(base, variants))
    assert got == want == _edge_set(*jhamming.brute_force_edges(base, variants))
    assert {(2, 8), (5, 9)} <= got


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


@pytest.mark.parametrize("sim", [31, 40])
def test_k6_plain_equals_jax_kernel(planted, sim):
    """K6's plain version on the TPU kernels' own +/-1 int8 input."""
    base, variants, low = planted
    var_pm1, low_j, n, npad = hamming_pallas.prepare_inputs(base, variants,
                                                            low)
    want = np.asarray(hamming_pallas.scan_row_counts(
        jax.device_put(var_pm1), jax.device_put(low_j), nbits=256, sim=sim,
        n_total=n, interpret=True))
    got = hamming_cuda.scan_row_counts_pm1(
        torch.from_numpy(var_pm1), torch.from_numpy(low_j), sim=sim,
        n_total=n)
    assert got.dtype == torch.int32 and got.shape == (npad, 1)
    assert got.numpy().tobytes() == want.tobytes()
    var_bits, low_t, _, _ = hamming_cuda.prepare_inputs(base, variants, low)
    assert torch.equal(got, hamming_cuda.scan_row_counts(
        var_bits, low_t, sim=sim, n_total=n))
    assert hamming_cuda.scan_row_counts_pm1.launches == 0
    with pytest.raises(ValueError):
        hamming_cuda.scan_row_counts_pm1(torch.from_numpy(var_pm1).short(),
                                         torch.from_numpy(low_j))


def _reslotted(seed, n=2500, nbytes=32):
    """Variants whose slot 0 is not the base hash, with planted pairs
    through the base, through other slots, and low-confidence rows."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    base[100] = base[2400]
    base[17] = _flip(base[1500], [0, 9, 30])
    variants = rng.integers(0, 256, (n, 4, nbytes), dtype=np.uint8)
    variants[100, 0] = base[100]
    variants[17, 1] = base[17]
    variants[600, 2] = _flip(base[2047], [5])
    variants[2048, 3] = base[2049]           # straddles the base tiles
    low = np.zeros(n, dtype=bool)
    low[[17, 600]] = True
    return base, variants, low


@pytest.mark.parametrize("sim", [0, 8, 31])
def test_find_edges_matches_reference_tile_path(sim):
    base, variants, low = _reslotted(3)
    want = jhamming.find_edges(base, variants, low, similarity=sim,
                               return_stats=True)
    got = hamming.find_edges(base, variants, low, similarity=sim,
                             return_stats=True)
    assert _edge_set(*got[:2]) == _edge_set(*want[:2])
    assert got[2] == want[2]
    oracle = _edge_set(*jhamming.brute_force_edges(base, variants, low,
                                                   similarity=sim))
    assert _edge_set(*got[:2]) == oracle
    rerouted = hamming.find_edges_fast(base, variants, low, similarity=sim,
                                       return_stats=True)
    assert _edge_set(*rerouted[:2]) == oracle
    assert rerouted[2] == want[2]            # the tile path's stats


@pytest.mark.parametrize("sim", [0, 3, 12])
def test_64_bit_hashes_through_find_edges_fast(sim):
    """8-byte (pHash) hashes through the count sweep and extraction, as
    the JAX package groups them."""
    rng = np.random.default_rng(13)
    n = 1800
    base = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    base[4] = base[1700]
    base[1023] = _flip(base[1024], [1, 2])
    base[300] = _flip(base[301], range(10))
    variants = np.repeat(base[:, None], 8, axis=1)
    variants[50, 6] = _flip(base[60], [7])
    low = np.zeros(n, dtype=bool)
    low[[300, 301]] = True
    got = _edge_set(*hamming.find_edges_fast(base, variants, low,
                                             similarity=sim))
    want = _edge_set(*jhamming.find_edges(base, variants, low,
                                          similarity=sim))
    assert got == want == _edge_set(*jhamming.brute_force_edges(
        base, variants, low, similarity=sim))
    assert (4, 1700) in got and (300, 301) not in got
    var_bits, low_t, n2, _ = hamming_cuda.prepare_inputs(base, variants, low)
    var_pm1, low_j, _, _ = hamming_pallas.prepare_inputs(base, variants, low)
    jax_counts = np.asarray(hamming_pallas.scan_row_counts(
        jax.device_put(var_pm1), jax.device_put(low_j), nbits=64, sim=sim,
        n_total=n, interpret=True))
    assert hamming_cuda.scan_row_counts(
        var_bits, low_t, sim=sim, n_total=n).numpy().tobytes() == \
        jax_counts.tobytes()


def test_tile_window_holds_at_most_16(monkeypatch):
    """At most MAX_IN_FLIGHT extracted tiles await readback at any time
    (the reference allowed one more)."""
    rng = np.random.default_rng(21)
    n = 1024
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for k in range(0, n - 64, 40):           # hot tiles all over
        base[k + 37] = base[k]
    variants = np.repeat(base[:, None], 2, axis=1)
    variants[:, 0] ^= 0xFF                   # slot 0 is not the base
    live, peak = [0], [0]
    extract, edges = hamming._tile_extract, hamming._tile_edges

    def counted_extract(*a, **k):
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        return extract(*a, **k)

    def counted_edges(*a, **k):
        live[0] -= 1
        return edges(*a, **k)

    monkeypatch.setattr(hamming, "_tile_extract", counted_extract)
    monkeypatch.setattr(hamming, "_tile_edges", counted_edges)
    ei, ej, stats = hamming.find_edges(base, variants, similarity=0,
                                       query_tile=64, base_tile=64,
                                       return_stats=True)
    assert stats["tiles_extracted"] > hamming.MAX_IN_FLIGHT
    assert peak[0] == hamming.MAX_IN_FLIGHT and live[0] == 0
    assert _edge_set(ei, ej) == _edge_set(*jhamming.brute_force_edges(
        base, variants, similarity=0))


def test_prof_nz_tool_on_cpu(capsys):
    from rupphash_tpu_torch.tools import prof_nz

    assert prof_nz.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "equal sets: True" in out and "counts equal: True" in out

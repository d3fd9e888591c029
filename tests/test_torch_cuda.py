"""Kernels of the PyTorch port on a CUDA card: each against its plain
version, launch counting, and no fallback for CUDA tensors.

Skipped without a card.  On a card machine (which needs no jax):
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch.ops import (_build, hamming, hamming_cuda, pdq_cuda,
                                    pdq_hybrid, pdq_torch, restack)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1_args(dev, b=8, rows=200, cols=150, seed=0):
    rng = np.random.default_rng(seed)
    lumas = torch.from_numpy(rng.integers(0, 256, (b, rows, cols),
                                          dtype=np.uint8)).to(dev)
    l_op, r_op = pdq_torch.linear_operators(rows, cols)
    return (lumas, torch.from_numpy(l_op)[None].to(dev),
            torch.from_numpy(r_op)[None].to(dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.from_numpy(pdq_torch.dct16x64()).to(dev))


def test_k1_matches_plain_and_counts_launches(dev):
    args = _k1_args(dev)
    before = pdq_cuda.pdq_hash.launches
    k = pdq_cuda.pdq_hash(*args)
    assert pdq_cuda.pdq_hash.launches == before + 1
    p = pdq_cuda.pdq_hash_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k["dihedral"], p["dihedral"])
    assert float((k["quality"] - p["quality"]).abs().max()) < 1e-6
    assert torch.allclose(k["coeffs"], p["coeffs"], rtol=1e-4, atol=0.5)


def test_k3_k4_match_plain(dev):
    rng = np.random.default_rng(1)
    n = 3000
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    base[100] = base[2500]
    base[7] = base[1800] ^ 1
    low = np.zeros(n, dtype=bool)
    low[[7, 1800]] = True
    var = np.repeat(base[:, None], 8, axis=1)
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(base, var, low)
    kc = hamming_cuda.scan_row_counts(var_bits, low_d, sim=31, n_total=n)
    pc = hamming_cuda.scan_row_counts_plain(var_bits, low_d, sim=31,
                                            n_total=n)
    assert torch.equal(kc, pc)
    rows = torch.tensor([7, 100, 0, n - 1], device=dev)
    q = var_bits.index_select(1, rows)
    qidx = rows.to(torch.int32)[:, None]
    args = (q, var_bits[0], low_d[rows], low_d, qidx)
    km = hamming_cuda.extract_rows_packed(*args, sim=31, n_total=n)
    pm = hamming_cuda.extract_rows_packed_plain(*args, sim=31, n_total=n)
    assert torch.equal(km, pm)
    ei, ej = hamming.find_edges_fast(base, var, low, similarity=31)
    assert list(zip(ei.tolist(), ej.tolist())) == [(100, 2500)]


def test_cuda_tensors_never_fall_back(dev, monkeypatch):
    def broken():
        raise _build.KernelBuildError("simulated build failure")

    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(_build.KernelBuildError):
        pdq_cuda.pdq_hash(*_k1_args(dev))
    var_bits = torch.zeros((8, 1024, 32), dtype=torch.uint8, device=dev)
    low = torch.zeros((1024, 1), dtype=torch.int32, device=dev)
    with pytest.raises(_build.KernelBuildError):
        hamming_cuda.scan_row_counts(var_bits, low, n_total=10)
    with pytest.raises(_build.KernelBuildError):
        hamming_cuda.scan_row_counts_pm1(hamming.unpack_bits_pm1(var_bits),
                                         low, n_total=10)
    lumas = torch.zeros((2, 64, 48), dtype=torch.uint8, device=dev)
    with pytest.raises(_build.KernelBuildError):
        pdq_hybrid.pdq_coeffs(lumas, *pdq_hybrid.operators(64, 48, dev))
    with pytest.raises(_build.KernelBuildError):
        restack.restack(torch.zeros((1, 64, 16), device=dev), 2)


def test_cuda_inputs_outside_the_kernels_raise(dev):
    low = torch.zeros((1000, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):   # rows not padded to ROW_ALIGN
        hamming_cuda.scan_row_counts(
            torch.zeros((8, 1000, 32), dtype=torch.uint8, device=dev), low)
    low = torch.zeros((1024, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):   # no kernel for 3 variants
        hamming_cuda.scan_row_counts(
            torch.zeros((3, 1024, 32), dtype=torch.uint8, device=dev), low)
    lumas, l_u, r_u, idx, d16 = _k1_args(dev)
    with pytest.raises(ValueError):   # shape index past the operators
        pdq_cuda.pdq_hash(lumas, l_u, r_u, idx + 1, d16)
    with pytest.raises(ValueError):   # K2 holds at most 512 rows of L
        pdq_hybrid.pdq_coeffs(
            torch.zeros((1, 520, 8), dtype=torch.uint8, device=dev),
            *pdq_hybrid.operators(520, 8, dev))
    with pytest.raises(ValueError):   # no K6 for 128-bit rows
        hamming_cuda.scan_row_counts_pm1(
            torch.ones((8, 1024, 128), dtype=torch.int8, device=dev), low)


@pytest.mark.parametrize("shape", [(512, 288), (240, 320), (37, 70)])
def test_k2_matches_plain_and_k1(dev, shape):
    rng = np.random.default_rng(2)
    lumas = torch.from_numpy(rng.integers(0, 256, (12,) + shape,
                                          dtype=np.uint8)).to(dev)
    ops = pdq_hybrid.operators(*shape, dev)
    before = pdq_hybrid.pdq_coeffs.launches
    kc, kq = pdq_hybrid.pdq_coeffs(lumas, *ops)
    assert pdq_hybrid.pdq_coeffs.launches == before + 1
    pc, pq = pdq_hybrid.pdq_coeffs_plain(lumas, *ops)
    torch.cuda.synchronize()
    assert float((kq - pq).abs().max()) <= 1e-6
    assert torch.allclose(kc, pc, rtol=1e-4, atol=0.5)
    hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    k1 = pdq_torch.pdq_hash_batch(lumas)
    assert torch.equal(hyb["dihedral"], k1["dihedral"])
    assert float((hyb["quality"] - k1["quality"]).abs().max()) <= 1e-6


@pytest.mark.parametrize("width", [128, 256, 288, 7])
def test_k5_matches_plain_bitwise(dev, width):
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.standard_normal((1, 64, 8 * width))
                         .astype(np.float32)).to(dev)
    got = restack.restack(x, width)
    want = restack.restack_plain(x, width)
    torch.cuda.synchronize()
    assert got.shape == (8 * 64, width)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
def test_k6_and_k3_k4_at_both_widths_match_plain(dev, nbytes, v):
    rng = np.random.default_rng(nbytes + v)
    n = 2500
    base = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    base[100] = base[2400]
    base[5] = base[1500] ^ 3
    base[6] = base[7]
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    var[:, 0] = base
    if v > 1:
        var[900, 5] = base[2000]
    low = np.zeros(n, dtype=bool)
    low[[6, 7, 5]] = True
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(base, var, low)
    pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    sim = 2 if nbytes == 8 else 31
    k3 = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
    k6 = hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=sim, n_total=n)
    plain = hamming_cuda.scan_row_counts_pm1_plain(pm1, low_d, sim=sim,
                                                   n_total=n)
    torch.cuda.synchronize()
    assert torch.equal(k3, plain) and torch.equal(k6, plain)
    ei, ej = hamming.find_edges_fast(base, var, low, similarity=sim)
    want = hamming.brute_force_edges(base, var, low, similarity=sim)
    assert set(zip(ei.tolist(), ej.tolist())) == set(zip(*(a.tolist()
                                                         for a in want)))
    assert (100, 2400) in set(zip(ei.tolist(), ej.tolist()))

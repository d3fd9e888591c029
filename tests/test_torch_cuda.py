"""Kernels of the PyTorch port on a CUDA card: each against its plain
version, launch counting, and no fallback for CUDA tensors.

Skipped without a card.  On a card machine (which needs no jax):
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch.ops import _build, hamming, hamming_cuda, pdq_cuda, pdq_torch

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

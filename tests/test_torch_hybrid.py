"""PyTorch hybrid PDQ (plain CPU path of K2) vs the JAX package's hybrid
Pallas kernel in interpret mode, the port's K1 path and the golden."""
import ml_dtypes
import numpy as np
import pytest
import torch

from rupphash_tpu.ops import pdq_jax, pdq_pallas, pdq_ref
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import pdq_hybrid, pdq_torch

SHAPES = [(128, 96), (64, 64), (512, 288), (240, 320), (33, 501)]


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).astype(ml_dtypes.bfloat16).view(np.uint16)


@pytest.mark.parametrize("shape", SHAPES)
def test_split3_bitwise_equal_to_reference(shape):
    l_op, r_op = pdq_jax.linear_operators(*shape)
    for op in (l_op, r_op):
        want = pdq_pallas._split3(op)
        got = pdq_hybrid.split3(torch.from_numpy(op))
        assert all(g.dtype == torch.bfloat16 for g in got)
        for w, g in zip(want, got):
            assert np.array_equal(_bits(w), _bits(g))
        # the three terms carry the operator to float32 precision
        total = (got[0].double() + got[1].double() + got[2].double()).numpy()
        assert np.abs(total - op).max() <= 1e-7 * np.abs(op).max()


@pytest.mark.parametrize("b,rows,cols", [(8, 128, 96), (5, 64, 64)])
def test_plain_k2_matches_jax_hybrid_kernel(b, rows, cols):
    """(5, 64, 64) is padded to TILE_B = 8 by the reference; the port's
    kernel takes any batch size."""
    rng = np.random.default_rng(rows * cols + b)
    lumas = rng.integers(0, 256, (b, rows, cols), dtype=np.uint8)
    want = pdq_pallas.pdq_hash_batch_hybrid(lumas, interpret=True)
    got = pdq_hybrid.pdq_hash_batch_hybrid_plain(lumas)
    wrapped = pdq_hybrid.pdq_hash_batch_hybrid(lumas)   # CPU: the plain version
    for k in got:
        assert torch.equal(wrapped[k], got[k])
    assert got["dihedral"].shape == (b, 8, 32)
    assert got["hash"].shape == (b, 32) and got["coeffs"].shape == (b, 256)
    assert np.array_equal(got["dihedral"].numpy(), np.asarray(want["dihedral"]))
    assert np.array_equal(got["hash"].numpy(), np.asarray(want["hash"]))
    assert np.abs(got["quality"].numpy()
                  - np.asarray(want["quality"])).max() <= 1e-6
    np.testing.assert_allclose(got["coeffs"].numpy(),
                               np.asarray(want["coeffs"]), rtol=1e-4, atol=0.5)
    assert pdq_hybrid.pdq_coeffs.launches == 0


@pytest.mark.parametrize("shape", [(512, 288), (240, 320), (37, 70)])
def test_plain_k2_matches_k1_path_and_golden(shape):
    rng = np.random.default_rng(sum(shape))
    lumas = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    k1 = pdq_torch.pdq_hash_batch(lumas)
    assert torch.equal(hyb["dihedral"], k1["dihedral"])
    assert float((hyb["quality"] - k1["quality"]).abs().max()) <= 1e-6
    for i in range(3):
        coeffs, _, quality = pdq_ref.pdq_from_luma(lumas[i])
        dih = hyb["dihedral"][i].numpy()
        assert [bytes(dih[v]) for v in range(8)] == pdq_ref.dihedral_hashes(coeffs)
        assert abs(float(hyb["quality"][i]) - quality) <= 1e-6


def test_pdq_coeffs_rejects_bad_inputs():
    lumas = torch.zeros((2, 64, 48), dtype=torch.uint8)
    ops = pdq_hybrid.operators(64, 48, "cpu")
    with pytest.raises(ValueError):              # operators of another shape
        pdq_hybrid.pdq_coeffs(lumas, *pdq_hybrid.operators(64, 40, "cpu"))
    with pytest.raises(ValueError):              # float lumas
        pdq_hybrid.pdq_coeffs(lumas.float(), *ops)
    with pytest.raises(ValueError):              # float32 split terms
        pdq_hybrid.pdq_coeffs(lumas, ops[0].float(), *ops[1:])
    coeffs, quality = pdq_hybrid.pdq_coeffs(lumas, *ops)
    assert coeffs.shape == (2, 256) and quality.shape == (2,)
    assert float(quality.abs().max()) == 0.0     # flat planes

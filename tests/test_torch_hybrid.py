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


@pytest.mark.parametrize("b", [1, 5, 16])
@pytest.mark.parametrize("rows,cols", [(288, 512), (240, 320), (512, 288)])
def test_hybrid_entry_matches_jax_hybrid_at_scan_shapes(b, rows, cols):
    """The hybrid entry's four outputs against the JAX package's hybrid
    path (its Pallas kernel in interpret mode, then its XLA epilogue):
    hash and dihedral exact, quality within 1e-6, coeffs within rtol 1e-4,
    atol 0.5 (float32 sums taken in another order)."""
    rng = np.random.default_rng(rows + cols + b)
    small = rng.integers(0, 256, (b, rows // 8, cols // 8), dtype=np.uint8)
    # blocky texture with a little noise: PDQ quality well above zero
    lumas = np.kron(small, np.ones((8, 8), np.uint8))
    lumas = (lumas.astype(np.int16)
             + rng.integers(-3, 4, lumas.shape)).clip(0, 255).astype(np.uint8)
    want = pdq_pallas.pdq_hash_batch_hybrid(lumas, interpret=True)
    got = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    assert got["dihedral"].shape == (b, 8, 32) and got["hash"].shape == (b, 32)
    assert got["quality"].shape == (b,) and got["coeffs"].shape == (b, 256)
    assert np.array_equal(got["hash"].numpy(), np.asarray(want["hash"]))
    assert np.array_equal(got["dihedral"].numpy(),
                          np.asarray(want["dihedral"]))
    assert np.abs(got["quality"].numpy()
                  - np.asarray(want["quality"])).max() <= 1e-6
    np.testing.assert_allclose(got["coeffs"].numpy(),
                               np.asarray(want["coeffs"]), rtol=1e-4, atol=0.5)
    assert pdq_hybrid.pdq_coeffs.launches == 0


def _tied_coeffs(kind: str) -> np.ndarray:
    """(16, 16) float32 coefficients whose medians fall on ties."""
    rng = np.random.default_rng(len(kind))
    c = rng.standard_normal((16, 16)).astype(np.float32) * 50
    if kind == "tie_at_median":
        flat = c.reshape(-1)
        order = np.argsort(flat)
        flat[order[120:136]] = flat[order[127]]      # 16 equal values around it
    elif kind == "signed_zeros":
        flat = c.reshape(-1)
        order = np.argsort(flat)
        flat[order[100:128]] = -0.0
        flat[order[128:150]] = 0.0
    elif kind == "all_equal":
        c[:] = 3.5
    elif kind == "all_zero":
        c[:] = 0.0
        c[::2] = -0.0
    elif kind == "two_values":
        c[:] = np.where(rng.random((16, 16)) < 0.5, -1.0, 1.0)
    return c


@pytest.mark.parametrize("kind", ["random", "tie_at_median", "signed_zeros",
                                  "all_equal", "all_zero", "two_values"])
def test_dihedral_epilogue_plain_matches_golden_on_ties(kind):
    """pdq_torch.dihedral_from_coeffs, the plain version of the epilogue
    K1 and K2 share, against the numpy golden where the lower median
    falls on equal values and on +0.0 / -0.0."""
    coeffs = np.stack([_tied_coeffs(kind), -_tied_coeffs(kind),
                       _tied_coeffs(kind).T.copy()])
    got = pdq_torch.dihedral_from_coeffs(torch.from_numpy(coeffs)).numpy()
    for i in range(len(coeffs)):
        want = pdq_ref.dihedral_hashes(coeffs[i])
        assert [bytes(got[i, v]) for v in range(8)] == want


def test_hybrid_entry_on_cpu_is_the_plain_pair():
    lumas = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 96, 80), dtype=np.uint8))
    coeffs, quality = pdq_hybrid.pdq_coeffs(
        lumas, *pdq_hybrid.operators(96, 80, "cpu"))
    entry = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    assert torch.equal(entry["coeffs"], coeffs)
    assert torch.equal(entry["quality"], quality)
    assert torch.equal(entry["dihedral"], pdq_torch.dihedral_from_coeffs(
        coeffs.reshape(-1, 16, 16)))
    assert torch.equal(entry["hash"], entry["dihedral"][:, 0])

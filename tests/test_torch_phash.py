"""PyTorch pHash vs the JAX package's phash_jax and the numpy golden."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rupphash_tpu.ops import phash_jax, phash_ref
from rupphash_tpu_torch.ops import phash_torch


@pytest.mark.parametrize("shape", [(32, 32), (512, 288), (97, 131)])
def test_hash_and_dihedral_equal_jax(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    lumas = rng.integers(0, 256, (5,) + shape, dtype=np.uint8)
    got = phash_torch.phash_batch(lumas)
    want = phash_jax.phash_batch(lumas)
    assert got["hash"].dtype == torch.uint8 and got["hash"].shape == (5, 8)
    assert got["dihedral"].shape == (5, 8, 8)
    assert np.array_equal(got["hash"].numpy(), np.asarray(want["hash"]))
    assert np.array_equal(got["dihedral"].numpy(), np.asarray(want["dihedral"]))


@pytest.mark.parametrize("shape", [(32, 32), (240, 320)])
def test_operators_equal_jax_bytes(shape):
    for got, want in zip(phash_torch.phash_operators(*shape),
                         phash_jax.phash_operators(*shape)):
        assert got.tobytes() == want.tobytes()


def test_hash_equals_golden_at_32x32():
    rng = np.random.default_rng(7)
    lumas = rng.integers(0, 256, (8, 32, 32), dtype=np.uint8)
    got = phash_torch.phash_batch(lumas)
    for i in range(8):
        gold = phash_ref.phash_from_luma32(lumas[i].astype(np.float32))
        assert phash_torch.u64_from_bytes(got["hash"][i].numpy()) == gold
        variants = [phash_torch.u64_from_bytes(got["dihedral"][i, v].numpy())
                    for v in range(8)]
        assert variants == phash_ref.dihedral_hashes(gold)


def test_bit_ops_equal_jax():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (6, 8, 8)).astype(bool)
    got = phash_torch.dihedral_bits(torch.from_numpy(bits))
    want = phash_jax.dihedral_bits(jnp.asarray(bits))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(phash_torch.bits_to_u64_bytes(got).numpy(),
                          np.asarray(phash_jax.bits_to_u64_bytes(want)))
    assert phash_torch.u64_from_bytes(np.arange(8, dtype=np.uint8)) == \
        phash_jax.u64_from_bytes(np.arange(8, dtype=np.uint8))

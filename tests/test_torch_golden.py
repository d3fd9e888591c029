"""Every float32 PDQ path of the two packages against the numpy golden
(pdq_ref) on 257 random-texture images at the scan's three working
shapes: the JAX package's core (its production hasher) and its hybrid
path (Pallas in interpret mode), the port's plain K1 (the scan's hasher)
and plain K2 with the shared epilogue.

The golden blurs with running box sums; the device paths take two
matrix products, K1 as L . (X . R^T) and K2 as (L . X) . R^T.  Their
coefficients agree to a few 1e-5, so a coefficient that lies within
rounding of its variant's median can land on the other side of it, and
which path that happens to is the luck of the summation order.  The
contract, for each path: at most one image in 64 differs from the
golden, by at most 2 bits a variant, every flipped coefficient lies
within 5e-4 of its variant's median in the golden (coefficients are of
the order of 100, so a path's coefficients and its median each sit a few
1e-5 from the golden's; the pinned image flips the median coefficient
itself and a neighbour 1.7e-4 above it), and quality agrees within 1e-6.
PINNED holds what each path does today on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from rupphash_tpu.ops import pdq_jax, pdq_pallas
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import pdq_hybrid, pdq_ref, pdq_torch

B = 257
SHAPES = [(240, 320), (288, 512), (512, 288)]
PATHS = {
    "jax_core": lambda x: pdq_jax.pdq_hash_batch(x),
    "jax_hybrid_interpret":
        lambda x: pdq_pallas.pdq_hash_batch_hybrid(x, interpret=True),
    "port_plain_k1": lambda x: pdq_torch.pdq_hash_batch(x),
    "port_plain_k2": lambda x: pdq_hybrid.pdq_hash_batch_hybrid(x),
}
# Images that differ from the golden today.  A change of the CPU matrix
# product of torch or XLA may move a pinned image; the bound above, not
# the pin, is the contract.
PINNED = {("port_plain_k1", (240, 320)): [147]}
# the four sign patterns of _bit_matrix behind the eight dihedral hashes
SIGNS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


@functools.lru_cache(maxsize=None)
def _lumas(shape) -> np.ndarray:
    """Random 24x32 planes (numpy, seed shape[0] + B) upscaled bilinear
    to `shape` on the CPU: the textures the card tests hash."""
    rng = np.random.default_rng(shape[0] + B)
    small = torch.from_numpy(rng.integers(0, 256, (B, 1, 24, 32))
                             .astype(np.float32))
    big = torch.nn.functional.interpolate(small, size=shape, mode="bilinear",
                                          align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8)[:, 0].numpy()


@functools.lru_cache(maxsize=None)
def _golden(shape):
    coeffs, quality = [], []
    for luma in _lumas(shape):
        c, _, q = pdq_ref.pdq_from_luma(luma)
        coeffs.append(c)
        quality.append(q)
    coeffs = np.stack(coeffs)
    return coeffs, np.array(quality), pdq_ref.dihedral_hashes_batch(coeffs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("path", list(PATHS))
def test_path_against_golden_on_257_textures(path, shape):
    coeffs, quality, want = _golden(shape)
    out = PATHS[path](_lumas(shape))
    got = np.asarray(out["dihedral"])
    got_coeffs = np.asarray(out["coeffs"]).reshape(B, 256)
    assert got.shape == want.shape == (B, 8, 32)
    assert np.abs(np.asarray(out["quality"]) - quality).max() <= 1e-6
    # each path's hashes are the golden's bit rule on its own coefficients
    assert np.array_equal(got, pdq_ref.dihedral_hashes_batch(got_coeffs))

    flipped = np.unpackbits(got ^ want, axis=2).sum(axis=2)     # (B, 8)
    differs = np.flatnonzero(flipped.max(axis=1))
    assert len(differs) <= B // 64, f"{path}: images {differs.tolist()}"
    assert int(flipped.max()) <= 2
    for i in differs:
        for neg_rows, neg_cols in SIGNS:
            gold = pdq_ref._signed(coeffs[i], neg_rows, neg_cols)
            mine = pdq_ref._bit_matrix(got_coeffs[i], neg_rows, neg_cols)
            moved = mine != (gold > pdq_ref._lower_median(gold))
            dist = np.abs(gold - pdq_ref._lower_median(gold))[moved]
            assert dist.size == 0 or float(dist.max()) <= 5e-4
    assert differs.tolist() == PINNED.get((path, shape), [])


def test_scan_hasher_is_the_k1_path():
    """The scan hashes with K1 (pdq_torch.pdq_hash_batch); putting K2 in
    its place would change cached hashes on rare images either way."""
    from rupphash_tpu_torch.pipeline import scan

    assert scan.pdq_torch is pdq_torch
    assert not hasattr(scan, "pdq_hybrid")

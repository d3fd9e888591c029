"""PyTorch PDQ (plain CPU path of K1) vs the JAX package and the golden."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rupphash_tpu.ops import pdq_jax, pdq_pallas, pdq_ref
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import pdq_cuda, pdq_torch
from tests.conftest import lcg_buffer64


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _textured(rng, rows, cols):
    """Random 24x32 plane upscaled bilinear: natural-image-like texture
    (quality well above the low-confidence gate)."""
    small = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((cols, rows),
                                                    Image.BILINEAR))


def _lumas(kind, shape, b, seed):
    rng = np.random.default_rng(seed)
    if kind == "textured":
        return np.stack([_textured(rng, *shape) for _ in range(b)])
    return rng.integers(0, 256, (b,) + shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(512, 288), (320, 240), (33, 501),
                                   (5, 5)])
def test_operators_equal_jax_bytes(shape):
    lj, rj = pdq_jax.linear_operators(*shape)
    lt, rt = pdq_torch.linear_operators(*shape)
    assert lt.tobytes() == lj.tobytes() and rt.tobytes() == rj.tobytes()
    assert pdq_torch.dct16x64().tobytes() == pdq_jax.dct16x64().tobytes()
    assert pdq_torch._SIGNS.tobytes() == pdq_jax._SIGNS.tobytes()
    assert pdq_torch._PACK_PLAIN.tobytes() == pdq_jax._PACK_PLAIN.tobytes()
    assert pdq_torch._PACK_TRANS.tobytes() == pdq_jax._PACK_TRANS.tobytes()
    assert pdq_torch._VARIANT_ORDER == pdq_jax._VARIANT_ORDER


@pytest.mark.parametrize("kind", ["textured", "random"])
@pytest.mark.parametrize("shape", [(512, 288), (320, 240), (40, 56)])
def test_hash_matches_jax_and_golden(kind, shape):
    lumas = _lumas(kind, shape, 3, seed=hash((kind, shape)) % 2**32)
    out = pdq_torch.pdq_hash_batch(lumas)
    jx = pdq_jax.pdq_hash_batch(lumas)
    assert out["hash"].dtype == torch.uint8 and out["hash"].shape == (3, 32)
    assert out["dihedral"].shape == (3, 8, 32)
    assert out["quality"].dtype == torch.float32
    assert out["coeffs"].shape == (3, 256)
    assert np.array_equal(out["dihedral"].numpy(), np.asarray(jx["dihedral"]))
    assert np.array_equal(out["hash"].numpy(), np.asarray(jx["hash"]))
    assert np.abs(out["quality"].numpy()
                  - np.asarray(jx["quality"])).max() < 1e-6
    for k in range(3):
        coeffs, _, quality = pdq_ref.pdq_from_luma(lumas[k])
        gold = pdq_ref.dihedral_hashes(coeffs)
        got = out["dihedral"][k].numpy()
        assert [bytes(got[v]) for v in range(8)] == gold
        assert abs(float(out["quality"][k]) - quality) < 1e-6
        assert np.allclose(out["coeffs"][k].numpy(), coeffs,
                           rtol=1e-4, atol=0.5)


def test_mixed_batch_bit_identical_to_per_shape():
    rng = np.random.default_rng(12)
    shapes = [(200, 150), (128, 96), (200, 150), (64, 64), (200, 150),
              (128, 96), (33, 47), (70, 200), (512, 288)]
    lumas = [_textured(rng, *s) if k % 2 else
             rng.integers(0, 256, s, dtype=np.uint8)
             for k, s in enumerate(shapes)]
    mixed = pdq_torch.pdq_hash_batch_mixed(lumas)
    assert mixed["dihedral"].shape == (len(shapes), 8, 32)
    for k, luma in enumerate(lumas):
        single = pdq_torch.pdq_hash_batch(luma[None])
        assert torch.equal(mixed["dihedral"][k], single["dihedral"][0])
        assert torch.equal(mixed["hash"][k], single["hash"][0])
        assert float(mixed["quality"][k]) == float(single["quality"][0])
        coeffs, _, _ = pdq_ref.pdq_from_luma(luma)
        assert bytes(mixed["hash"][k].numpy()) == pdq_ref.coeffs_to_hash(coeffs)


def test_mixed_batch_empty():
    out = pdq_torch.pdq_hash_batch_mixed([])
    assert out["dihedral"].shape == (0, 8, 32)
    assert out["coeffs"].shape == (0, 256)


def test_plain_k1_matches_pallas_fused_interpret():
    """The K1 wrapper's CPU path (its plain version) against the Pallas
    kernel it replaces, run in interpret mode."""
    lumas = _lumas("textured", (128, 96), 8, seed=0)
    fused = pdq_pallas.pdq_hash_batch_fused(lumas, interpret=True)
    l_op, r_op = pdq_torch.linear_operators(128, 96)
    out = pdq_cuda.pdq_hash(torch.from_numpy(lumas),
                            torch.from_numpy(l_op)[None],
                            torch.from_numpy(r_op)[None],
                            torch.zeros(8, dtype=torch.int32),
                            torch.from_numpy(pdq_torch.dct16x64()))
    assert pdq_cuda.pdq_hash.launches == 0   # CPU tensors never launch
    assert np.array_equal(out["dihedral"].numpy(),
                          np.asarray(fused["dihedral"]))
    assert np.abs(out["quality"].numpy()
                  - np.asarray(fused["quality"])).max() < 1e-6
    assert np.allclose(out["coeffs"].numpy(), np.asarray(fused["coeffs"]),
                       rtol=1e-4, atol=0.5)


def test_plain_k1_mixed_operators_match_per_shape():
    """shape_idx picks each image's operators from the unique set."""
    rng = np.random.default_rng(3)
    shapes = [(60, 64), (64, 40), (60, 64)]
    lumas = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    planes = np.zeros((3, 64, 64), np.uint8)
    l_u = np.zeros((2, 64, 64), np.float32)
    r_u = np.zeros((2, 64, 64), np.float32)
    for k, luma in enumerate(lumas):
        planes[k, :luma.shape[0], :luma.shape[1]] = luma
    for sid, (rows, cols) in enumerate([(60, 64), (64, 40)]):
        lo, ro = pdq_torch.linear_operators(rows, cols)
        l_u[sid, :, :rows] = lo
        r_u[sid, :, :cols] = ro
    out = pdq_cuda.pdq_hash(torch.from_numpy(planes), torch.from_numpy(l_u),
                            torch.from_numpy(r_u),
                            torch.tensor([0, 1, 0], dtype=torch.int32),
                            torch.from_numpy(pdq_torch.dct16x64()))
    for k, luma in enumerate(lumas):
        single = pdq_torch.pdq_hash_batch(luma[None])
        assert torch.equal(out["dihedral"][k], single["dihedral"][0])


@pytest.mark.parametrize("bad", ["dtype", "shape_idx", "operator", "size"])
def test_k1_wrapper_rejects_bad_inputs(bad):
    lumas = torch.zeros((2, 64, 64), dtype=torch.uint8)
    l_u = torch.zeros((1, 64, 64))
    r_u = torch.zeros((1, 64, 64))
    idx = torch.zeros(2, dtype=torch.int32)
    d16 = torch.from_numpy(pdq_torch.dct16x64())
    if bad == "dtype":
        lumas = lumas.float()
    elif bad == "shape_idx":
        idx = idx.long()
    elif bad == "operator":
        r_u = torch.zeros((1, 64, 63))
    else:
        lumas = torch.zeros((1, 600, 64), dtype=torch.uint8)
        l_u = torch.zeros((1, 64, 600))
        idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        pdq_cuda.pdq_hash(lumas, l_u, r_u, idx, d16)


def test_bisect_median_equals_sort_on_ties():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((6, 4, 256)).astype(np.float32) * 100
    tied = base.copy()
    tied[:, :, :128] = tied[:, :, 128:]
    zeros = base.copy()
    zeros[:, :, ::2] = 0.0
    zeros[:, :, 1::4] = -0.0
    tiny = (rng.standard_normal((2, 4, 256)) * 1e-40).astype(np.float32)
    for flat in (base, tied, zeros, tiny):
        got = pdq_torch._median_lower_bisect(torch.from_numpy(flat)).numpy()
        want = np.sort(flat, axis=-1)[:, :, 127]
        assert np.array_equal(got == 0.0, want == 0.0)
        assert np.array_equal(np.where(got == 0.0, 0.0, got),
                              np.where(want == 0.0, 0.0, want))
        jx = np.asarray(pdq_jax._median_lower_bisect(jnp.asarray(flat)))
        assert got.tobytes() == jx.tobytes()


def test_dihedral_from_coeffs_matches_golden_on_lcg():
    coeffs = pdq_ref.dct64_to_16(lcg_buffer64(42))
    out = pdq_torch.dihedral_from_coeffs(
        torch.from_numpy(coeffs.reshape(1, 16, 16)))[0].numpy()
    assert [bytes(out[v]) for v in range(8)] == pdq_ref.dihedral_hashes(coeffs)


def test_pdq_hash_image_end_to_end():
    rng = np.random.default_rng(9)
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    image = np.asarray(Image.fromarray(small).resize((700, 500),
                                                     Image.BILINEAR))
    h, q = pdq_torch.pdq_hash_image(image)
    gold = pdq_ref.generate_pdq(image)
    assert h == gold[0] and abs(q - gold[1]) < 1e-6
    assert pdq_torch.pdq_hash_image(image[:4, :4]) is None

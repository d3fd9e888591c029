"""Kernels of the PyTorch port on a CUDA card: each against its plain
version, launch counting, and no fallback for CUDA tensors.

Skipped without a card.  On a card machine (which needs no jax):
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import (_build, hamming, hamming_cuda, pdq_cuda,
                                    pdq_hybrid, pdq_torch, restack)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device.pin("cuda")


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
        pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    with pytest.raises(_build.KernelBuildError):
        hamming_cuda.extract_rows_packed(
            var_bits[:, :32].contiguous(), var_bits[0], low[:32], low,
            torch.arange(32, dtype=torch.int32, device=dev)[:, None],
            n_total=1000)
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
    with pytest.raises(ValueError):   # the same, checked on the host
        pdq_cuda.pdq_hash(lumas, l_u, r_u, (idx + 1).cpu(), d16)
    host = pdq_cuda.pdq_hash(lumas, l_u, r_u, idx.cpu(), d16)
    assert torch.equal(host["dihedral"],
                       pdq_cuda.pdq_hash(lumas, l_u, r_u, idx, d16)["dihedral"])
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


@pytest.mark.parametrize("n", [1, 2, 1023, 1025, 3000, 20_000])
@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
def test_k3_tile_walk_equals_plain_and_k6(dev, n, nbytes, v):
    """The redesigned K3 (wgmma, persistent blocks over the upper
    triangle) at sizes around its 64-row query and 128-row base tiles."""
    rng = np.random.default_rng(n + nbytes + v)
    base = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    for i, j in ((0, n - 1), (63, 64), (127, 128), (n // 2, n // 2 + 1)):
        if 0 <= i < j < n:
            base[j] = base[i] ^ 1
    var[:, 0] = base
    low = rng.random(n) < 0.01
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(base, var, low)
    sim = 4 if nbytes == 8 else 40
    k3 = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
    k6 = hamming_cuda.scan_row_counts_pm1(
        hamming.unpack_bits_pm1(var_bits).contiguous(), low_d, sim=sim,
        n_total=n)
    plain = hamming_cuda.scan_row_counts_plain(var_bits, low_d, sim=sim,
                                               n_total=n)
    torch.cuda.synchronize()
    assert torch.equal(k3, plain) and torch.equal(k6, plain)


@pytest.mark.parametrize("shape", [(288, 512), (240, 320), (512, 288),
                                   (97, 131), (64, 500)])
def test_k1_is_bit_identical_to_plain_and_pdq_ref(dev, shape):
    """The redesigned K1 (register tiles, cp.async double buffering):
    dihedral hashes and quality bit-identical to the plain version, and
    equal to the numpy golden."""
    from rupphash_tpu_torch.ops import pdq_ref

    args = _k1_args(dev, b=6, rows=shape[0], cols=shape[1], seed=shape[1])
    k = pdq_cuda.pdq_hash(*args)
    p = pdq_cuda.pdq_hash_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k["dihedral"], p["dihedral"])
    assert torch.equal(k["quality"].view(torch.int32),
                       p["quality"].view(torch.int32))
    lumas = args[0].cpu().numpy()
    for i in range(len(lumas)):
        coeffs, _, quality = pdq_ref.pdq_from_luma(lumas[i])
        assert [bytes(h) for h in k["dihedral"][i].cpu().numpy()] == \
            pdq_ref.dihedral_hashes(coeffs)
        assert abs(float(k["quality"][i]) - quality) < 1e-6


def _mosaic_scene(h, w, cfa, seed):
    """A smooth random linear scene sampled through a CFA (u16)."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(rng.random((1, 3, 12, 16), dtype=np.float32))
    lin = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                          align_corners=False)[0].numpy()
    n = cfa.shape[0]
    site = np.tile(cfa, (-(-h // n), -(-w // n)))[:h, :w]
    m = np.take_along_axis(lin, site[None], axis=0)[0]
    return np.round(512 + m * 15000).astype(np.uint16)


@pytest.mark.parametrize("pattern", ["rggb", "xtrans"])
def test_demosaic_on_cuda_matches_cpu(dev, pattern):
    """The demosaic's elementwise stencils on the card against the same
    code on the CPU: at most 1 u8 level on at most 1e-4 of the values."""
    from types import SimpleNamespace

    from rupphash_tpu_torch.ops import demosaic

    cfa = (np.array([[0, 1], [1, 2]]) if pattern == "rggb" else
           np.array([[1, 2, 1, 1, 0, 1], [0, 1, 0, 2, 1, 2],
                     [1, 2, 1, 1, 0, 1], [1, 0, 1, 1, 2, 1],
                     [2, 1, 2, 0, 1, 0], [1, 0, 1, 1, 2, 1]]))
    raw = SimpleNamespace(mosaic=_mosaic_scene(600, 900, cfa, 4), cfa=cfa,
                          black=512.0, white=16383.0, linear=False,
                          as_shot_neutral=np.array([0.5, 1.0, 0.7]),
                          color_matrix=demosaic._XYZ2SRGB)
    got = demosaic.process_raw(raw, dev)
    want = demosaic.process_raw(raw, "cpu")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and int(diff.max()) <= 1
    assert np.count_nonzero(diff) <= 1e-4 * diff.size


def test_http_query_on_cuda_matches_host_oracle(dev, tmp_path):
    """The service on the card: /v1/add hashes with K1, /v1/query answers
    as a numpy oracle over the index's host arrays does (min over the 8
    variants of popcount(XOR), low-quality and dead gates, radius, sort
    by distance then index)."""
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image

    from rupphash_tpu_torch import serve
    from rupphash_tpu_torch.ops import pdq_cuda, pdq_torch

    rng = np.random.default_rng(6)
    ix = serve.HashIndex()
    for i in range(3000):
        ix.add(f"/syn/{i}", bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
               quality=int(rng.integers(30, 101)))
    imgs = []
    for k in range(4):
        small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(small).resize((320, 240),
                                                       Image.BILINEAR))
        Image.fromarray(img).save(tmp_path / f"img{k}.png")
        imgs.append(img)
    svc = serve.NearDupService(ix, roots=[tmp_path])
    assert svc.device.type == "cuda"
    httpd, port = svc.serve()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(path, data):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        before = pdq_cuda.pdq_hash.launches
        for k in range(4):
            h = bytes.fromhex(post(f"/v1/add?path={tmp_path}/img{k}.png",
                                   b"")["hash"])
            for dist in (0, 5, 30, 45):           # planted near copies
                flip = bytearray(h)
                for p in rng.choice(256, dist, replace=False):
                    flip[p // 8] ^= 1 << (p % 8)
                ix.add(f"/near/{k}/{dist}", bytes(flip),
                       quality=20 if dist == 5 else 90)
        ix.remove("/near/1/0")
        bodies = []
        for img in imgs:
            buf = io.BytesIO()
            Image.fromarray(np.rot90(img) if len(bodies) % 2 else img).save(
                buf, format="JPEG", quality=85)
            bodies.append(buf.getvalue())
        answers = [post("/v1/query", b) for b in bodies]
        assert pdq_cuda.pdq_hash.launches == before + 8
    finally:
        httpd.shutdown()
        httpd.server_close()

    n = ix._n
    base = ix._hashes[:n]
    rank = np.cumsum(~ix._dead[:n]) - 1
    for body, got in zip(bodies, answers):
        luma = serve.prepare_luma_fast(serve.decode.sniff_decode_bytes(
            body, device="cpu"))
        out = pdq_torch.pdq_hash_batch(torch.from_numpy(luma[None]))  # plain
        variants = out["dihedral"][0].numpy()
        assert got["hash"] == bytes(variants[0]).hex()
        dist = np.unpackbits(base[None] ^ variants[:, None], axis=2).sum(
            axis=2).min(axis=0)
        radius = 40 if got["quality"] >= 50 else 0
        ok = (~ix._dead[:n] & ((ix._quality[:n] >= 50) | (dist == 0))
              & (dist <= radius))
        sel = np.flatnonzero(ok)
        sel = sel[np.lexsort((sel, dist[sel]))][:100]
        assert got["matches"] == [
            {"path": ix._paths[i], "distance": int(dist[i]),
             "index": int(rank[i])} for i in sel]
        assert got["matches"], "every query has planted matches"


@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
def test_k4_skips_pads_and_packs_like_plain(dev, nbytes, v):
    """The redesigned K4 (wgmma, tiles under the diagonal skipped, bits
    packed from the accumulator layout): masks byte-identical to the
    plain version on dense matches (a block of equal hashes sets many
    bits of a row, in every position of a byte), on late rows with pad
    slots, on unsorted rows, on low-confidence rows and on MQ = 32."""
    rng = np.random.default_rng(10 * nbytes + v)
    n = 3000
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    dup = rng.choice(n, 300, replace=False)
    var[dup, 0] = var[dup[0], 0]                   # 300 equal hashes
    var[dup[::3], 0, 0] ^= 1                       # a third one bit away
    if v > 1:
        var[5, 3] = var[2900, 0]
    low = np.zeros(n, dtype=bool)
    low[dup[::7]] = True
    base = np.ascontiguousarray(var[:, 0])
    var_bits, low_d, _, npad = hamming_cuda.prepare_inputs_device(base, var,
                                                                  low)
    sim = 1
    pc = hamming_cuda.scan_row_counts_plain(var_bits, low_d, sim=sim,
                                            n_total=n)
    hot = torch.nonzero(pc[:n, 0])[:, 0]
    assert len(hot) > 200
    cases = {"all": hot, "late": hot[hot > 2000], "one tile": hot[:20],
             "unsorted": hot[torch.randperm(len(hot), device=dev)][:100]}
    for label, rows in cases.items():
        m = len(rows)
        mq = -(-m // 32) * 32
        ridx = torch.full((mq,), n - 1, dtype=torch.int64, device=dev)
        qidx = torch.full((mq, 1), n, dtype=torch.int32, device=dev)
        qlow = torch.ones((mq, 1), dtype=torch.int32, device=dev)
        ridx[:m] = rows
        qidx[:m, 0] = rows.to(torch.int32)
        qlow[:m] = low_d[rows]
        args = (var_bits.index_select(1, ridx), var_bits[0], qlow, low_d, qidx)
        before = hamming_cuda.extract_rows_packed.launches
        km = hamming_cuda.extract_rows_packed(*args, sim=sim, n_total=n)
        assert hamming_cuda.extract_rows_packed.launches == before + 1
        pm = hamming_cuda.extract_rows_packed_plain(*args, sim=sim, n_total=n)
        torch.cuda.synchronize()
        assert torch.equal(km, pm), label
        assert int(km[m:].sum()) == 0, label
        if label == "all":
            bits = np.unpackbits(km.cpu().numpy(), axis=1, bitorder="little")
            assert int(bits.sum()) == int(pc.sum())
    with pytest.raises(ValueError):   # base rows not in whole tiles of 128
        hamming_cuda.extract_rows_packed(
            args[0], var_bits[0, :1000].contiguous(), args[2],
            low_d[:1000].contiguous(), args[4], sim=sim, n_total=n)


@pytest.mark.parametrize("b", [1, 5, 257])
@pytest.mark.parametrize("shape", [(288, 512), (240, 320), (512, 288),
                                   (33, 501), (400, 100)])
def test_k2_fused_epilogue_equals_its_plain_version_and_k1(dev, shape, b):
    """The redesigned K2 (wgmma, one warpgroup per image, the dihedral
    epilogue in the kernel): one launch; its hashes equal
    dihedral_from_coeffs of its own coefficients; coefficients and
    quality do not depend on whether the epilogue runs.  K1 and K2 sum
    in different orders (L . (X . R^T) and (L . X) . R^T), and each lies
    a few 1e-5 from the golden's running box sums, so either kernel may
    put a coefficient that is within rounding of its variant's median on
    the other side of it: between the two at most one image in 64 may
    differ, by at most 2 bits a variant (each against the golden:
    test_k1_and_k2_kernels_against_golden_on_257_textures)."""
    rng = np.random.default_rng(shape[0] + b)
    small = torch.from_numpy(rng.integers(0, 256, (b, 1, 24, 32))
                             .astype(np.float32)).to(dev)
    lumas = torch.nn.functional.interpolate(
        small, size=shape, mode="bilinear", align_corners=False
    ).round().clamp(0, 255).to(torch.uint8)[:, 0].contiguous()
    ops = pdq_hybrid.operators(*shape, dev)
    before = pdq_hybrid.pdq_coeffs.launches
    hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
    assert pdq_hybrid.pdq_coeffs.launches == before + 1
    kc, kq = pdq_hybrid.pdq_coeffs(lumas, *ops)
    pc, pq = pdq_hybrid.pdq_coeffs_plain(lumas, *ops)
    k1 = pdq_torch.pdq_hash_batch(lumas)
    torch.cuda.synchronize()
    assert torch.equal(hyb["coeffs"].view(torch.int32), kc.view(torch.int32))
    assert torch.equal(hyb["quality"].view(torch.int32), kq.view(torch.int32))
    assert torch.equal(hyb["dihedral"], pdq_torch.dihedral_from_coeffs(
        hyb["coeffs"].reshape(-1, 16, 16)))
    assert torch.equal(hyb["hash"], hyb["dihedral"][:, 0])
    assert float((kq - pq).abs().max()) <= 1e-6
    assert torch.allclose(kc, pc, rtol=1e-4, atol=0.5)
    flipped = np.unpackbits((hyb["dihedral"] ^ k1["dihedral"]).cpu().numpy(),
                            axis=2).sum(axis=2)            # (B, 8) bits apart
    assert int(flipped.max()) <= 2
    assert int((flipped.max(axis=1) > 0).sum()) <= max(1, b // 64)
    assert float((hyb["quality"] - k1["quality"]).abs().max()) <= 1e-6


@pytest.mark.parametrize("shape", [(240, 320), (288, 512), (512, 288)])
def test_k1_and_k2_kernels_against_golden_on_257_textures(dev, shape):
    """Both PDQ kernels against the numpy golden on 257 textures made on
    the card (the batch of the test above): each kernel may leave the
    golden on at most one image in 64, by at most 2 bits a variant, with
    quality within 1e-6.  Prints which kernel differs where (run with
    -s); tests/test_torch_golden.py holds the plain versions and the JAX
    package's two paths to the same bound on the CPU."""
    from rupphash_tpu_torch.ops import pdq_ref

    b = 257
    rng = np.random.default_rng(shape[0] + b)
    small = torch.from_numpy(rng.integers(0, 256, (b, 1, 24, 32))
                             .astype(np.float32)).to(dev)
    lumas = torch.nn.functional.interpolate(
        small, size=shape, mode="bilinear", align_corners=False
    ).round().clamp(0, 255).to(torch.uint8)[:, 0].contiguous()
    before = pdq_cuda.pdq_hash.launches, pdq_hybrid.pdq_coeffs.launches
    outs = {"K1": pdq_torch.pdq_hash_batch(lumas),
            "K2": pdq_hybrid.pdq_hash_batch_hybrid(lumas)}
    torch.cuda.synchronize()
    assert (pdq_cuda.pdq_hash.launches, pdq_hybrid.pdq_coeffs.launches) == \
        (before[0] + 1, before[1] + 1)
    coeffs, quality = [], []
    for luma in lumas.cpu().numpy():
        c, _, q = pdq_ref.pdq_from_luma(luma)
        coeffs.append(c)
        quality.append(q)
    want = pdq_ref.dihedral_hashes_batch(np.stack(coeffs))
    for name, out in outs.items():
        got = out["dihedral"].cpu().numpy()
        flipped = np.unpackbits(got ^ want, axis=2).sum(axis=2)   # (B, 8)
        differs = np.flatnonzero(flipped.max(axis=1))
        print(f"F1 {name} {shape[0]}x{shape[1]}: {len(differs)} of {b} images "
              f"differ from pdq_ref: {differs.tolist()}, bits a variant "
              f"{[flipped[i].tolist() for i in differs]}")
        assert len(differs) <= b // 64 and int(flipped.max()) <= 2, name
        assert np.abs(out["quality"].cpu().numpy()
                      - np.array(quality)).max() <= 1e-6, name


@pytest.mark.parametrize("n", [1023, 2500, 20_000])
@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
def test_k6_register_resident_walk_equals_plain_and_k3(dev, n, nbytes, v):
    """The redesigned K6 (base fragments in registers, query rows
    streamed through a cp.async ring, triangle-only items) against its
    plain version and K3: n not a multiple of any tile, low-quality
    rows, a block of 300 equal hashes (many matches a tile, so the
    predicate runs), pairs through a late variant slot, and a match
    between the first row and the last."""
    rng = np.random.default_rng(100 * n + nbytes + v)
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    dup = rng.choice(n, 300, replace=False)
    var[dup, 0] = var[dup[0], 0]
    var[dup[::3], 0, 0] ^= 1
    var[n - 1, 0] = var[0, 0]
    if v > 1:
        var[5, v - 1] = var[n - 2, 0]
    low = rng.random(n) < 0.03
    low[dup[::7]] = True
    base = np.ascontiguousarray(var[:, 0])
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(base, var, low)
    pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    sim = 1 if nbytes == 8 else 31
    before = hamming_cuda.scan_row_counts_pm1.launches
    k6 = hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=sim, n_total=n)
    assert hamming_cuda.scan_row_counts_pm1.launches == before + 1
    plain = hamming_cuda.scan_row_counts_pm1_plain(pm1, low_d, sim=sim,
                                                   n_total=n)
    k3 = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
    torch.cuda.synchronize()
    assert torch.equal(k6, plain) and torch.equal(k6, k3)
    assert int(k6[0, 0]) >= 1 and int(k6.sum()) > 10_000
    assert int(k6[n:].sum()) == 0
    with pytest.raises(ValueError):   # a view that starts off a 16-byte boundary
        hamming_cuda.scan_row_counts_pm1(
            torch.ones(v * 1024 * nbytes * 8 + 1, dtype=torch.int8,
                       device=dev)[1:].view(v, 1024, nbytes * 8),
            torch.zeros((1024, 1), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("rows", [1, 64, 65])
@pytest.mark.parametrize("width", [1, 3, 128, 130, 256, 288])
def test_k5_row_copy_matches_plain_bitwise(dev, width, rows):
    """The redesigned K5 (a warp an output row, 16-byte pieces where the
    width and both bases allow, single floats otherwise) at widths that
    take either path, and on an input that starts 4 bytes off a 16-byte
    boundary, which takes the single-float path at any width."""
    rng = np.random.default_rng(1000 * rows + width)
    flat = torch.from_numpy(rng.standard_normal(rows * 8 * width + 1)
                            .astype(np.float32)).to(dev)
    for x in (flat[:-1].view(1, rows, 8 * width),
              flat[1:].view(1, rows, 8 * width)):
        before = restack.restack.launches
        got = restack.restack(x, width)
        assert restack.restack.launches == before + 1
        want = restack.restack_plain(x, width)
        torch.cuda.synchronize()
        assert got.shape == (8 * rows, width)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k5_at_a_bandwidth_bound_size(dev):
    """(1, 8192, 8 * 288) float32, 75.5 MB each way: more output rows
    than the grid holds warps, so every warp strides over several."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 8192, 8 * 288)).astype(np.float32)).to(dev)
    before = restack.restack.launches
    got = restack.restack(x, 288)
    assert restack.restack.launches == before + 1
    want = restack.restack_plain(x, 288)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gui_scans_on_cuda_and_serves_a_dng_like_the_cpu(dev, tmp_path,
                                                          monkeypatch):
    """The web GUI in process on the card: its worker thread scans a
    directory of 300 textured PNGs with a planted pair and a preview-less
    DNG with a PNG twin (more than 256 hashes, so the edge search runs on
    the card), launching K1, K3 and K4 from that thread; /api/image of
    the DNG from 4 threads at once matches the port's CPU rendition
    within the demosaic's bound (at most 1 u8 level on at most 1e-4 of
    the values); quit ends the server."""
    import concurrent.futures
    import sys
    from pathlib import Path

    from PIL import Image

    sys.path.insert(0, str(Path(__file__).parent))
    from torch_child import gui_in_thread, png16

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import chip_smoke
    from rupphash_tpu_torch import cli
    from rupphash_tpu_torch.pipeline import decode

    monkeypatch.setenv("RUPPHASH_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.setenv("RUPPHASH_CACHE_DIR", str(tmp_path / "cache"))
    d = tmp_path / "photos"
    d.mkdir()
    rng = np.random.default_rng(11)
    for k in range(297):
        Image.fromarray(chip_smoke.textured_rgb(rng, (160, 120))).save(
            d / f"t_{k:03d}.png", compress_level=1)
    Image.open(d / "t_005.png").save(d / "t_005_copy.jpg", quality=92)
    rgb, dng = chip_smoke.dng_scene(rng)
    (d / "raw.dng").write_bytes(dng)
    Image.fromarray(rgb).save(d / "raw_twin.png")
    for fn in (pdq_cuda.pdq_hash, hamming_cuda.scan_row_counts,
               hamming_cuda.extract_rows_packed):
        fn.launches = 0
    t, rc, gui = gui_in_thread(cli.main, [str(d)])
    snap = gui.wait_until(lambda s: s["scanning"] is None, 600)
    assert not snap["status"].startswith("scan failed"), snap["status"]
    got = sorted(sorted(f["name"] for f in g["files"]) for g in snap["groups"])
    assert got == [["raw.dng", "raw_twin.png"], ["t_005.png", "t_005_copy.jpg"]]
    assert pdq_cuda.pdq_hash.launches > 0
    assert hamming_cuda.scan_row_counts.launches == 1
    assert hamming_cuda.extract_rows_packed.launches > 0
    g, f = next((gi, fi) for gi, grp in enumerate(snap["groups"])
                for fi, x in enumerate(grp["files"]) if x["name"] == "raw.dng")
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        bodies = list(ex.map(lambda q: gui.get(
            f"/api/image?g={g}&f={f}&deep=1&s={q}"), (2048, 2047, 2046, 2045)))
    assert all(b[0] == 200 for b in bodies)
    want, _ = decode.load_image(d / "raw.dng", prefer_full_raw=True,
                                device="cpu")
    for status, _, body in bodies:
        card = png16(body).astype(np.int64)
        diff = np.abs(card - want.astype(np.int64) * 257) / 257.0
        assert card.shape == want.shape == (240, 320, 3)
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size, (
            diff.max(), np.count_nonzero(diff))
    assert gui.intent("quit")["quit"]
    t.join(60)
    assert not t.is_alive() and rc == [0]


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (the launch-device repair and "
                    "a mesh across real cards)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_the_tensors_device(two_cards):
    """Tensors on cuda:1 while cuda:0 is current: K1, K2, K3, K4 and K5
    launch on cuda:1 and equal their plain versions there."""
    cuda0, cuda1 = two_cards
    torch.cuda.set_device(cuda0)
    k1 = pdq_cuda.pdq_hash(*_k1_args(cuda1))
    p1 = pdq_cuda.pdq_hash_plain(*_k1_args(cuda1))
    assert k1["dihedral"].device == cuda1
    assert torch.equal(k1["dihedral"], p1["dihedral"])
    lumas = _k1_args(cuda1, b=4, rows=240, cols=320)[0]
    assert torch.equal(pdq_hybrid.pdq_hash_batch_hybrid(lumas)["dihedral"],
                       pdq_hybrid.pdq_hash_batch_hybrid_plain(lumas)[
                           "dihedral"])
    rng = np.random.default_rng(5)
    n = 3000
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    base[10] = base[2900]
    var_bits, low, _, _ = hamming_cuda.prepare_inputs(base, None, None)
    var_bits, low = var_bits.to(cuda1), low.to(cuda1)
    kc = hamming_cuda.scan_row_counts(var_bits, low, sim=31, n_total=n)
    assert torch.equal(kc, hamming_cuda.scan_row_counts_plain(
        var_bits, low, sim=31, n_total=n))
    rows = torch.tensor([10, 0, n - 1], device=cuda1)
    args = (var_bits.index_select(1, rows), var_bits[0], low[rows], low,
            rows.to(torch.int32)[:, None])
    assert torch.equal(
        hamming_cuda.extract_rows_packed(*args, sim=31, n_total=n),
        hamming_cuda.extract_rows_packed_plain(*args, sim=31, n_total=n))
    x = torch.randn((1, 64, 8 * 288), device=cuda1)
    assert torch.equal(restack.restack(x, 288), restack.restack_plain(x, 288))
    torch.cuda.synchronize(cuda1)
    assert torch.cuda.current_device() == 0


def _mesh_edges_case(n, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for a, b in ((5, n - 3), (n // 2, n // 2 + 1), (n // 3, 2 * n // 3)):
        base[b] = base[a]
    var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    var[:, 0] = base
    var[n // 4, 6] = base[n - 10]
    low = rng.random(n) < 0.05
    return base, var, low


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_search_on_a_virtual_mesh_equals_one_device(dev, n_dev):
    """A mesh that repeats the one card: the cells' K3 counts sum to one
    K3 launch's, one launch per cell that holds a pair, and the edges
    equal the one-device search's."""
    from rupphash_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(n_dev, devices=[dev] * n_dev)
    n = 20_000
    base, var, low = _mesh_edges_case(n)
    inputs = sharded.mesh_inputs(mesh, var, low)
    before = hamming_cuda.scan_row_counts.launches
    got = sharded.sharded_row_counts(mesh, 40)(inputs)
    cells = 3 if n_dev == 4 else 1       # the (1, 0) block lies under the diagonal
    assert hamming_cuda.scan_row_counts.launches - before == cells
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(
        base, var, low)
    want = hamming_cuda.scan_row_counts(var_bits, low_d, sim=40, n_total=n)
    assert torch.equal(got[:n], want[:n, 0])
    ei, ej = sharded.sharded_find_edges(mesh, base, var, low, 40)
    fi, fj = hamming.find_edges_fast(base, var, low, similarity=40)
    assert sorted(zip(ei.tolist(), ej.tolist())) == \
        sorted(zip(fi.tolist(), fj.tolist()))
    # the engine's route: the scan's rows as a tensor on the card
    ri, rj = sharded.sharded_find_edges(
        mesh, None, torch.from_numpy(var).to(dev), low, 40)
    assert sorted(zip(ri.tolist(), rj.tolist())) == \
        sorted(zip(fi.tolist(), fj.tolist()))
    lumas = _k1_args(dev, b=16, rows=240, cols=320)[0]
    out = sharded.sharded_pdq_hasher(mesh, 240, 320)(lumas)
    assert torch.equal(out["dihedral"],
                       pdq_torch.pdq_hash_batch(lumas)["dihedral"])


def test_sharded_search_across_two_cards(two_cards):
    from rupphash_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(devices=list(two_cards))
    assert mesh.shape == {"q": 1, "b": 2}
    base, var, low = _mesh_edges_case(5000)
    ei, ej = sharded.sharded_find_edges(mesh, base, var, low, 40)
    fi, fj = hamming.brute_force_edges(base, var, low, 40)
    assert sorted(zip(ei.tolist(), ej.tolist())) == \
        sorted(zip(fi.tolist(), fj.tolist()))
    # rows resident on the first card reach the second by a peer copy
    ri, rj = sharded.sharded_find_edges(
        mesh, None, torch.from_numpy(var).to(two_cards[0]), low, 40)
    assert sorted(zip(ri.tolist(), rj.tolist())) == \
        sorted(zip(fi.tolist(), fj.tolist()))

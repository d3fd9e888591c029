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

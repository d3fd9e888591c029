"""Hardware validation suite of the port (not pytest: the test suite runs
on the CPU, and this validates the card).

Run on a machine with a CUDA card:

    python -m rupphash_tpu_torch.tools.selftest [--device cpu]

Counterpart of rupphash_tpu/tools/tpu_selftest.py, with the same checks
in the same order, each against the numpy goldens:
  1. PDQ: bench.jpg fixture hash + quality (bit parity)
  2. PDQ (K1): randomized batch vs golden
  3. Mixed-shape batch path (K1) vs golden
  4. Hybrid kernel (K2) vs K1 (dihedral bit-exact)
  5. pHash vs golden (64-bit exact)
  6. Grouping count sweep (K3): planted duplicate
  7. Serve query op: exact query through HashIndex
  8. find_edges_fast (K3 + K4) planted edges
  9. Native raw codecs vs their Python oracles, native AEAD and the
     fused decoder probes (host code, reused from rupphash_tpu)
Without a card it exits 3 unless --device cpu asks it to validate the
plain CPU path.  Before the summary it prints each kernel's launches.
Exit codes: 0 all checks pass, 1 a check failed, 3 no card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import launches_line, pick_device

FIXTURE = "/root/reference/tests/bench.jpg"
KERNELS = ("pdq_hash_kernel", "pdq_coeffs_kernel", "hamming_rowcount_kernel",
           "hamming_extract_kernel")


def _host_checks(rng, check):
    """Checks 9+: native raw codecs, AEAD and fused decoder probes, as the
    reference's self-test runs them (host code of rupphash_tpu)."""
    try:
        from rupphash_tpu import native
        from rupphash_tpu.pipeline import rawcontainers as rc
        stream = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
        curve = np.arange(0x4000, dtype=np.uint16)
        vp = np.array([600, 600, 600, 600], dtype=np.uint16)
        a = native.nef_huff_decode(stream, vp, curve, 16, 8, 2)
        b = rc._nef_decode_py(stream, vp, curve, 16, 8, 2)
        check("NEF 34713 C++ vs Python oracle",
              a is not None and np.array_equal(a, b))
        curve2 = rc.sony_curve_lut(None)
        s2 = rng.integers(0, 256, 64 * 4, dtype=np.uint8).tobytes()
        c = native.arw2_decode(s2, curve2, 64, 4)
        d = rc._arw2_decode_py(s2, curve2, 64, 4)
        check("ARW2 C++ vs Python oracle",
              c is not None and np.array_equal(c, d))
        s3 = rng.integers(0, 256, 0x4000, dtype=np.uint8).tobytes()
        e1 = native.rw2_decode(s3, 56, 6)
        e2 = rc._rw2_decode_py(s3, 56, 6)
        check("RW2 C++ vs Python oracle",
              e1 is not None and np.array_equal(e1, e2))
        s4 = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        f1 = native.orf_decode(s4, 20, 6)
        f2 = rc._orf_decode_py(s4, 20, 6)
        check("ORF C++ vs Python oracle",
              f1 is not None and np.array_equal(f1, f2))
        from rupphash_tpu.pipeline import cr3 as cr3mod
        g1 = native.crx_decode_plane(s4, 12, 6, 12)
        g2 = cr3mod.crx_decode_plane_py(s4, 12, 6, 12)
        check("CRX plane C++ vs Python oracle",
              (g1 is None and g2 is None)
              or (g1 is not None and g2 is not None
                  and np.array_equal(g1, g2)))

        def _same(a, b):
            return (a is None and b is None) or \
                (a is not None and b is not None and np.array_equal(a, b))
        s5 = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
        w1 = native.crx_decode_plane_wavelet(s5, [100, 100, 100, 100],
                                             10, 8, 12, 1, False)
        w2 = cr3mod.crx_decode_plane_wavelet_py(
            s5, [100, 100, 100, 100], 10, 8, 12, 1, False)
        check("CRX wavelet C++ vs Python oracle", _same(w1, w2))
        xt = np.tile(np.array([[0, 1], [1, 2]], np.uint8), (3, 3))
        hdr = (bytes([0x49, 0x53, 1, 0, 12]) + (6).to_bytes(2, "big")
               + (12).to_bytes(2, "big") + (12).to_bytes(2, "big")
               + (12).to_bytes(2, "big") + bytes([1])
               + (6).to_bytes(2, "big"))
        body = rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
        s6 = hdr + len(body).to_bytes(4, "big") + body
        r1 = native.raf_decode(s6, 12, 6, xt)
        r2 = rc.raf_compressed_decode_py(s6, 12, 6, xt)
        check("compressed RAF C++ vs Python oracle", _same(r1, r2))
        s7 = rng.integers(0, 256, 2 * 16 * 6, dtype=np.uint8).tobytes()
        v1 = native.rw2_v6_decode(s7, 22, 6)
        v2 = rc.rw2_v6_decode_py(s7, 22, 6)
        check("RW2 v6 C++ vs Python oracle", _same(v1, v2))
        s8 = rng.integers(0, 256, 2 * 16 * 6, dtype=np.uint8).tobytes()
        u1 = native.rw2_v7_decode(s8, 18, 6, 14)
        u2 = rc.rw2_v7_decode_py(s8, 18, 6, 14)
        check("RW2 v7 C++ vs Python oracle", _same(u1, u2))
    except Exception as e:
        check(f"native raw codecs ({type(e).__name__})", False)

    try:
        import secrets

        from cryptography.hazmat.primitives.ciphers.aead import \
            ChaCha20Poly1305

        from rupphash_tpu import native
        from rupphash_tpu.cache import crypto as ccrypto
        if native.get_lib() is not None:
            key = secrets.token_bytes(32)
            nonce = secrets.token_bytes(24)
            pt = secrets.token_bytes(777)
            sub, n12 = ccrypto._subkey_nonce(key, nonce)
            ref = ChaCha20Poly1305(sub).encrypt(n12, pt, b"aad")
            ok = native.xchacha_seal(key, nonce, pt, b"aad") == ref \
                and native.xchacha_open(key, nonce, ref, b"aad") == pt
            try:
                native.xchacha_open(key, nonce, ref[:-1] + bytes(
                    [ref[-1] ^ 1]), b"aad")
                ok = False
            except native.NativeTagError:
                pass
            check("native AEAD vs cryptography wheel", ok)
        else:
            print("  [skip] native AEAD unavailable (Python envelope)")
    except Exception as e:
        check(f"native AEAD ({type(e).__name__})", False)

    for label, modname in (("JPEG", "jpegfast"), ("PNG", "pngfast"),
                           ("WebP", "webpfast")):
        try:
            import importlib
            mod = importlib.import_module(f"rupphash_tpu.native.{modname}")
            if mod.available():
                check(f"fused {label} probe self-equality", True)
            else:
                print(f"  [skip] fused {label} probe unavailable "
                      "(PIL path)")
        except Exception as e:
            check(f"fused {label} probe ({type(e).__name__})", False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rupphash_tpu_torch.tools.selftest",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="cpu validates the plain CPU path; default: the card")
    args = ap.parse_args(argv)
    dev = pick_device(args.device, "the self-test")
    if dev is None:
        return 3

    import torch

    from rupphash_tpu.ops import pdq_ref, phash_ref

    from .. import serve
    from ..ops import hamming, hamming_cuda, pdq_hybrid, pdq_torch, phash_torch

    print(f"device: {dev}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices: {torch.cuda.device_count()}")
    if dev.type == "cpu":
        print("warning: no accelerator — validating the CPU path")
    failures = 0

    def check(name, ok):
        nonlocal failures
        print(f"  [{'OK' if ok else 'FAIL'}] {name}")
        failures += 0 if ok else 1

    # 1. fixture parity
    try:
        from PIL import Image
        img = np.asarray(Image.open(FIXTURE).convert("RGB"))
        luma = pdq_ref.prepare_luma(img)
        gold, gq = pdq_ref.generate_pdq(img)
        out = pdq_torch.pdq_hash_batch(np.asarray(luma)[None])
        check("bench.jpg hash parity",
              bytes(out["hash"][0].cpu().numpy()) == gold)
        check("bench.jpg quality parity",
              abs(float(out["quality"][0]) - gq) < 1e-6)
    except (FileNotFoundError, ImportError, OSError) as e:
        print(f"  [SKIP] bench.jpg fixture unavailable ({type(e).__name__})")

    # 2. randomized batch (K1)
    rng = np.random.default_rng(0)
    lumas = rng.integers(0, 256, (32, 512, 288), dtype=np.uint8)
    out = pdq_torch.pdq_hash_batch(lumas)
    hashes = out["hash"].cpu().numpy()
    ok = all(bytes(hashes[i])
             == pdq_ref.coeffs_to_hash(pdq_ref.pdq_from_luma(lumas[i])[0])
             for i in range(8))
    check("randomized K1 batch vs golden", ok)

    # 3. mixed shapes (K1)
    mixed = [rng.integers(0, 256, (h, w), dtype=np.uint8)
             for h, w in [(512, 288), (384, 512), (96, 128)]]
    mo = pdq_torch.pdq_hash_batch_mixed(mixed)
    mh = mo["hash"].cpu().numpy()
    ok = all(bytes(mh[i])
             == pdq_ref.coeffs_to_hash(pdq_ref.pdq_from_luma(mixed[i])[0])
             for i in range(len(mixed)))
    check("mixed-shape batch vs golden", ok)

    # 4. hybrid kernel (K2) vs K1
    try:
        hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas[:16])
        check("hybrid kernel K2 dihedral vs K1",
              torch.equal(hyb["dihedral"], out["dihedral"][:16]))
    except Exception as e:
        check(f"hybrid kernel K2 ({type(e).__name__})", False)

    # 5. pHash
    small = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    res = phash_torch.phash_batch(small[None])
    got = phash_torch.u64_from_bytes(res["hash"][0].cpu().numpy())
    check("pHash vs golden",
          got == phash_ref.phash_from_luma32(small.astype(np.float32)))

    # 6. grouping count sweep (K3)
    try:
        hashes = rng.integers(0, 256, (2048, 32), dtype=np.uint8)
        hashes[1500] = hashes[300]
        counts, n = hamming_cuda.row_match_counts(hashes, similarity=4)
        check("K3 grouping planted pair",
              int(counts.sum()) == 1 and counts[300] == 1)
    except Exception as e:
        check(f"K3 grouping ({type(e).__name__})", False)

    # 7. serve query op
    base = rng.integers(0, 256, (512, 32), dtype=np.uint8)
    qv = np.repeat(base[7][None, None], 8, axis=1)
    ix = serve.HashIndex()
    for i, h in enumerate(base):
        ix.add(f"/x/{i}", bytes(h), 90)
    hits = ix.query(qv, similarity=0)[0]
    check("serve exact query", len(hits) >= 1 and hits[0][0] == 7
          and hits[0][2] == 0)

    # 8. end-to-end edge search on the production path (K3 + K4)
    try:
        hashes = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
        hashes[4000] = hashes[123]
        hashes[2048] = hashes[123]
        ei, ej = hamming.find_edges_fast(hashes, similarity=0)
        got = set(zip(ei.tolist(), ej.tolist()))
        check("find_edges_fast planted cluster",
              got == {(123, 2048), (123, 4000), (2048, 4000)})
    except Exception as e:
        check(f"find_edges_fast ({type(e).__name__})", False)

    # 9. host code: native codecs, AEAD, fused decoder probes
    _host_checks(rng, check)

    print(launches_line(KERNELS))
    print(f"{'PASS' if failures == 0 else 'FAIL'} ({failures} failing checks)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

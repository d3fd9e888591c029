"""The port's HashIndex vs the JAX package's: the same add / remove /
query sequence gives identical results, device traffic stays O(delta),
and index files load in either package."""
import threading

import numpy as np
import pytest

from rupphash_tpu import serve as jserve
from rupphash_tpu_torch import device
from rupphash_tpu_torch import serve as tserve


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def _flip(h: bytes, positions) -> bytes:
    o = bytearray(h)
    for p in positions:
        o[p // 8] ^= 1 << (p % 8)
    return bytes(o)


def _q(h, v=8):
    return np.frombuffer(bytes(h), dtype=np.uint8)[None, None, :].repeat(v, 1)


def _script(ix, mod, rng_seed=11):
    """One mixed sequence; returns every query's result and the upload
    bytes each phase cost."""
    rng = np.random.default_rng(rng_seed)
    hs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8).tolist())
          for _ in range(1300)]
    out = []
    for i in range(1200):
        # quality: low (< 50) on every 7th entry
        ix.add(f"/c/{i}.png", hs[i], quality=10 if i % 7 == 3 else 90)
    tie = hs[0]
    for k in range(5):                      # equal-distance ties
        ix.add(f"/tie/{k}.png", tie, quality=90)
    ix.add("/near.png", _flip(tie, [1, 70]), quality=90)     # distance 2
    ix.add("/nearlow.png", _flip(tie, [5]), quality=20)      # gated: low
    out.append(ix.query(_q(tie), similarity=4, max_results=8))
    out.append(ix.query(_q(hs[3]), similarity=0))            # low, exact
    out.append(ix.query(_q(_flip(hs[3], [0])), similarity=8))  # low, near
    out.append(ix.query(np.stack([_q(hs[i])[0] for i in (10, 500, 1199)]),
                        similarity=0))
    push = mod.UPLOAD_BYTES
    for j in range(30):                     # appends: O(delta)
        ix.add(f"/n/{j}.png", hs[1200 + j], quality=90)
        out.append(ix.query(_q(hs[1200 + j]), similarity=3))
    added = mod.UPLOAD_BYTES - push
    push = mod.UPLOAD_BYTES
    for j in range(0, 40, 2):               # tombstones: O(delta)
        assert ix.remove(f"/c/{j}.png") == 1
        out.append(ix.query(_q(hs[j]), similarity=0))
    assert ix.remove("/no/such") == 0
    removed = mod.UPLOAD_BYTES - push
    out.append(ix.query(_q(hs[41]), similarity=0))   # live-compacted index
    for j in range(40, 900):                # past 50% dead: compaction
        ix.remove(f"/c/{j}.png")
    out.append(ix.query(_q(hs[1000]), similarity=0))
    out.append(ix.query(_q(tie), similarity=10_000, max_results=100))
    out.append((len(ix), ix._n_dead, list(ix.paths[:5])))
    return out, added, removed


def test_same_sequence_same_results():
    jix, tix = jserve.HashIndex(), tserve.HashIndex()
    want, jadd, jrem = _script(jix, jserve)
    got, tadd, trem = _script(tix, tserve)
    assert got == want
    # spot checks of what the sequence covers
    assert [i for i, _, _ in got[0][0][:5]] == [0, 1200, 1201, 1202, 1203]
    assert all(d == 0 for _, _, d in got[0][0][:5])
    assert ("/near.png" in {p for _, p, _ in got[0][0]}
            and "/nearlow.png" not in {p for _, p, _ in got[0][0]})
    assert got[1][0] and got[1][0][0][1] == "/c/3.png"    # low matches at 0
    assert got[2] == [[]]                                 # ... and only at 0
    assert got[-1][1] == 0                                # compacted
    # O(delta): 30 single-row syncs and 20 tombstones, never the corpus
    # (1,207 rows x 33 bytes); the port uploads no padding rows
    assert tadd < 30 * 4096 and trem < 20 * 4096
    assert tadd <= jadd and trem <= jrem


def test_empty_index_and_clamped_radius():
    tix = tserve.HashIndex()
    assert tix.query(np.zeros((2, 8, 32), np.uint8)) == [[], []]
    for i in range(5):
        tix.add(f"/f/{i}.png", bytes([i]) * 32, quality=90)
    tix.add("/lowq.png", bytes([250]) * 32, quality=10)
    hits = tix.query(np.zeros((1, 8, 32), np.uint8), similarity=10_000)[0]
    assert {i for i, _, _ in hits} <= set(range(5))
    assert not any(p == "/lowq.png" for _, p, _ in hits)
    with pytest.raises(TypeError, match="Mesh"):
        tix.query(np.zeros((1, 8, 32), np.uint8), mesh=object())
    with pytest.raises(ValueError):
        tix.add("/bad.png", b"\x00" * 8)


def test_phash_width_index():
    """An 8-byte (pHash) index: queries gate and rank as for PDQ."""
    rng = np.random.default_rng(4)
    jix, tix = jserve.HashIndex(nbytes=8), tserve.HashIndex(nbytes=8)
    hs = [bytes(rng.integers(0, 256, 8, dtype=np.uint8).tolist())
          for _ in range(50)]
    for ix in (jix, tix):
        for i, h in enumerate(hs):
            ix.add(f"/p/{i}", h, quality=90)
        ix.add("/p/near", _flip(hs[9], [3]), quality=90)
    q = np.stack([_q(hs[9])[0], _q(hs[20])[0]])
    assert tix.query(q, similarity=2) == jix.query(q, similarity=2)
    assert [p for _, p, _ in tix.query(q, similarity=2)[0]] == ["/p/9", "/p/near"]


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_index_files_interoperate(tmp_path, saver):
    rng = np.random.default_rng(5)
    src = (jserve if saver == "jax" else tserve).HashIndex()
    hs = rng.integers(0, 256, (20, 32), dtype=np.uint8)
    for i in range(20):
        src.add(f"/i/{i}.png", bytes(hs[i]), quality=30 + 3 * i)
    src.remove("/i/4.png")
    path = tmp_path / "index.npz"
    src.save(path)
    for mod in (jserve, tserve):
        ix = mod.HashIndex.load(path)
        assert len(ix) == 19 and "/i/4.png" not in ix.paths
        assert np.array_equal(ix.hashes, np.delete(hs, 4, axis=0))
        assert ix.quality.tolist() == [30 + 3 * i for i in range(20) if i != 4]
        assert ix.query(_q(hs[7]), similarity=0)[0][0][:2] == (6, "/i/7.png")


def test_snapshot_survives_concurrent_mutation():
    """A query racing add/remove sees a consistent snapshot: every hit's
    index, path and distance agree (device updates write into clones)."""
    ix = tserve.HashIndex()
    rng = np.random.default_rng(30)
    hs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8).tolist())
          for _ in range(64)]
    for i, h in enumerate(hs):
        ix.add(f"/s/{i}.png", h, quality=90)
    stop = threading.Event()
    errors = []

    def churn():
        k = 64
        while not stop.is_set():
            try:
                ix.add(f"/s/{k}.png", hs[k % 64], quality=90)
                ix.remove(f"/s/{k}.png")
                k += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        for q in range(40):
            hits = ix.query(_q(hs[q % 64]), similarity=0)[0]
            assert hits
            for idx, path, dist in hits:
                assert path.startswith("/s/") and dist == 0
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and not errors


# ---------------------------------------------------------------- service
# Each test below mirrors one of tests/test_serve.py (:113-330, :576):
# the same requests go to the JAX package's NearDupService and to the
# port's, and the two answers are compared.  PNG, JPEG and PDF bodies
# must give identical JSON.  A DNG body is demosaiced by each package's
# own pipeline (XLA vs the port's fixed-order PyTorch stencils, within
# one u8 level on a few pixels), so its hash may differ by a few bits:
# the matched paths must be equal and each distance within
# _DNG_DIST_TOL of the reference's.

import io
import json
import pathlib
import sys
import urllib.error
import urllib.request
from contextlib import contextmanager

from PIL import Image

_DNG_DIST_TOL = 2


def _photo(seed, size=(320, 240)):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(base).resize(size, Image.BILINEAR))


def _encoded(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four textured PNGs scanned by both packages; the records' hashes
    and qualities must agree."""
    from rupphash_tpu.pipeline import scan as jscan
    from rupphash_tpu_torch.pipeline import scan as tscan

    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i in range(4):
        p = d / f"img{i}.png"
        Image.fromarray(_photo(i)).save(p)
        paths.append(p)
    jrec, jst = jscan.scan(paths, jscan.ScanConfig())
    trec, tst = tscan.scan(paths, tscan.ScanConfig())
    assert jst.failed == tst.failed == 0
    # records arrive in decode-completion order: index them by path
    jrec, trec = (sorted(r, key=lambda rec: rec.path) for r in (jrec, trec))
    assert ([(r.path, r.pdqhash, r.pdq_quality) for r in trec]
            == [(r.path, r.pdqhash, r.pdq_quality) for r in jrec])
    return d, paths, {jserve: jrec, tserve: trec}


def _both(fn):
    """fn(serve module) for the JAX package and the port; asserts the
    results are equal and returns the port's."""
    want, got = fn(jserve), fn(tserve)
    assert got == want
    return got


def test_index_build_save_load(corpus, tmp_path):
    d, paths, records = corpus

    def run(mod):
        ix = mod.HashIndex.from_records(records[mod])
        f = tmp_path / f"{mod.__name__}.npz"
        ix.save(f)
        ix2 = mod.HashIndex.load(f)
        assert np.array_equal(ix.hashes, ix2.hashes)
        return len(ix2), ix2.paths, ix2.hashes.tolist(), ix2.quality.tolist()

    assert _both(run)[0] == 4


def test_query_finds_reencoded_and_rotated(corpus):
    d, paths, records = corpus
    bodies = [(_encoded(_photo(2), "JPEG", quality=90), None),
              (_encoded(np.rot90(_photo(1)), "PNG"), None),
              (_encoded(_photo(99), "PNG"), 10),
              (b"not an image", None)]

    def run(mod):
        svc = mod.NearDupService(mod.HashIndex.from_records(records[mod]))
        return [svc.query_bytes(b, similarity=s) for b, s in bodies]

    got = _both(run)
    assert got[0]["matches"][0]["path"].endswith("img2.png")
    assert got[0]["matches"][0]["distance"] <= 16
    assert got[1]["matches"][0]["path"].endswith("img1.png")
    assert got[2]["matches"] == [] and got[3] is None


def test_low_quality_index_entries_gate_to_exact(corpus):
    d, paths, records = corpus

    def run(mod):
        h = bytes(mod.HashIndex.from_records(records[mod]).hashes[0])
        ix = mod.HashIndex()
        ix.add("lowq.png", h, quality=10)   # below PDQ_MIN_QUALITY
        var = np.asarray(records[mod][0].dihedral, dtype=np.uint8)
        exact = ix.query(var[None], similarity=40)[0]
        h2 = bytearray(h)
        h2[0] ^= 1
        var2 = var.copy()
        var2[:] = np.frombuffer(bytes(h2), dtype=np.uint8)
        return exact, ix.query(var2[None], similarity=40)[0]

    exact, near = _both(run)
    assert exact and exact[0][2] == 0 and near == []


def test_incremental_add(corpus):
    d, paths, records = corpus
    body = _encoded(_photo(3), "JPEG", quality=92)

    def run(mod):
        svc = mod.NearDupService(mod.HashIndex.from_records(records[mod][:2]))
        return svc.add_path(str(paths[3])), svc.query_bytes(body)

    added, res = _both(run)
    assert added["size"] == 3
    assert res["matches"][0]["path"].endswith("img3.png")


@contextmanager
def _served(svc):
    httpd, port = svc.serve()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield port
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _call(port, path, data=None, headers=None):
    """(status, decoded JSON body) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_surface(corpus):
    d, paths, records = corpus
    jpeg = _encoded(_photo(0), "JPEG", quality=95)
    oversize = {"Content-Length": str(tserve.NearDupService.MAX_BODY + 1)}
    requests = [("/v1/stats", None, None),
                ("/v1/query?similarity=31", jpeg, None),
                (f"/v1/add?path={paths[1]}", b"", None),
                ("/v1/query", b"junk", None),
                ("/v1/add?path=/etc/passwd", b"", None),
                ("/v1/remove?path=/etc/passwd", b"", None),
                ("/v1/add?path=%00x", b"", None),
                ("/v1/query", b"x", oversize),
                ("/v1/query?similarity=abc", jpeg, None),
                (f"/v1/remove?path={paths[2]}", b"", None),
                ("/v1/nope", b"", None),
                ("/v1/nope", None, None),
                ("/v1/stats", None, None)]

    def run(mod):
        svc = mod.NearDupService(mod.HashIndex.from_records(records[mod]),
                                 roots=[d])
        with _served(svc) as port:
            return [_call(port, *r) for r in requests]

    got = _both(run)
    assert [code for code, _ in got] == [200, 200, 200, 415, 403, 403, 403,
                                         400, 200, 200, 404, 404, 200]
    assert got[0][1]["indexed"] == 4 and got[0][1]["queries"] == 0
    assert got[1][1]["matches"][0]["path"].endswith("img0.png")
    assert got[2][1]["size"] == 5
    assert got[-1][1] == {"indexed": 4, "queries": 2, "similarity": 40}


def test_quality_scale_is_0_to_100(corpus):
    d, paths, records = corpus
    body = _encoded(_photo(0), "PNG")

    def run(mod):
        svc = mod.NearDupService(mod.HashIndex.from_records(records[mod]))
        variants, quality = svc.hash_bytes(body)
        return variants.tolist(), quality

    _, quality = _both(run)
    assert quality > 1.5
    assert abs(quality - records[tserve][0].pdq_quality) <= 1


def test_nonzero_distance_match_not_gated(corpus):
    """A good-quality query matches at distance > 0."""
    d, paths, records = corpus
    body = _encoded(_photo(0), "PNG")

    def run(mod):
        h = bytearray(records[mod][0].pdqhash)
        h[0] ^= 0x03
        ix = mod.HashIndex()
        ix.add("near.png", bytes(h), quality=records[mod][0].pdq_quality)
        return mod.NearDupService(ix).query_bytes(body)

    out = _both(run)
    assert out["matches"], "distance-2 match must not be gated away"
    assert 0 < out["matches"][0]["distance"] <= 4


def test_add_path_quality_scale(corpus):
    d, paths, records = corpus

    def run(mod):
        ix = mod.HashIndex()
        out = mod.NearDupService(ix).add_path(str(paths[0]))
        return out, ix.quality.tolist()

    out, quality = _both(run)
    assert out["quality"] > 1.5 and quality[0] > 1


def _dng_and_pdf(tmp_path):
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_dng import _scene, write_dng
    from test_jxl_pdf import _image_obj, _jpeg_bytes, _make_pdf

    from rupphash_tpu_torch.ops import demosaic

    rgb, mosaic = _scene(240, 320, seed=11)
    base = tmp_path / "base.png"
    Image.fromarray(rgb).save(base)
    dng = write_dng(mosaic, cm=demosaic._XYZ2SRGB)
    pdf = _make_pdf([_image_obj(320, 240, b"/DCTDecode", b"/DeviceRGB",
                                _jpeg_bytes(rgb))])
    return base, dng, pdf


def test_query_accepts_dng_and_pdf_bytes(tmp_path):
    """Bodies arrive with no filename: a preview-less DNG is demosaiced,
    a PDF's embedded photo extracted."""
    base, dng, pdf = _dng_and_pdf(tmp_path)
    out = {}
    for mod in (jserve, tserve):
        svc = mod.NearDupService(mod.HashIndex())
        svc.add_path(str(base))
        out[mod] = (svc.query_bytes(dng), svc.query_bytes(pdf))
    (jdng, jpdf), (tdng, tpdf) = out[jserve], out[tserve]
    assert tpdf == jpdf and tpdf["matches"][0]["path"].endswith("base.png")
    assert ([m["path"] for m in tdng["matches"]]
            == [m["path"] for m in jdng["matches"]])
    assert tdng["matches"][0]["path"].endswith("base.png")
    for t, j in zip(tdng["matches"], jdng["matches"]):
        assert abs(t["distance"] - j["distance"]) <= _DNG_DIST_TOL


def test_index_remove(corpus):
    d, paths, records = corpus

    def run(mod):
        ix = mod.HashIndex.from_records(records[mod])
        removed = ix.remove(str(paths[1]))
        var = np.asarray(records[mod][1].dihedral, dtype=np.uint8)
        return (removed, len(ix), ix.paths, ix.query(var[None], similarity=0),
                ix.remove("/no/such"))

    removed, n, live, res, none = _both(run)
    assert (removed, n, none) == (1, 3, 0) and str(paths[1]) not in live
    assert all(p != str(paths[1]) for _, p, _ in res[0])


def test_http_browser_attack_gates(corpus):
    """DNS-rebound Host names get 403 unless allowlisted; Origin-bearing
    mutations get 403; Origin on the read-only query is fine."""
    d, paths, records = corpus
    jpeg = _encoded(_photo(1), "JPEG", quality=95)

    def run(mod):
        ix = mod.HashIndex.from_records(records[mod])
        svc = mod.NearDupService(ix, roots=[d],
                                 allow_hosts=("photos.internal",))
        with _served(svc) as port:
            evil = {"Origin": "http://evil.example"}
            return [
                _call(port, "/v1/stats", None,
                      {"Host": f"evil.example:{port}"}),
                _call(port, "/v1/stats", None,
                      {"Host": f"photos.internal:{port}"}),
                _call(port, f"/v1/remove?path={paths[0]}", b"", evil),
                len(ix),
                _call(port, f"/v1/add?path={paths[0]}", b"", evil),
                _call(port, f"/v1/remove?path={paths[0]}", b""),
                _call(port, "/v1/query", jpeg, evil),
            ]

    got = _both(run)
    assert [g[0] for g in got if isinstance(g, tuple)] == [403, 200, 403,
                                                            403, 200, 200]
    assert got[3] == 4 and got[5][1]["removed"] == 1
    assert "matches" in got[6][1]


def test_service_refuses_a_mesh():
    """What is not a parallel.sharded.Mesh is refused by name, never
    served from one device instead."""
    with pytest.raises(TypeError, match="Mesh \\(make_mesh\\(\\)\\), got object"):
        tserve.NearDupService(tserve.HashIndex(), mesh=object())
    ix = tserve.HashIndex()
    ix.add("/a.png", bytes(32), quality=90)
    with pytest.raises(TypeError, match="got tuple"):
        ix.query(_q(bytes(32)), mesh=(4, 2))


def test_concurrent_requests_answer_as_serial(corpus):
    """Eight client threads: every answer equals the serial one, and
    the query count counts every request."""
    from concurrent.futures import ThreadPoolExecutor

    d, paths, records = corpus
    bodies = [_encoded(_photo(k % 5), "JPEG", quality=80 + k)
              for k in range(16)]
    svc = tserve.NearDupService(tserve.HashIndex.from_records(records[tserve]))
    with _served(svc) as port:
        serial = [_call(port, "/v1/query", b) for b in bodies]
        with ThreadPoolExecutor(8) as pool:
            concurrent = list(pool.map(
                lambda b: _call(port, "/v1/query", b), bodies * 2))
        stats = _call(port, "/v1/stats")
    assert concurrent == serial * 2
    assert stats[1]["queries"] == 48


def test_launch_count_survives_thread_contention():
    """The service launches kernels from one thread per request: 16
    threads counting at once, with thread switches forced as often as
    the interpreter allows, lose no increment."""
    from rupphash_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000

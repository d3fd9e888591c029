"""Mesh serving in the port (serve.HashIndex.query_mesh, NearDupService
and run_serve with several devices) against its one-device path and the
JAX package's on its 8-device virtual CPU mesh; mirrors the mesh tests
of tests/test_serve.py.  The port's virtual mesh repeats the CPU eight
times."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rupphash_tpu import serve as jserve
from rupphash_tpu.parallel import sharded as ref_sharded
from rupphash_tpu_torch import device
from rupphash_tpu_torch import serve as tserve
from rupphash_tpu_torch.parallel import sharded

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


@pytest.fixture(scope="module")
def ref_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_sharded.make_mesh(8)


def _fill(ix, hashes, low=()):
    for i, h in enumerate(hashes):
        ix.add(f"/x/{i}.png", bytes(h), quality=30 if i in low else 90)
    return ix


def _q(h):
    return np.asarray(h, np.uint8)[None, None, :].repeat(8, 1)


def test_mesh_query_matches_single_device(ref_mesh8):
    """The corpus split over every device answers exactly as one device
    and as the reference's mesh, the low-quality gate included."""
    rng = np.random.default_rng(9)
    n = 203  # odd: exercises the 8 * ndev padding
    hashes = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ix = _fill(tserve.HashIndex(), hashes, low={50})
    q = np.zeros((3, 8, 32), dtype=np.uint8)
    q[0, :] = hashes[7]
    flip = hashes[120].copy()
    flip[0] ^= 0b111
    q[1, :] = flip
    q[2, :] = hashes[50]

    mesh = sharded.make_mesh(8, devices=CPU8)
    single = ix.query(q, similarity=8)
    meshed = ix.query(q, similarity=8, mesh=mesh)
    assert single == meshed
    assert meshed[0][0][:1] == (7,) and meshed[0][0][2] == 0
    assert any(i == 120 and d == 3 for i, _, d in meshed[1])
    assert meshed[2][0][0] == 50  # gated row still matches at dist 0
    g = hashes[50].copy()
    g[0] ^= 0b1
    assert all(i != 50 for i, _, d in
               ix.query(_q(g), similarity=8, mesh=mesh)[0])
    ref = _fill(jserve.HashIndex(), hashes, low={50})
    assert meshed == ref.query(q, similarity=8, mesh=ref_mesh8)
    assert [len(h) for h, _ in ix._dev["shards"]] == [128] * 8


def test_mesh_query_radius_keeps_one_entry():
    """Clients pick the radius per request: it is an argument of each
    call, and the factory cache holds one mesh-keyed entry across every
    radius."""
    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    ix = _fill(tserve.HashIndex(), hashes)
    flip = hashes[9].copy()
    flip[0] ^= 0b11
    mesh = sharded.make_mesh(8, devices=CPU8)
    tserve._mesh_query_fn.cache_clear()
    fn = tserve._mesh_query_fn(mesh)
    for sim in (2, 5, 8, 13, 21, 34):
        res = ix.query(_q(flip), similarity=sim, mesh=mesh)[0]
        assert any(i == 9 and d == 2 for i, _, d in res)
    assert all(i != 9 for i, _, d in
               ix.query(_q(flip), similarity=1, mesh=mesh)[0])
    assert tserve._mesh_query_fn.cache_info().currsize == 1
    assert tserve._mesh_query_fn(mesh) is fn


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_mesh_incremental_mutation_is_o_delta(n_dev, ref_mesh8):
    """After the first push, adds and removes upload O(delta) bytes on
    the mesh too; answers stay exact and index-aligned with the
    one-device path and with the reference's mesh."""
    mesh = sharded.make_mesh(n_dev, devices=CPU8)
    rng = np.random.default_rng(63)
    hs = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    ix = tserve.HashIndex()
    ref = jserve.HashIndex()
    for i in range(512):
        ix.add(f"/m/{i}.png", bytes(hs[i]), quality=90)
        ref.add(f"/m/{i}.png", bytes(hs[i]), quality=90)

    def q(h, use_mesh):
        return ix.query(_q(h), similarity=4,
                        mesh=mesh if use_mesh else None)[0]

    assert q(hs[5], True)           # first mesh push
    base = tserve.UPLOAD_BYTES
    for j in range(20):
        ix.add(f"/m/n{j}.png", bytes(hs[512 + j]), quality=90)
        ref.add(f"/m/n{j}.png", bytes(hs[512 + j]), quality=90)
        res = q(hs[512 + j], True)
        assert any(p == f"/m/n{j}.png" for _, p, _ in res)
    added = tserve.UPLOAD_BYTES - base
    assert added < 20 * 4096, f"mesh adds re-shipped: {added} B"

    base = tserve.UPLOAD_BYTES
    for j in range(10):
        assert ix.remove(f"/m/{j}.png") == 1
        ref.remove(f"/m/{j}.png")
        assert all(p != f"/m/{j}.png" for _, p, _ in q(hs[j], True))
    removed = tserve.UPLOAD_BYTES - base
    assert removed < 10 * 4096, f"mesh removes re-shipped: {removed} B"

    for probe in (30, 200, 515):
        a = q(hs[probe], True)
        assert a == q(hs[probe], False), probe
        assert a == ref.query(_q(hs[probe]), similarity=4,
                              mesh=ref_mesh8)[0], probe


@pytest.mark.parametrize("n_dev", [2, 8])
def test_mesh_query_on_a_phash_width_index(n_dev, ref_mesh8):
    """An 8-byte (pHash) index answers on the mesh as on one device and as
    the reference's mesh, the radius clamped to 63."""
    rng = np.random.default_rng(81)
    hs = rng.integers(0, 256, (300, 8), dtype=np.uint8)
    hs[200] = hs[20]
    ix = tserve.HashIndex(nbytes=8)
    ref = jserve.HashIndex(nbytes=8)
    for k, h in enumerate(hs):
        ix.add(f"/p/{k}.png", bytes(h), quality=30 if k == 200 else 90)
        ref.add(f"/p/{k}.png", bytes(h), quality=30 if k == 200 else 90)
    mesh = sharded.make_mesh(n_dev, devices=CPU8)
    q = np.repeat(hs[[20, 7]][:, None], 8, axis=1)
    for sim in (0, 12, 1000):
        got = ix.query(q, similarity=sim, max_results=10, mesh=mesh)
        assert got == ix.query(q, similarity=sim, max_results=10)
        assert got == ref.query(q, similarity=sim, max_results=10,
                                mesh=ref_mesh8)
    assert [i for i, _, _ in ix.query(q, 0, mesh=mesh)[0]] == [20, 200]


def test_another_mesh_rebuilds_and_compaction_resets():
    rng = np.random.default_rng(5)
    hs = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    ix = _fill(tserve.HashIndex(), hs)
    m8, m2 = (sharded.make_mesh(k, devices=CPU8) for k in (8, 2))
    assert ix.query(_q(hs[3]), similarity=0, mesh=m8)[0][0][0] == 3
    assert len(ix._dev["shards"]) == 8
    assert ix.query(_q(hs[299]), similarity=0, mesh=m2)[0][0][0] == 299
    assert len(ix._dev["shards"]) == 2 and ix._dev["mesh"] is m2
    for i in range(200):
        ix.remove(f"/x/{i}.png")
    assert ix.query(_q(hs[250]), similarity=0, mesh=m2)[0] == \
        [(50, "/x/250.png", 0)]
    assert ix._n_dead == 0 and ix._dev["mesh"] is m2
    assert ix._dev["applied"] == 100
    # one residency: a query without a mesh pushes the corpus to the
    # index's device in its place, and the mesh's answer is its answer
    assert ix.query(_q(hs[250]), similarity=0)[0] == [(50, "/x/250.png", 0)]
    assert ix._dev["mesh"] is None and len(ix._dev["shards"]) == 1


def test_service_answers_on_a_mesh():
    """NearDupService(mesh=...) sends its queries through the mesh."""
    rng = np.random.default_rng(17)
    hs = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    mesh = sharded.make_mesh(4, devices=CPU8)
    svc = tserve.NearDupService(_fill(tserve.HashIndex(), hs), mesh=mesh)
    assert svc.mesh is mesh
    calls = []
    real = svc.index.query_mesh
    svc.index.query_mesh = lambda m, *a, **k: calls.append(m) or real(m, *a,
                                                                       **k)
    variants = np.repeat(hs[11][None], 8, axis=0)
    svc._hash_image = lambda img: (variants, 90.0)
    svc.hash_bytes = lambda data: svc._hash_image(None)
    out = svc.query_bytes(b"ignored")
    assert calls == [mesh]
    assert out["matches"][0] == {"path": "/x/11.png", "distance": 0,
                                 "index": 11}


def test_run_serve_shards_over_several_devices(monkeypatch, tmp_path,
                                               capsys):
    """More than one device visible: run_serve builds make_mesh() and
    says so on stderr; the service it starts holds that mesh."""
    rng = np.random.default_rng(2)
    ix = _fill(tserve.HashIndex(), rng.integers(0, 256, (10, 32), np.uint8))
    ix.save(tmp_path / "ix.npz")
    monkeypatch.setattr(sharded, "local_devices", lambda: list(CPU8))
    started = []

    class Stopped:
        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def serve(svc, host="127.0.0.1", port=0):
        started.append(svc)
        return Stopped(), 1

    monkeypatch.setattr(tserve.NearDupService, "serve", serve)
    args = SimpleNamespace(paths=[str(tmp_path)], similarity=None,
                           index_file=str(tmp_path / "ix.npz"),
                           allow_host=None, host="127.0.0.1", port=0)
    assert tserve.run_serve(args) == 0
    err = capsys.readouterr().err
    assert "corpus sharded over 8 devices (mesh {'q': 4, 'b': 2})" in err
    assert started[0].mesh.shape == {"q": 4, "b": 2}
    assert started[0].mesh.flat == CPU8

    monkeypatch.setattr(sharded, "local_devices", lambda: CPU8[:1])
    assert tserve.run_serve(args) == 0
    assert started[1].mesh is None
    assert "corpus sharded" not in capsys.readouterr().err

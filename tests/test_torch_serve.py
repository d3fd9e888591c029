"""The port's HashIndex vs the JAX package's: the same add / remove /
query sequence gives identical results, device traffic stays O(delta),
and index files load in either package."""
import threading

import numpy as np
import pytest

from rupphash_tpu import serve as jserve
from rupphash_tpu_torch import serve as tserve


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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

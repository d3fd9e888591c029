"""The port's mesh layer (rupphash_tpu_torch/parallel/sharded.py) against
the JAX package's on its 8-device virtual CPU mesh: one case for each
of tests/test_sharded.py's but test_graft_entry_contract, on the same
seeded inputs.  The port's virtual mesh repeats the CPU eight times, so each
cell runs the plain versions of K3, K4 and K1 on its block.  Exact
unless said."""
import dataclasses

import jax
import numpy as np
import pytest

from rupphash_tpu.grouping import engine as ref_engine
from rupphash_tpu.ops import hamming as ref_hamming
from rupphash_tpu.ops import pdq_jax
from rupphash_tpu.parallel import sharded as ref_sharded
from rupphash_tpu_torch import device
from rupphash_tpu_torch.grouping import engine
from rupphash_tpu_torch.ops import hamming, hamming_cuda, pdq_ref
from rupphash_tpu_torch.parallel import sharded
from rupphash_tpu_torch.utils import trace

import torch


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh8():
    return sharded.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def ref_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_sharded.make_mesh(8)


def _pairs(ei, ej):
    return sorted(zip(np.asarray(ei).tolist(), np.asarray(ej).tolist()))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape(n, ref_mesh8):
    """The reference's shape rule: (n/2, 2) for even n > 1, else (n, 1)."""
    mesh = sharded.make_mesh(n, devices=CPU8)
    assert mesh.shape == dict(ref_sharded.make_mesh(n).shape)
    assert mesh.size == n and mesh.flat == CPU8[:n]


def test_mesh_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="only 8 given"):
        sharded.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="needs 4 devices"):
        sharded.Mesh(CPU8[:3], 2, 2)
    with pytest.raises(ValueError, match="not among the 0 CUDA devices"):
        sharded.Mesh([torch.device("cuda", 0)], 1, 1)


def test_local_devices_on_the_cpu():
    assert sharded.local_devices() == [torch.device("cpu")]
    assert sharded.make_mesh().shape == {"q": 1, "b": 1}


def test_unpack_bits_pm1_matches_host():
    h = np.random.default_rng(0).integers(0, 256, (5, 32), dtype=np.uint8)
    dev = sharded.unpack_bits_pm1(torch.from_numpy(h)).numpy()
    assert np.array_equal(dev, ref_hamming.pm1_encode(h))
    ref = np.asarray(ref_sharded.unpack_bits_pm1(jax.numpy.asarray(h)))
    assert np.array_equal(dev, ref)


def test_sharded_hash_matches_single_device(mesh8):
    rng = np.random.default_rng(2)
    rows, cols = 128, 96
    lumas = rng.integers(0, 256, (16, rows, cols), dtype=np.uint8)
    out = sharded.sharded_pdq_hasher(mesh8, rows, cols)(lumas)
    single = pdq_jax.pdq_hash_batch(lumas)
    assert np.array_equal(out["hash"].numpy(), np.asarray(single["hash"]))
    assert np.array_equal(out["dihedral"].numpy(),
                          np.asarray(single["dihedral"]))
    assert np.abs(out["quality"].numpy()
                  - np.asarray(single["quality"])).max() <= 1e-6
    with pytest.raises(ValueError, match="k \\* 8"):
        sharded.sharded_pdq_hasher(mesh8, rows, cols)(lumas[:12])


def _planted(seed, n, pairs):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for a, b in pairs:
        base[a] = base[b]
    return base, np.repeat(base[:, None, :], 8, axis=1), np.zeros(n, bool)


@pytest.mark.parametrize("seed,n,pairs", [(3, 64, [(10, 50)]),
                                          (5, 61, [(7, 33)])],
                         ids=["even", "odd"])
def test_sharded_group_counts_match_oracle(mesh8, ref_mesh8, seed, n, pairs):
    """Totals equal the brute-force edge count and the reference's; N not
    divisible by the mesh axes pads, and pad rows never match."""
    base, variants, low = _planted(seed, n, pairs)
    counts = sharded.sharded_group_counts(mesh8, similarity=8)(variants, low)
    assert tuple(counts.shape) == (4, 2) and counts.dtype == torch.int32
    oi, _ = ref_hamming.brute_force_edges(base, variants, low, similarity=8)
    ref = np.asarray(ref_sharded.sharded_group_counts(
        ref_mesh8, similarity=8)(variants, low))
    assert int(counts.sum()) == len(oi) == int(ref.sum()) >= 1


def test_sharded_row_counts_match_oracle(mesh8, ref_mesh8):
    base, variants, low = _planted(6, 96, [(3, 40), (4, 77)])
    run = sharded.sharded_row_counts(mesh8, similarity=8)
    counts = run(sharded.mesh_inputs(mesh8, variants, low)).numpy()[:96]
    oi, _ = ref_hamming.brute_force_edges(base, variants, low, similarity=8)
    expect = np.bincount(oi, minlength=96)
    assert np.array_equal(counts, expect)
    ref = np.asarray(ref_sharded.sharded_row_counts(
        ref_mesh8, similarity=8)(variants, low))[:96]
    assert np.array_equal(counts, ref)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_row_counts_sum_to_one_sweep(n_dev):
    """The cells' partial counts, summed over 'b', are one sweep's counts
    on every mesh shape, with variants and low-confidence rows."""
    rng = np.random.default_rng(40 + n_dev)
    n = 1500
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for a, b in ((3, 1400), (700, 701), (90, 1200), (1201, 90)):
        base[a] = base[b]
    variants = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    variants[:, 0] = base
    variants[500, 4] = base[900]
    low = rng.random(n) < 0.1
    mesh = sharded.make_mesh(n_dev, devices=CPU8)
    got = sharded.sharded_row_counts(mesh, 8)(
        sharded.mesh_inputs(mesh, variants, low))
    var_bits, low_d, _, _ = hamming_cuda.prepare_inputs(base, variants, low,
                                                        len(got))
    want = hamming_cuda.scan_row_counts(var_bits, low_d, sim=8, n_total=n)
    assert torch.equal(got, want[:, 0])


@pytest.mark.parametrize("n", [2, 1025, 9000])
@pytest.mark.parametrize("nq,nb", [(1, 1), (2, 1), (4, 2), (3, 2)])
def test_cut_work_lists_cover_each_tile_once(nq, nb, n):
    """K3's work list cut to each cell's block: every base tile of the
    uncut list lies in exactly one cell's list, and no cut item has a
    tile wholly on or below the diagonal."""
    npad = sharded._mesh_npad(n, nq, nb)
    qsz, bsz = npad // nq, npad // nb
    want = sorted((q0, b0) for q0, b0, _ in hamming_cuda.sweep_tiles(
        hamming_cuda.sweep_items(n, npad)))
    got = []
    for q in range(nq):
        for b in range(nb):
            items = hamming_cuda.sweep_items(
                n, npad, (q * qsz, (q + 1) * qsz, b * bsz, (b + 1) * bsz))
            assert (items[:, 2] > items[:, 0] + 1).all()
            got += [(q0, b0) for q0, b0, _ in hamming_cuda.sweep_tiles(items)]
            if (b + 1) * bsz <= q * qsz + 1:
                assert len(items) == 0     # wholly below the diagonal
    assert sorted(got) == want
    with pytest.raises(ValueError, match="off K3's grid"):
        hamming_cuda.sweep_items(n, npad, (0, 100, 0, npad))


def _find_edges_case():
    rng = np.random.default_rng(7)
    n = 203  # deliberately not divisible by anything relevant
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for i in (17, 59, 131, 202):
        base[i] = base[4]
    noise = base[59].copy()
    noise[0] ^= 0b111  # 3-bit flip stays within similarity
    base[59] = noise
    variants = np.repeat(base[:, None, :], 8, axis=1)
    variants[90, 3] = base[100]   # a match through variant 3 only
    low = np.zeros(n, dtype=bool)
    low[131] = True  # gated to exact-only
    return base, variants, low


@pytest.mark.parametrize("row_chunk", [1024, 3, 1])
def test_sharded_find_edges_exact_vs_oracle(mesh8, ref_mesh8, row_chunk):
    """Bit for bit the brute-force edge set and the reference's, with
    dihedral variants, the low-quality gate, odd N and chunks of hot
    rows down to one row (clamped to the mesh's q extent)."""
    base, variants, low = _find_edges_case()
    ei, ej = sharded.sharded_find_edges(mesh8, base, variants, low,
                                        similarity=8, row_chunk=row_chunk)
    oi, oj = ref_hamming.brute_force_edges(base, variants, low, similarity=8)
    ri, rj = ref_sharded.sharded_find_edges(ref_mesh8, base, variants, low,
                                            similarity=8, row_chunk=row_chunk)
    assert _pairs(ei, ej) == _pairs(oi, oj) == _pairs(ri, rj)
    assert len(ei) > 0 and ei.dtype == np.int64 and ej.dtype == np.int64


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 6])
def test_sharded_find_edges_on_every_mesh_shape(n_dev):
    base, variants, low = _find_edges_case()
    mesh = sharded.make_mesh(n_dev, devices=CPU8)
    ei, ej = sharded.sharded_find_edges(mesh, base, variants, low,
                                        similarity=8)
    oi, oj = hamming.brute_force_edges(base, variants, low, similarity=8)
    assert _pairs(ei, ej) == _pairs(oi, oj)


@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
def test_sharded_find_edges_at_both_widths(mesh8, nbytes, v):
    """64-bit pHash hashes as well as 256-bit PDQ, one variant or eight:
    the brute-force edge set on the 4 x 2 mesh."""
    rng = np.random.default_rng(nbytes + v)
    n = 700
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    for c, (i, j) in enumerate(rng.choice(n, (20, 2), replace=False)):
        i, j = min(i, j), max(i, j)      # query i's variant, later base j
        var[j, 0] = var[i, c % v]
        var[j, 0, c % nbytes] ^= np.uint8(c % 4)
        low[[i, j]] = c % 7 == 3
    sim = 3 if nbytes == 8 else 8
    base = np.ascontiguousarray(var[:, 0])
    ei, ej = sharded.sharded_find_edges(mesh8, base, var, low, sim)
    oi, oj = hamming.brute_force_edges(base, var, low, sim)
    assert _pairs(ei, ej) == _pairs(oi, oj) and len(oi) >= 10


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_find_edges_from_a_tensor(n_dev):
    """Variants already on a device (the scan's resident rows) give the
    numpy input's edges, with or without the base hashes beside them."""
    base, variants, low = _find_edges_case()
    mesh = sharded.make_mesh(n_dev, devices=CPU8)
    want = _pairs(*sharded.sharded_find_edges(mesh, base, variants, low,
                                              similarity=8))
    var_t = torch.from_numpy(variants)
    for b in (None, base):
        got = sharded.sharded_find_edges(mesh, b, var_t, low, similarity=8)
        assert _pairs(*got) == want and len(want) > 0
    var_t[5, 0] ^= 1
    with pytest.raises(ValueError, match="slot 0"):
        sharded.sharded_find_edges(mesh, base, var_t, low)


def test_sharded_find_edges_needs_the_base_in_slot0(mesh8):
    base, variants, low = _find_edges_case()
    variants[5, 0] ^= 1
    with pytest.raises(ValueError, match="slot 0"):
        sharded.sharded_find_edges(mesh8, base, variants, low)
    with trace.recording() as rec:
        empty = sharded.sharded_find_edges(mesh8, base[:0], return_stats=True)
    assert len(empty[0]) == 0 and empty[2] == {
        "hot_rows": 0, "readback_bytes": 0} and rec == []


def test_sharded_find_edges_readback_is_o_edges(mesh8, ref_mesh8):
    """Growing the corpus 4x with the same planted duplicates leaves the
    readback unchanged, and it counts the same bytes as the reference's."""
    def run(n, rng):
        base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        for a, b, c in ((1, 7, 13), (20, 31, 42), (50, 61, 72)):
            base[b] = base[a]
            base[c] = base[a]
        variants = np.repeat(base[:, None, :], 8, axis=1)
        low = np.zeros(n, dtype=bool)
        with trace.recording() as rec:
            ei, ej, stats = sharded.sharded_find_edges(
                mesh8, base, variants, low, similarity=8, return_stats=True)
        ri, rj, ref_stats = ref_sharded.sharded_find_edges(
            ref_mesh8, base, variants, low, similarity=8, return_stats=True)
        oi, oj = hamming.brute_force_edges(base, variants, low, similarity=8)
        assert _pairs(ei, ej) == _pairs(oi, oj) == _pairs(ri, rj)
        assert len(ei) == 9
        assert {k: stats[k] for k in ref_stats} == ref_stats
        assert [s.name for s in rec] == ["edges.count", "edges.extract"]
        return stats

    s_small = run(512, np.random.default_rng(21))
    s_large = run(2048, np.random.default_rng(22))
    assert s_small["hot_rows"] == s_large["hot_rows"] == 6
    assert s_small["readback_bytes"] == s_large["readback_bytes"]
    assert s_large["readback_bytes"] < 64 * 1024


def test_sharded_mesh_scale(mesh8):
    """The mesh-scale case of the reference (100k hashes there, about two
    minutes of single-core GEMM), cut here to 4,096 and 40,000 hashes so
    that it runs in seconds on the CPU: exact 4-cluster across the
    q-blocks, a 3-bit near pair, a low-quality exact pair that keeps its
    edge and a low-quality near pair that loses it, V=1; readback equal
    at both sizes.  The card runs it at 100,000 and 1,000,000
    (chip_smoke.py, mesh phase)."""
    def build(n, rng):
        base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        low = np.zeros(n, dtype=bool)
        p = [n // 8, 3 * n // 8, 5 * n // 8, 7 * n // 8]
        for i in p[1:]:
            base[i] = base[p[0]]
        s, t = n // 16, 9 * n // 16
        near = base[s].copy()
        near[0] ^= 0b111
        base[t] = near
        a, b = n // 5, 4 * n // 5
        base[b] = base[a]
        low[a] = True
        c, d = n // 3, 2 * n // 3
        near2 = base[c].copy()
        near2[3] ^= 0b11
        base[d] = near2
        low[c] = True
        expect = sorted(
            [(p[0], p[1]), (p[0], p[2]), (p[0], p[3]),
             (p[1], p[2]), (p[1], p[3]), (p[2], p[3]),
             (s, t), (a, b)])
        return base, low, expect

    stats = {}
    for n in (4096, 40_000):
        base, low, expect = build(n, np.random.default_rng(100 + n))
        ei, ej, st = sharded.sharded_find_edges(
            mesh8, base, low_conf=low, similarity=8, return_stats=True)
        assert _pairs(ei, ej) == expect, n
        stats[n] = st
    assert stats[4096]["hot_rows"] == stats[40_000]["hot_rows"] == 5
    assert stats[4096]["readback_bytes"] == stats[40_000]["readback_bytes"]
    assert stats[40_000]["readback_bytes"] < 64 * 1024


def test_sharded_group_files_end_to_end(mesh8, ref_mesh8, tmp_path):
    from rupphash_tpu_torch.grouping.engine import FileRecord

    rng = np.random.default_rng(8)
    n = 24
    hashes = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    hashes[5] = hashes[2]
    hashes[19] = hashes[2]
    files = [FileRecord(path=tmp_path / f"f{i:02d}.png", size=i + 1,
                        pdqhash=bytes(hashes[i]), pdq_quality=90,
                        unique_file_id=i) for i in range(n)]
    groups, infos, edges = sharded.sharded_group_files(
        mesh8, files, similarity=8)
    assert edges == 3
    assert len(groups) == 1
    assert sorted(f.path.name for f in groups[0]) == \
        ["f02.png", "f05.png", "f19.png"]
    assert infos[0].max_dist == 0 and infos[0].status == "none"
    ref_files = [ref_engine.FileRecord(**dataclasses.asdict(f)) for f in files]
    rgroups, rinfos, redges = ref_sharded.sharded_group_files(
        ref_mesh8, ref_files, similarity=8)
    assert redges == edges
    assert [[f.path for f in g] for g in rgroups] == \
        [[f.path for f in g] for g in groups]
    assert sharded.sharded_group_files(mesh8, [], similarity=8) == ([], [], 0)


def test_full_dedup_step(mesh8, ref_mesh8):
    rng = np.random.default_rng(4)
    lumas = rng.integers(0, 256, (16, 64, 64), dtype=np.uint8)
    lumas[7] = lumas[3]  # duplicate image in the batch
    hashes, quality, counts = sharded.full_dedup_step(
        mesh8, 64, 64, similarity=40)(lumas)
    assert int(counts.sum()) >= 1
    h = hashes.numpy()
    assert bytes(h[7]) == bytes(h[3])
    gold, _ = pdq_ref.generate_pdq(lumas[0])
    assert pdq_ref.hamming_distance(bytes(h[0]), gold) == 0
    rh, rq, rc = ref_sharded.full_dedup_step(ref_mesh8, 64, 64,
                                             similarity=40)(lumas)
    assert np.array_equal(h, np.asarray(rh))
    assert np.abs(quality.numpy() - np.asarray(rq)).max() <= 1e-6
    assert int(counts.sum()) == int(np.asarray(rc).sum())


def _engine_records(mod, tmp_path, n=300):
    """Records with dihedral variants: planted exact, near and variant-only
    pairs and a low-quality pair, for both engines."""
    rng = np.random.default_rng(12)
    var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    var[40] = var[7]
    var[200, 0] = var[150, 0]
    var[200, 0, 0] ^= 0b1011       # 3 bits from row 150
    var[30, 5] = var[260, 0]
    var[99] = var[12]
    out = []
    for i in range(n):
        out.append(mod.FileRecord(
            path=tmp_path / f"g{i:03d}.png", size=1000 + i,
            pdqhash=bytes(var[i, 0]), dihedral=var[i].copy(),
            pdq_quality=20 if i in (12, 99) else 90, unique_file_id=i))
    return out


@pytest.mark.parametrize("resident", [False, True])
def test_engine_routes_to_the_mesh(monkeypatch, tmp_path, ref_mesh8,
                                   resident):
    """With eight devices listed, the port's engine takes
    sharded_find_edges (as the reference's does on eight XLA devices)
    and gives the reference engine's groups.  When the scan kept its
    rows on the device, the mesh takes that tensor as it is, and no host
    array is built."""
    calls = []
    real = sharded.sharded_find_edges

    def spy(mesh, base, variants, *args, **kw):
        calls.append((mesh.shape, base is None,
                      isinstance(variants, torch.Tensor)))
        return real(mesh, base, variants, *args, **kw)

    monkeypatch.setattr(sharded, "local_devices", lambda: list(CPU8))
    monkeypatch.setattr(sharded, "sharded_find_edges", spy)
    records = _engine_records(engine, tmp_path)
    batches = None
    if resident:
        for k, r in enumerate(records):
            r.device_slot = (0, k)
        batches = [(records, torch.from_numpy(
            np.stack([r.dihedral for r in records])))]
    groups, infos, edges = engine.group_files(
        records, similarity=8, use_device=True, device_batches=batches)
    assert calls == [({"q": 4, "b": 2}, resident, resident)]
    rgroups, rinfos, redges = ref_engine.group_files(
        _engine_records(ref_engine, tmp_path), similarity=8,
        use_device=True)
    assert edges == redges == 4
    assert [[f.path.name for f in g] for g in groups] == \
        [[f.path.name for f in g] for g in rgroups]
    assert [(i.max_dist, i.status) for i in infos] == \
        [(i.max_dist, i.status) for i in rinfos]


def test_engine_stays_on_one_device(monkeypatch, tmp_path):
    """One device listed: the single-device search, no mesh."""
    monkeypatch.setattr(sharded, "sharded_find_edges",
                        lambda *a, **k: pytest.fail("took the mesh"))
    groups, _, edges = engine.group_files(
        _engine_records(engine, tmp_path), similarity=8, use_device=True)
    assert edges == 4 and len(groups) == 4

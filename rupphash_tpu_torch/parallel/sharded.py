"""SPMD scaling over a ('q', 'b') grid of devices, driven by one process.

Counterpart of rupphash_tpu/parallel/sharded.py.  The reference is
single-controller: one process, a shard_map over a jax Mesh.  Here a
small Mesh class names a 2-D grid of torch devices, and one process
launches each device's share asynchronously on that device's current
stream (under torch.cuda.device) and synchronizes only where the shares
are combined.  torch.distributed's DeviceMesh is not used: it needs one
process per device, and the CLI and --serve are one process.  Across
processes parallel/multihost.py uses torch.distributed, where the
reference uses jax.distributed.

* Hashing is data-parallel: the batch is split over every device and
  each slice hashed by the port's scan hasher (K1 on a card, its plain
  version on the CPU).

* The all-pairs search tiles the triangle of (query row i, base row
  j > i) pairs over the grid: device (q, b) takes the pairs whose query
  row lies in the q-th and whose base row lies in the b-th block of
  rows.  Its share of the count sweep is K3's work list cut to that
  block (ops/hamming_cuda.sweep_items), so each launch gives partial row
  counts, and their sum over 'b' (the reference's psum) equals one K3
  launch over the whole triangle, bit for bit.  Blocks wholly below the
  diagonal hold no pair and launch nothing.  The hot rows of a chunk
  are split over 'q'; each device matches its rows against its base
  block with K4 (the base a slice of the rows, the query indices
  shifted to it), and only its mask's nonzero (position, byte) pairs
  travel to the mesh's first device and on to the host.

* The packed hashes are replicated, so that K3 and K4 index base rows
  globally: every device holds the whole (V, Npad, 32) u8 matrix,
  256 MB at 1M rows x 8 variants and 25.6 GB at 100M.

Rows pad to a grid on which every block edge falls on K3's items
(SWEEP_QROWS query rows) and on K3's and K4's base tiles (SWEEP_BROWS
rows).  On the CPU the same functions run the plain versions of K3 and
K4 block by block; a mesh whose device list repeats one device
(make_mesh(8, devices=[torch.device("cpu")] * 8)) stands in for the
eight virtual XLA devices of the reference's tests.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import device
from ..ops import hamming_cuda, pdq_torch
from ..ops.hamming import _nonzero_bytes
from ..ops.hamming import unpack_bits_pm1  # noqa: F401 (the reference's name)
from ..utils import trace


def local_devices() -> list[torch.device]:
    """The devices this process shards over: every visible CUDA device
    when the process runs on the card, else its one device (the CPU,
    when pinned).  The engine and --serve take a mesh when this lists
    more than one."""
    dev = device.get()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class Mesh:
    """A 2-D grid of devices with the reference's axis names: 'q' tiles
    the query rows and 'b' the base rows of the distance matrix.
    `.shape` is {"q": nq, "b": nb}, `.devices[q][b]` a torch.device; a
    device may stand in more than one cell.  Hashed by identity, as the
    caches keyed on a mesh need."""

    def __init__(self, devices, nq: int, nb: int):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if nq < 1 or nb < 1 or len(devs) != nq * nb:
            raise ValueError(f"a {nq} x {nb} mesh needs {nq * nb} devices, "
                             f"got {len(devs)}")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError("a mesh holds CUDA devices only or the CPU only, "
                             f"got {sorted({str(d) for d in devs})}")
        if kinds == {"cuda"}:
            have = torch.cuda.device_count()
            missing = sorted({str(d) for d in devs if d.index >= have})
            if missing:
                raise ValueError(f"mesh devices {missing} are not among the "
                                 f"{have} CUDA devices visible")
        self.devices = tuple(tuple(devs[q * nb:(q + 1) * nb])
                             for q in range(nq))
        self.shape = {"q": nq, "b": nb}

    @property
    def size(self) -> int:
        return self.shape["q"] * self.shape["b"]

    def cells(self):
        """(q, b, device) of every cell, q-major: the order of the
        reference's P(("q", "b"))."""
        for q, row in enumerate(self.devices):
            for b, d in enumerate(row):
                yield q, b, d

    @property
    def flat(self) -> list[torch.device]:
        return [d for _, _, d in self.cells()]

    @property
    def home(self) -> torch.device:
        """Where results are combined: the first device."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ('q', 'b') mesh over the first n of `devices` (default
    local_devices()): (n/2, 2) for even n > 1, else (n, 1), as the
    reference shapes it.  Raises ValueError naming what is missing."""
    devs = list(devices) if devices is not None else local_devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices, but only {len(devs)} "
                         f"given: {[str(d) for d in devs]}")
    nq, nb = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return Mesh(devs[:n], nq, nb)


def _on(dev: torch.device):
    """Make a CUDA device current for the work launched under it."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _pad_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def _mesh_npad(n: int, nq: int, nb: int) -> int:
    """Rows padded so that the q-blocks are whole K3 items, the b-blocks
    whole K3 / K4 base tiles, and the total K3's row alignment."""
    return _pad_multiple(max(n, 1), math.lcm(
        hamming_cuda.ROW_ALIGN, hamming_cuda.SWEEP_QROWS * nq,
        hamming_cuda.SWEEP_BROWS * nb))


class MeshInputs(NamedTuple):
    """Packed hashes replicated on the devices of a mesh: for each
    distinct device, (var_bits (V, Npad, nbytes) u8 with the identity
    hash in slot 0, low (Npad, 1) int32), the layout of
    ops/hamming_cuda; pad rows are low-confidence and past n."""
    n: int
    npad: int
    on: dict


def mesh_inputs(mesh: Mesh, variants, low_conf=None) -> MeshInputs:
    """variants: (N, V, nbytes) u8 with the identity hash in slot 0,
    numpy (uploaded once to each distinct device) or a tensor (padded
    where it lies, copied device to device to the others); low_conf:
    optional (N,) bool."""
    n = int(variants.shape[0])
    npad = _mesh_npad(n, mesh.shape["q"], mesh.shape["b"])
    if isinstance(variants, torch.Tensor):
        var_bits, low, _, _ = hamming_cuda.prepare_inputs_resident(
            variants, None if low_conf is None else np.asarray(low_conf),
            npad)
    else:
        variants = np.ascontiguousarray(variants, dtype=np.uint8)
        var_bits, low, _, _ = hamming_cuda.prepare_inputs(
            variants[:, 0], variants, low_conf, npad)
    on = {}
    for d in mesh.flat:
        if d not in on:
            on[d] = (var_bits.to(d), low.to(d))
    return MeshInputs(n, npad, on)


def sharded_pdq_hasher(mesh: Mesh, rows: int, cols: int):
    """Data-parallel PDQ over every device of the mesh.

    Returns fn: (B, rows, cols) u8 lumas, numpy or a tensor, B divisible
    by the mesh size -> {hash (B, 32) u8, dihedral (B, 8, 32) u8,
    quality (B,) f32, coeffs (B, 256) f32} on the mesh's first device.
    Slice s of the batch is hashed on device s (q-major) by
    pdq_torch.pdq_hash_batch: one K1 launch a device on a card, the
    plain version on the CPU."""
    ndev = mesh.size

    def run(lumas):
        planes = lumas if isinstance(lumas, torch.Tensor) else \
            torch.from_numpy(np.require(lumas, np.uint8, ["C"]))
        b = int(planes.shape[0])
        if tuple(planes.shape[1:]) != (rows, cols) or b % ndev:
            raise ValueError(f"lumas must be (k * {ndev}, {rows}, {cols}) "
                             f"u8, got {tuple(planes.shape)}")
        per = b // ndev
        outs = []
        for s, d in enumerate(mesh.flat):
            with _on(d):
                outs.append(pdq_torch.pdq_hash_batch(
                    planes[s * per:(s + 1) * per].to(d)))
        return {k: torch.cat([o[k].to(mesh.home) for o in outs])
                for k in outs[0]}

    return run


def _cell_counts(mesh: Mesh, inputs: MeshInputs, similarity: int):
    """[(q, b, (Npad, 1) int32 row counts of cell (q, b)'s pairs)]: one
    K3 launch per cell that holds a pair, all launched before any is
    read."""
    qsz = inputs.npad // mesh.shape["q"]
    bsz = inputs.npad // mesh.shape["b"]
    parts = []
    for q, b, d in mesh.cells():
        var_bits, low = inputs.on[d]
        with _on(d):
            parts.append((q, b, hamming_cuda.scan_row_counts(
                var_bits, low, sim=similarity, n_total=inputs.n,
                block=(q * qsz, (q + 1) * qsz, b * bsz, (b + 1) * bsz))))
    return parts


def sharded_group_counts(mesh: Mesh, similarity: int = 40):
    """2-D sharded all-pairs duplicate counting.

    Returns fn(variants_u8 (N, V, nbytes), low_conf (N,) bool) -> (nq,
    nb) int32 per-cell match counts on the mesh's first device; their
    sum is the number of edges."""
    def run(variants_u8, low_conf=None):
        inputs = mesh_inputs(mesh, variants_u8, low_conf)
        out = torch.zeros((mesh.shape["q"], mesh.shape["b"]),
                          dtype=torch.int32, device=mesh.home)
        for q, b, part in _cell_counts(mesh, inputs, similarity):
            out[q, b] = part.sum(dtype=torch.int32).to(mesh.home)
        return out

    return run


def sharded_row_counts(mesh: Mesh, similarity: int = 40):
    """Per-query-row match counts over the full upper triangle, phase 1
    of count-then-extract.

    Returns fn(inputs: MeshInputs) -> (Npad,) int32 on the mesh's first
    device, entry i counting the matches (i, j > i): the cells' partial
    counts summed over 'b' and laid out over 'q'."""
    def run(inputs: MeshInputs):
        qsz = inputs.npad // mesh.shape["q"]
        counts = torch.zeros(inputs.npad, dtype=torch.int32,
                             device=mesh.home)
        for q, _, part in _cell_counts(mesh, inputs, similarity):
            rows = slice(q * qsz, (q + 1) * qsz)
            counts[rows] += part[rows, 0].to(mesh.home)
        return counts

    return run


def sharded_extract_rows(mesh: Mesh, similarity: int = 40):
    """Phase 2 of count-then-extract: hot query rows against the base,
    compacted on the devices to O(edges) readback.

    Returns fn(inputs: MeshInputs, rows (M,) global hot-row indices,
    kpad) -> (positions (kpad,) int32, values (kpad,) u8) on the mesh's
    first device: the nonzero bytes of the (Mpad, Npad/8) packed match
    mask, in position order, position -1 padding.  M pads to a multiple
    of 'q' and the rows split evenly over it; cell (q, b) matches its
    rows against the b-th block of base rows with one K4 launch, skipped
    when none of its rows has a later row in the block."""
    nq, nb = mesh.shape["q"], mesh.shape["b"]

    def run(inputs: MeshInputs, rows: np.ndarray, kpad: int):
        n, npad = inputs.n, inputs.npad
        stride, bsz = npad // 8, npad // nb
        m = len(rows)
        mloc = _pad_multiple(m, nq) // nq
        # pad slots point at row n-1 with qidx = n, which keeps them inert
        ridx = np.full(mloc * nq, n - 1, dtype=np.int64)
        qidx = np.full(mloc * nq, n, dtype=np.int64)
        ridx[:m] = rows
        qidx[:m] = rows
        masks = []
        for q, b, d in mesh.cells():
            b0, b1 = b * bsz, (b + 1) * bsz
            mine = slice(q * mloc, (q + 1) * mloc)
            live = qidx[mine][qidx[mine] < n]
            if b0 >= n or not len(live) or live.min() + 1 >= b1:
                continue
            var_bits, low = inputs.on[d]
            with _on(d):
                sel = torch.from_numpy(ridx[mine]).to(d)
                shifted = (qidx[mine] - b0).astype(np.int32)[:, None]
                masks.append((q, b0, hamming_cuda.extract_rows_packed(
                    var_bits.index_select(1, sel), var_bits[0, b0:b1],
                    low.index_select(0, sel), low[b0:b1],
                    torch.from_numpy(shifted).to(d), sim=similarity,
                    n_total=n - b0)))
        positions, values = [], []
        for q, b0, packed in masks:
            pos, vals = _nonzero_bytes(packed)
            lstride = packed.shape[1]
            pos = (pos // lstride + q * mloc) * stride + b0 // 8 + pos % lstride
            positions.append(pos.to(mesh.home))
            values.append(vals.to(mesh.home))
        idx = torch.full((kpad,), -1, dtype=torch.int32, device=mesh.home)
        out = torch.zeros(kpad, dtype=torch.uint8, device=mesh.home)
        if positions:
            pos = torch.cat(positions)
            if len(pos) > kpad:
                raise RuntimeError(f"{len(pos)} nonzero mask bytes exceed the "
                                   f"budget of {kpad} the count sweep set")
            pos, order = torch.sort(pos)
            idx[:len(pos)] = pos.to(torch.int32)
            out[:len(pos)] = torch.cat(values)[order]
        return idx, out

    return run


def _nonzero_rows_padded(counts: torch.Tensor, n: int, hpad: int):
    """(Npad,) int32 row counts -> (indices, counts) (hpad,) int32 numpy
    of the nonzero rows within [0, n), index -1 padding: the
    reference's fixed-size readback."""
    (idx,) = torch.nonzero(counts[:n], as_tuple=True)
    out_idx = torch.full((hpad,), -1, dtype=torch.int32, device=counts.device)
    out_cnt = torch.zeros(hpad, dtype=torch.int32, device=counts.device)
    out_idx[:len(idx)] = idx.to(torch.int32)
    out_cnt[:len(idx)] = counts[idx]
    return out_idx.cpu().numpy(), out_cnt.cpu().numpy()


def sharded_find_edges(mesh: Mesh, base_hashes: np.ndarray | None,
                       variants=None, low_conf: np.ndarray | None = None,
                       similarity: int = 40,
                       row_chunk: int = 1024,
                       return_stats: bool = False):
    """Mesh-sharded all-pairs duplicate edges: the multi-device
    counterpart of ops/hamming.find_edges_fast.  Returns (i, j) int64
    with i < j; plus a stats dict when asked.

    variants: (N, V, nbytes) u8 with the base hash in slot 0, which K3
    and K4 match against; numpy, or a tensor on a device (the scan's
    resident rows), then padded where it lies and copied device to
    device, with nothing re-uploaded.  base_hashes (N, nbytes) u8 is
    checked against slot 0 when given, and may be None with variants.

    Device-to-host traffic is O(edges), never O(N), counted as the
    reference counts it (stats' readback_bytes): the number of hot rows
    (4 bytes), their (index, count) pairs padded to a power of two of at
    least 1024, and per chunk of hot rows a power-of-two budget of
    (int32 position, u8 byte) pairs that the count sweep's per-row
    counts set in advance.  Spans, as ops/hamming's: edges.count (the
    count sweep up to the hot rows on the host) and edges.extract (the
    extraction with the cells' compaction and merge, the readback and
    the host assembly)."""
    if variants is None:
        variants = base_hashes[:, None, :]
    n = int(variants.shape[0])
    empty = np.empty(0, dtype=np.int64)

    def done(ei, ej, hot_rows, readback):
        if return_stats:
            return ei, ej, {"hot_rows": hot_rows, "readback_bytes": readback}
        return ei, ej

    if n == 0:
        return done(empty, empty, 0, 0)
    if base_hashes is not None:
        slot0 = variants[:, 0]
        if isinstance(slot0, torch.Tensor):
            slot0 = slot0.cpu().numpy()
        if not np.array_equal(slot0, base_hashes):
            raise ValueError("variants[:, 0] must be the base hashes: the "
                             "count sweep and the extraction match against "
                             "slot 0")
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)

    nq = mesh.shape["q"]
    inputs = mesh_inputs(mesh, variants, low_conf)
    stride = inputs.npad // 8
    # positions index an (mpad, Npad/8) mask in int32, so a chunk keeps
    # mpad * stride < 2^31 (the reference's bound at :436-443)
    max_rows = max(nq, int((2 ** 31 - 1) // max(stride, 1)) // nq * nq)
    row_chunk = min(row_chunk, max_rows)

    with trace.span("edges.count") as sp:
        counts = sharded_row_counts(mesh, similarity)(inputs)
        n_hot = int(torch.count_nonzero(counts[:n]))
        readback = 4  # the scalar above
        if n_hot:
            hpad = max(1024, 1 << (n_hot - 1).bit_length())
            hot_idx, hot_cnt = _nonzero_rows_padded(counts, n, hpad)
        sp.count("hot_rows", n_hot)
    if n_hot == 0:
        return done(empty, empty, 0, readback)
    readback += hot_idx.nbytes + hot_cnt.nbytes
    sel = hot_idx >= 0
    hot = hot_idx[sel].astype(np.int64)
    hot_counts = hot_cnt[sel].astype(np.int64)

    extract = sharded_extract_rows(mesh, similarity)
    edges_i: list[np.ndarray] = []
    edges_j: list[np.ndarray] = []
    with trace.span("edges.extract") as sp:
        for c0 in range(0, len(hot), row_chunk):
            rows = hot[c0:c0 + row_chunk]
            mpad = _pad_multiple(len(rows), nq)
            # the chunk's edge count is known from the count sweep; a
            # power-of-two budget of at least 256 pairs, capped by the
            # mask
            k = int(hot_counts[c0:c0 + row_chunk].sum())
            kpad = max(256, 1 << max(0, (k - 1).bit_length()))
            kpad = min(kpad, mpad * stride)
            idx_d, vals_d = extract(inputs, rows, kpad)
            idx, vals = idx_d.cpu().numpy(), vals_d.cpu().numpy()
            readback += idx.nbytes + vals.nbytes
            live = idx >= 0
            idx, vals = idx[live].astype(np.int64), vals[live]
            r = idx // stride
            bytecol = idx % stride
            bits = np.unpackbits(vals[:, None], axis=1, bitorder="little")
            rr, bb = np.nonzero(bits)
            edges_i.append(rows[r[rr]])
            edges_j.append(bytecol[rr] * 8 + bb)
            sp.count("launches")
        ei, ej = np.concatenate(edges_i), np.concatenate(edges_j)
        sp.count("edges", len(ei))
    return done(ei, ej, int(len(hot)), readback)


def sharded_query_topk_status(mesh: Mesh):
    """Status-aware mesh query for the serving index's incremental sharded
    residency (serve.HashIndex): the corpus lies in one shard a device
    (q-major), each (cap / ndev, nbytes) u8 rows with an int8 status (0
    ok, 1 low-quality, 2 dead or padding); dead rows never match, low
    ones only at distance 0, rows past n_total or the radius report the
    nbits + 1 sentinel.  Each device computes its shard's gated
    distances with serve's single-device arithmetic and keeps its k
    best, and the first device merges them: the k best (distance,
    corpus row) per query, ties by row as the single-device top-k
    orders them, so readback is O(Q x k).

    Returns fn(q_var_u8 (Q, V, nbytes) u8 tensor or numpy, shards
    [(base, status)], n_total, similarity, k) -> (dists (Q, k), rows (Q,
    k)) int64 on the first device.  The radius is an argument of each
    call, never of the factory: clients choose it per request."""
    from .. import serve

    devs = mesh.flat

    def run(q_var_u8, shards, n_total, similarity, k):
        q_var = torch.as_tensor(q_var_u8)
        nbits = q_var.shape[-1] * 8
        loc = int(shards[0][0].shape[0])
        cap = loc * len(devs)
        keys = []
        for s, (d, (base, status)) in enumerate(zip(devs, shards)):
            with _on(d):
                gated = serve._query_min_dists(q_var.to(d), base, status,
                                               nbits)
                col = torch.arange(s * loc, (s + 1) * loc, device=d)
                gated = torch.where((col[None, :] >= n_total)
                                    | (gated > similarity), nbits + 1, gated)
                key = gated.to(torch.int64) * cap + col[None, :]
                keys.append(torch.topk(key, min(k, loc), dim=1, largest=False,
                                       sorted=True).values.to(mesh.home))
        best = torch.topk(torch.cat(keys, dim=1), k, dim=1, largest=False,
                          sorted=True).values
        return best // cap, best % cap

    return run


def sharded_group_files(mesh: Mesh, files, similarity: int = 40,
                        sort_order: str = "name"):
    """Mesh-sharded end of the grouping pipeline: scanner.rs:1640-1830
    semantics (dihedral variants, low-quality exact-only gate, union-
    find, stem merge, analyze, sort) with the all-pairs edge search on
    the ('q', 'b') mesh instead of one device."""
    from ..grouping import engine

    idx = [i for i, f in enumerate(files) if f.pdqhash is not None]
    if not idx:
        return [], [], 0
    base = np.stack([np.frombuffer(files[i].pdqhash, dtype=np.uint8)
                     for i in idx])
    variants = np.stack([
        files[i].dihedral if files[i].dihedral is not None
        else np.repeat(base[k][None], 8, axis=0)
        for k, i in enumerate(idx)])
    low = np.array([files[i].is_low_quality for i in idx])

    ei, ej = sharded_find_edges(mesh, base, variants, low, similarity)
    dense = np.asarray(idx, dtype=np.int64)
    return engine.finalize_edges(files, dense[ei], dense[ej], sort_order)


def full_dedup_step(mesh: Mesh, rows: int, cols: int, similarity: int = 40):
    """The end-to-end device step: sharded hash -> sharded count.

    (B, rows, cols) u8 lumas -> (hashes (B, 32) u8, quality (B,) f32,
    per-cell match counts (nq, nb) int32), all on the mesh's first
    device."""
    hasher = sharded_pdq_hasher(mesh, rows, cols)
    grouper = sharded_group_counts(mesh, similarity)

    def step(lumas):
        out = hasher(lumas)
        low = (out["quality"] * 100.0 < 50.0).cpu().numpy()
        counts = grouper(out["dihedral"], low)
        return out["hash"], out["quality"], counts

    return step

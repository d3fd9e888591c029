"""All-pairs Hamming-distance duplicate search.

Counterpart of rupphash_tpu/ops/hamming.py.  Each file contributes V
dihedral variants as queries and its identity hash (variant slot 0) as
the base; a pair (i, j), j > i, is an edge when the smallest distance
over the variants is within the threshold, and exactly 0 when either
hash is low-confidence (quality < 50, scanner.rs:1588-1594).

The search runs in two passes on the device (ops/hamming_cuda.py): the
count sweep K3 gives every row its number of matches, then K4
re-materializes only the rows with matches as packed bitmasks, which
are compacted to (position, byte) pairs before they go to the host.
CPU tensors take the same route through the kernels' plain versions.

`find_edges` is the reference's tile path in plain PyTorch: per-tile
match counts, then extraction of the hot tiles only.  find_edges_fast
routes to it where the variant slot 0 is not the base hash.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

MAX_SIMILARITY_256 = 63  # hamminghash.rs:8

# tile path (find_edges): tile sizes as the reference's, query rows per
# dot slab (bounds one slab's float32 dots at 512 x V x 2048), and the
# number of extracted tiles held before their first readback
QUERY_TILE = 4096
BASE_TILE = 2048
_SLAB = 512
MAX_IN_FLIGHT = 16

# Extraction mask budget per chunk of hot rows (MQ x Npad/8 bytes).  The
# count sweep knows the hot rows in advance, so chunks only bound device
# memory: the mask plus torch.nonzero's int64 positions stay near this.
_MASK_BUDGET = 256 << 20
_MIN_ROW_CHUNK = 32
_MAX_ROW_CHUNK = 4096


def pm1_encode(hashes: np.ndarray) -> np.ndarray:
    """(N, nbytes) uint8 packed hashes -> (N, nbytes*8) int8 in {-1, +1}.
    Bit b of byte k maps to column k*8 + b."""
    bits = np.unpackbits(hashes, axis=-1, bitorder="little")
    return (bits.astype(np.int8) << 1) - 1


def unpack_bits_pm1(hashes_u8: torch.Tensor) -> torch.Tensor:
    """Tensor equivalent of pm1_encode (same bit->column layout)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=hashes_u8.device)
    bits = (hashes_u8[..., :, None] >> shifts) & 1
    flat = bits.reshape(hashes_u8.shape[:-1] + (hashes_u8.shape[-1] * 8,))
    return flat.to(torch.int8) * 2 - 1


def unpack_edges_mask(mask_packed: np.ndarray, qoff: int, boff: int,
                      ta: int, tb: int):
    """(ta, tb/8) packed uint8 -> (i, j) global index arrays."""
    m = np.unpackbits(mask_packed, axis=-1, bitorder="little")[:, :tb]
    qi, bj = np.nonzero(m)
    return qi + qoff, bj + boff


def _nonzero_rows(counts_col: torch.Tensor, n: int):
    """(Npad,) int32 row counts -> (indices, counts) of the nonzero rows
    within [0, n)."""
    (idx,) = torch.nonzero(counts_col[:n], as_tuple=True)
    return idx, counts_col[idx]


def _nonzero_bytes(packed: torch.Tensor):
    """(M, Npad/8) uint8 -> (flat positions, values) of its nonzero bytes.
    Match masks are almost all zeros, so only O(edges) pairs go to the
    host instead of the whole mask."""
    flat = packed.reshape(-1)
    (idx,) = torch.nonzero(flat, as_tuple=True)
    return idx, flat[idx]


def _empty(return_stats, **stats):
    empty = np.empty(0, dtype=np.int64)
    return (empty, empty, stats) if return_stats else (empty, empty)


def _tile_mask(var_d, base_d, low_d, q0, q1, b0, b1, nbits, sim, n_total):
    """(q1-q0, b1-b0) bool match mask of query rows [q0, q1) against base
    rows [b0, b1): float32 dots of +/-1 vectors (exact for |dot| <= 256),
    max over variants, threshold, pair and range masks."""
    dev = var_d.device
    qv = unpack_bits_pm1(var_d[q0:q1]).float()                 # (tq, V, nbits)
    bt = unpack_bits_pm1(base_d[b0:b1]).float()                # (tb, nbits)
    best = torch.matmul(qv, bt.T).amax(dim=1)                  # (tq, tb)
    dotmin = torch.where(low_d[q0:q1, None] | low_d[None, b0:b1],
                         nbits, nbits - 2 * sim)
    qidx = torch.arange(q0, q1, device=dev)[:, None]
    jidx = torch.arange(b0, b1, device=dev)[None, :]
    return ((best >= dotmin) & (jidx > qidx) & (jidx < n_total)
            & (qidx < n_total))


def _scan_counts_all(var_d, base_d, low_d, sim, n_total, ta, tb, nbits,
                     slab):
    """(Npad/ta, Npad/tb) int64 match counts of the upper-triangle tiles
    (counterpart of the reference's _scan_counts_all), computed in
    slabs of `slab` query rows."""
    npad = var_d.shape[0]
    counts = torch.zeros((npad // ta, npad // tb), dtype=torch.int64,
                         device=var_d.device)
    for qi in range(npad // ta):
        for bj in range(npad // tb):
            if (bj + 1) * tb <= qi * ta + 1:    # wholly below the diagonal
                continue
            for s0 in range(qi * ta, (qi + 1) * ta, slab):
                mask = _tile_mask(var_d, base_d, low_d, s0, s0 + slab,
                                  bj * tb, (bj + 1) * tb, nbits, sim,
                                  n_total)
                counts[qi, bj] += mask.sum()
    return counts


def _tile_extract(var_d, base_d, low_d, qi, bj, sim, n_total, ta, tb,
                  nbits, slab):
    """One (ta, tb) match tile as (ta, tb/8) packed uint8 bits, on the
    device (counterpart of the reference's _tile_extract)."""
    weights = torch.tensor(1 << np.arange(8), dtype=torch.int32,
                           device=var_d.device)
    slabs = []
    for s0 in range(qi * ta, (qi + 1) * ta, slab):
        mask = _tile_mask(var_d, base_d, low_d, s0, s0 + slab, bj * tb,
                          (bj + 1) * tb, nbits, sim, n_total)
        slabs.append((mask.view(slab, tb // 8, 8).to(torch.int32)
                      * weights).sum(dim=-1).to(torch.uint8))
    return torch.cat(slabs)


def _tile_edges(qi, bj, packed, ta, tb, n):
    """Read one extracted tile back: (i, j) int64 edges within [0, n)."""
    gi, gj = unpack_edges_mask(packed.cpu().numpy(), qi * ta, bj * tb, ta,
                               tb)
    keep = (gi < n) & (gj < n)
    return gi[keep].astype(np.int64), gj[keep].astype(np.int64)


def find_edges(base_hashes: np.ndarray,
               variants: np.ndarray | None = None,
               low_conf: np.ndarray | None = None,
               similarity: int = 40,
               query_tile: int = QUERY_TILE,
               base_tile: int = BASE_TILE,
               return_stats: bool = False):
    """All-pairs duplicate edges by tiles, matching queries against
    `base_hashes` whatever variant slot 0 holds.

    base_hashes: (N, nbytes) uint8 (32 for PDQ, 8 for pHash); variants:
    optional (N, V, nbytes) uint8 per-file query variants (defaults to
    the base alone); low_conf: optional (N,) bool, low-confidence hashes
    pair only at distance 0.  Returns (i, j) int64 arrays with i < j,
    plus a stats dict if requested.  Hot tiles are extracted on the
    port's device with at most MAX_IN_FLIGHT of them awaiting readback."""
    from .. import device

    n, nbytes = base_hashes.shape
    nbits = nbytes * 8
    if n == 0:
        return _empty(return_stats)
    if variants is None:
        variants = base_hashes[:, None, :]
    v = variants.shape[1]
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    ta, tb = query_tile, base_tile
    if ta % _SLAB and _SLAB % ta or tb % 8:
        raise ValueError(f"tiles {ta}x{tb}: the query tile must divide or be "
                         f"a multiple of {_SLAB}, the base tile of 8")
    slab = min(ta, _SLAB)
    npad = -(-n // ta) * ta
    npad = -(-npad // tb) * tb
    while npad % ta:            # divisible by both tile sizes
        npad += tb
    dev = device.get()
    var_p = np.zeros((npad, v, nbytes), dtype=np.uint8)
    var_p[:n] = variants
    base_p = np.zeros((npad, nbytes), dtype=np.uint8)
    base_p[:n] = base_hashes
    low_p = np.ones(npad, dtype=bool)
    low_p[:n] = low_conf
    var_d, base_d, low_d = (torch.from_numpy(a).to(dev)
                            for a in (var_p, base_p, low_p))

    counts = _scan_counts_all(var_d, base_d, low_d, similarity, n, ta, tb,
                              nbits, slab)
    hot = torch.nonzero(counts).tolist()
    # pop before append: at most MAX_IN_FLIGHT extracted tiles are held
    pending: list = []
    edges_i: list[np.ndarray] = []
    edges_j: list[np.ndarray] = []
    for qi, bj in hot:
        if len(pending) == MAX_IN_FLIGHT:
            gi, gj = _tile_edges(*pending.pop(0), ta, tb, n)
            edges_i.append(gi)
            edges_j.append(gj)
        pending.append((qi, bj, _tile_extract(
            var_d, base_d, low_d, qi, bj, similarity, n, ta, tb, nbits,
            slab)))
    for item in pending:
        gi, gj = _tile_edges(*item, ta, tb, n)
        edges_i.append(gi)
        edges_j.append(gj)
    ei = np.concatenate(edges_i) if edges_i else np.empty(0, dtype=np.int64)
    ej = np.concatenate(edges_j) if edges_j else np.empty(0, dtype=np.int64)
    if return_stats:
        return ei, ej, {"tiles_scanned": int(counts.numel()),
                        "tiles_extracted": len(hot),
                        "pairs_checked": n * (n - 1) // 2 * v}
    return ei, ej


def find_edges_fast(base_hashes: np.ndarray,
                    variants: np.ndarray | None = None,
                    low_conf: np.ndarray | None = None,
                    similarity: int = 40,
                    row_chunk: int | None = None,
                    return_stats: bool = False):
    """All-pairs duplicate edges from host arrays: count sweep, then exact
    extraction of only the rows with matches, on the port's device.

    base_hashes: (N, nbytes) uint8; variants: optional (N, V, nbytes)
    uint8 with the identity hash in slot 0 (defaults to the base alone);
    low_conf: optional (N,) bool.  Returns (i, j) int64 arrays, i < j."""
    from . import hamming_cuda

    n = base_hashes.shape[0]
    if n == 0:
        return _empty(return_stats)
    if variants is None:
        variants = base_hashes[:, None, :]
    elif not np.array_equal(variants[:, 0], base_hashes):
        # the device path matches queries against variant slot 0 as the
        # base side; any other layout takes the tile path, which honours
        # base_hashes as given (as the reference does)
        return find_edges(base_hashes, variants, low_conf, similarity,
                          return_stats=return_stats)
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    var_bits, low_d, _, npad = hamming_cuda.prepare_inputs_device(
        base_hashes, variants, low_conf)
    return _edges_from_device(var_bits, low_d, npad, n, low_conf, similarity,
                              row_chunk, return_stats)


def find_edges_fast_resident(var_dev: torch.Tensor, low_conf=None,
                             similarity: int = 40,
                             row_chunk: int | None = None,
                             return_stats: bool = False):
    """Device-resident path: `var_dev` is an (N, V, nbytes) u8 tensor
    already on the device, the layout pdq_hash_batch emits as
    'dihedral', identity hash at slot 0.  Only the (N,) low-confidence
    flags cross from the host.  Same results as find_edges_fast."""
    from . import hamming_cuda

    n = int(var_dev.shape[0])
    if n == 0:
        return _empty(return_stats)
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    var_bits, low_d, _, npad = hamming_cuda.prepare_inputs_resident(
        var_dev, low_conf)
    return _edges_from_device(var_bits, low_d, npad, n, low_conf, similarity,
                              row_chunk, return_stats)


def _default_row_chunk(npad: int) -> int:
    rows = _MASK_BUDGET // max(npad // 8, 1)
    rows = min(_MAX_ROW_CHUNK, max(_MIN_ROW_CHUNK, rows))
    return rows // _MIN_ROW_CHUNK * _MIN_ROW_CHUNK


def _edges_from_device(var_bits, low_d, npad, n, low_conf, similarity,
                       row_chunk, return_stats):
    """Shared tail: count sweep -> hot rows -> chunked extraction ->
    compaction -> host edge assembly.  Spans: edges.count (K3 up to the
    hot rows on the host) and edges.extract (the K4 chunks with their
    compaction, readback and the host assembly)."""
    from . import hamming_cuda

    v = int(var_bits.shape[0])
    stride = npad // 8
    dev = var_bits.device
    pairs = n * (n - 1) // 2 * v
    with trace.span("edges.count") as sp:
        counts_d = hamming_cuda.scan_row_counts(var_bits, low_d,
                                                sim=similarity, n_total=n)
        hot_d, _ = _nonzero_rows(counts_d[:, 0], n)
        hot = hot_d.cpu().numpy()
        sp.count("hot_rows", len(hot))
    if len(hot) == 0:
        return _empty(return_stats, hot_rows=0, pairs_checked=pairs)
    row_chunk = row_chunk or _default_row_chunk(npad)
    low_np = np.asarray(low_conf, dtype=np.int32)
    edges_i: list[np.ndarray] = []
    edges_j: list[np.ndarray] = []
    with trace.span("edges.extract") as sp:
        for c0 in range(0, len(hot), row_chunk):
            rows = hot[c0:c0 + row_chunk]
            m = len(rows)
            mpad = -(-m // _MIN_ROW_CHUNK) * _MIN_ROW_CHUNK
            # pad slots point at row n-1 with qidx = n, which keeps them
            # inert
            ridx = np.full(mpad, n - 1, dtype=np.int64)
            qidx = np.full((mpad, 1), n, dtype=np.int32)
            qlow = np.ones((mpad, 1), dtype=np.int32)
            ridx[:m] = rows
            qidx[:m, 0] = rows
            qlow[:m, 0] = low_np[rows]
            q_bits = var_bits.index_select(1, torch.from_numpy(ridx).to(dev))
            packed = hamming_cuda.extract_rows_packed(
                q_bits, var_bits[0], torch.from_numpy(qlow).to(dev), low_d,
                torch.from_numpy(qidx).to(dev), sim=similarity, n_total=n)
            pos_d, vals_d = _nonzero_bytes(packed)
            pos = pos_d.cpu().numpy()
            vals = vals_d.cpu().numpy()
            r = pos // stride
            bytecol = pos % stride
            rr, bb = np.nonzero(np.unpackbits(vals[:, None], axis=1,
                                              bitorder="little"))
            edges_i.append(ridx[r[rr]])
            edges_j.append(bytecol[rr] * 8 + bb)
            sp.count("launches")
        ei = np.concatenate(edges_i).astype(np.int64)
        ej = np.concatenate(edges_j).astype(np.int64)
        sp.count("edges", len(ei))
    if return_stats:
        return ei, ej, {"hot_rows": int(len(hot)), "pairs_checked": pairs}
    return ei, ej


# --------------------------------------------------------------------------
# Host oracle (for tests and tiny inputs): brute-force XOR+popcount
# --------------------------------------------------------------------------

def brute_force_edges(base_hashes: np.ndarray,
                      variants: np.ndarray | None = None,
                      low_conf: np.ndarray | None = None,
                      similarity: int = 40):
    """O(N^2) numpy oracle with identical semantics to find_edges_fast."""
    n = base_hashes.shape[0]
    if variants is None:
        variants = base_hashes[:, None, :]
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    vb = np.unpackbits(variants, axis=-1, bitorder="little")      # (N,V,bits)
    bb = np.unpackbits(base_hashes, axis=-1, bitorder="little")   # (N,bits)
    ei, ej = [], []
    for i in range(n):
        d = (vb[i][:, None, :] != bb[None, i + 1:, :]).sum(-1).min(0)
        thr = np.where(low_conf[i] | low_conf[i + 1:], 0, similarity)
        js = np.nonzero(d <= thr)[0] + i + 1
        ei.extend([i] * len(js))
        ej.extend(js.tolist())
    return np.asarray(ei, dtype=np.int64), np.asarray(ej, dtype=np.int64)

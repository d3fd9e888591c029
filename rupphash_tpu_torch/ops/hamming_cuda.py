"""K3 (count sweep) and K4 (hot-row extraction) of the Hamming edge
search (csrc/hamming.cu), K6 (the int8 tensor-core count sweep of the
JAX package's profiling script, csrc/hamming_mma.cu), their plain
versions and input preparation.

K3 and K4 replace rupphash_tpu/ops/hamming_pallas.py::_rowcount_kernel
and ::_extract_kernel.  Both take the hashes packed, as the (V, Npad,
nbytes) u8 tensor the JAX package shipped to the device before
unpacking it to +/-1 int8.  Both expand the packed bits to +/-1 int8 in
shared memory, take the dots on the int8 tensor cores (wgmma) and apply
the TPU's predicate dot >= nbits - 2 * sim; K3 counts the matches of
each row, K4 packs those of the hot rows into bitmasks.  K6 replaces
_prof_nz.py::_rowcount_kernel_dg and takes that kernel's own +/-1 int8
input.  Outputs keep the JAX layouts: per-row counts (Npad, 1) int32 and packed match masks (MQ,
Npad / 8) u8 with bit j % 8 of byte j // 8.

Rows pad to a multiple of ROW_ALIGN, a multiple of K6's column block and
query granule and of K3's and K4's tiles, so staging never reads past
the end.  Padding rows are marked low-confidence and masked by index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, hamming

ROW_ALIGN = 1024          # a multiple of PM1_COLS, PM1_QROWS and SWEEP_BROWS
SWEEP_QROWS = 64          # csrc/hamming.cu kQRows: query rows per K3 item
SWEEP_BROWS = 128         # csrc/hamming.cu kBRows: base rows per K3 tile
SWEEP_GROUPS = 2          # csrc/hamming.cu kGroups: warpgroups per K3 block
SWEEP_ITEM_TILES = 64     # base tiles per K3 work item
# base tiles per K4 work item: few query tiles, so shorter runs than K3's fill the card
EXTRACT_ITEM_TILES = 32
PM1_COLS = 512            # csrc/hamming_mma.cu kBlockCols: base rows per K6 block
PM1_WARP_COLS = 64        # csrc/hamming_mma.cu kWarpCols: base rows per K6 warp
PM1_QROWS = 128           # query rows per K6 stage at V=1 (8 tiles of 16); 16 at V=8
PM1_ITEM_ROWS = 2048      # query rows per K6 work item
PM1_TAIL_ROWS = 512       # and per item of the last runs
KERNEL_NBYTES = (8, 32)   # hash widths the kernels are built for (pHash, PDQ)
KERNEL_VARIANTS = (1, 8)  # query variant counts the kernels are built for

# plain versions: dot tiles of V x 512 x 2048 float32 (32 MiB at V=8)
_PLAIN_QT = 512
_PLAIN_BT = 2048


def _pad_rows(n: int) -> int:
    return max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)


def prepare_inputs(base_hashes: np.ndarray,
                   variants: np.ndarray | None,
                   low_conf: np.ndarray | None, npad: int | None = None):
    """Host-side packing to the kernel layout.  Returns
    (var_bits (V, Npad, nbytes) u8, low (Npad, 1) int32, n, npad) as CPU
    tensors; query variants in every slot, the base hash in slot 0.
    npad defaults to N rounded up to ROW_ALIGN."""
    n, nbytes = base_hashes.shape
    if variants is None:
        variants = base_hashes[:, None, :]
    v = variants.shape[1]
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    npad = npad or _pad_rows(n)
    packed = np.zeros((v, npad, nbytes), dtype=np.uint8)
    packed[:, :n] = np.moveaxis(variants, 1, 0)
    low = np.ones((npad, 1), dtype=np.int32)
    low[:n, 0] = low_conf.astype(np.int32)
    return torch.from_numpy(packed), torch.from_numpy(low), n, npad


def prepare_inputs_device(base_hashes, variants, low_conf):
    """prepare_inputs, moved to the port's device."""
    from .. import device

    var_bits, low, n, npad = prepare_inputs(base_hashes, variants, low_conf)
    dev = device.get()
    return var_bits.to(dev), low.to(dev), n, npad


def prepare_inputs_resident(var_dev: torch.Tensor, low_conf,
                            npad: int | None = None):
    """(N, V, nbytes) u8 variants already on the device (the layout
    pdq_hash_batch emits as 'dihedral') -> padded (V, Npad, nbytes) u8 +
    (Npad, 1) int32 low flags on the same device.  Only the (N,) low
    flags cross from the host."""
    n, v, nbytes = var_dev.shape
    npad = npad or _pad_rows(n)
    dev = var_dev.device
    var_bits = torch.zeros((v, npad, nbytes), dtype=torch.uint8, device=dev)
    var_bits[:, :n] = var_dev.permute(1, 0, 2)
    low = torch.ones((npad, 1), dtype=torch.int32, device=dev)
    if low_conf is not None:
        low[:n, 0] = torch.from_numpy(
            np.asarray(low_conf, dtype=np.int32)).to(dev)
    else:
        low[:n, 0] = 0
    return var_bits, low, n, npad


# --------------------------------------------------------------------------
# K3: count sweep
# --------------------------------------------------------------------------

def _row_counts_plain(q_tile, b_tile, low_i32, nbits, npad, *, sim, n_total,
                      block=None):
    """Shared body of the plain count sweeps: q_tile(q0, q1) gives the
    (V, rows, nbits) and b_tile(b0, b1) the (rows, nbits) +/-1 float32
    tiles; float32 dots are exact for |dot| <= 256.  Only tiles on or
    above the diagonal, and within block = (q_lo, q_hi, b_lo, b_hi)
    when given, are computed."""
    dev = low_i32.device
    counts = torch.zeros(npad, dtype=torch.int32, device=dev)
    low = low_i32[:, 0] != 0
    rows = torch.arange(npad, device=dev)
    n = min(n_total, npad)
    q_lo, q_hi, b_lo, b_hi = block or (0, npad, 0, npad)
    for q0 in range(q_lo, min(q_hi, n), _PLAIN_QT):
        q1 = min(q0 + _PLAIN_QT, q_hi, n)
        qv = q_tile(q0, q1)
        qi = rows[q0:q1, None]
        for b0 in range(max(b_lo, q0 - q0 % _PLAIN_BT), min(b_hi, n),
                        _PLAIN_BT):
            b1 = min(b0 + _PLAIN_BT, b_hi, n)
            best = torch.matmul(qv, b_tile(b0, b1).T).amax(dim=0)  # (tq, tb)
            dotmin = torch.where(low[q0:q1, None] | low[None, b0:b1],
                                 nbits, nbits - 2 * sim)
            mask = (best >= dotmin) & (rows[None, b0:b1] > qi)
            counts[q0:q1] += mask.sum(dim=1, dtype=torch.int32)
    return counts[:, None]


def scan_row_counts_plain(var_bits, low_i32, *, sim=40, n_total=0,
                          block=None):
    """Plain PyTorch version of K3 on the packed hashes."""
    v, npad, nbytes = var_bits.shape
    return _row_counts_plain(
        lambda q0, q1: hamming.unpack_bits_pm1(var_bits[:, q0:q1]).float(),
        lambda b0, b1: hamming.unpack_bits_pm1(var_bits[0, b0:b1]).float(),
        low_i32, nbytes * 8, npad, sim=sim, n_total=n_total, block=block)


def _check_low(low_i32, npad, like):
    if (tuple(low_i32.shape) != (npad, 1) or low_i32.dtype != torch.int32
            or low_i32.device != like.device):
        raise ValueError("low_i32 must be (Npad, 1) int32 beside the hashes")


def sweep_items(n_total: int, npad: int, block=None) -> np.ndarray:
    """K3's work list: (n_items, 4) int32 rows [q0, b_begin, b_end, 0].

    Item k pairs query rows [q0, q0 + SWEEP_QROWS) with base rows
    [b_begin, b_end), a run of at most SWEEP_ITEM_TILES tiles of
    SWEEP_BROWS rows.  Query tiles run over the rows that have a partner
    j > i below n; each one's base tiles start at the tile holding
    q0 + 1, so no tile lies wholly on or below the diagonal, and end at
    the tile holding n - 1.  Every pair i < j < n falls in exactly one
    item.  Items come in query-tile order, so the short runs near the
    end of the triangle are taken last.

    block = (q_lo, q_hi, b_lo, b_hi) keeps only the pairs with query row
    in [q_lo, q_hi) and base row in [b_lo, b_hi): each item cut to the
    block, empty ones dropped.  Block edges must lie on the tile grid
    (multiples of SWEEP_QROWS and SWEEP_BROWS), so a cut item is whole
    tiles of the uncut list: still none wholly on or below the diagonal,
    and the lists of a grid of blocks hold every pair once."""
    n = min(int(n_total), int(npad))
    if block is not None:
        q_lo, q_hi, b_lo, b_hi = block
        if q_lo % SWEEP_QROWS or q_hi % SWEEP_QROWS or b_lo % SWEEP_BROWS \
                or b_hi % SWEEP_BROWS:
            raise ValueError(f"block {block} is off K3's grid of "
                             f"{SWEEP_QROWS} x {SWEEP_BROWS} rows")
        items = sweep_items(n_total, npad)
        items = items[(items[:, 0] >= q_lo) & (items[:, 0] < q_hi)]
        items[:, 1] = np.maximum(items[:, 1], b_lo)
        items[:, 2] = np.minimum(items[:, 2], b_hi)
        return np.ascontiguousarray(items[items[:, 1] < items[:, 2]])
    if n < 2:
        return np.zeros((0, 4), dtype=np.int32)
    q0 = np.arange(0, n - 1, SWEEP_QROWS, dtype=np.int64)
    b_first = (q0 + 1) // SWEEP_BROWS * SWEEP_BROWS
    b_last = -(-n // SWEEP_BROWS) * SWEEP_BROWS
    span = SWEEP_BROWS * SWEEP_ITEM_TILES
    runs = -(-(b_last - b_first) // span)
    first_run = np.repeat(np.cumsum(runs) - runs, runs)
    start = (np.repeat(b_first, runs)
             + span * (np.arange(int(runs.sum())) - first_run))
    items = np.zeros((len(start), 4), dtype=np.int32)
    items[:, 0] = np.repeat(q0, runs)
    items[:, 1] = start
    items[:, 2] = np.minimum(start + span, b_last)
    return items


def sweep_tiles(items: np.ndarray):
    """The (q0, b0, warpgroup) base tiles K3's blocks visit for `items`,
    in the kernel's order: warpgroup g takes tiles b_begin + (2k + g) *
    SWEEP_BROWS."""
    for q0, b_begin, b_end, _ in items.tolist():
        for g in range(SWEEP_GROUPS):
            for b0 in range(b_begin + g * SWEEP_BROWS, b_end,
                            SWEEP_GROUPS * SWEEP_BROWS):
                yield q0, b0, g


@functools.lru_cache(maxsize=64)
def _sweep_items_on(n_total: int, npad: int, dev: torch.device, block=None):
    return torch.from_numpy(sweep_items(n_total, npad, block)).to(dev)


def scan_row_counts(var_bits, low_i32, *, sim=40, n_total=0, block=None):
    """var_bits (V, Npad, nbytes) u8; low_i32 (Npad, 1) int32 -> (Npad, 1)
    int32 per-row match counts over pairs j > i, both < n_total; with
    block = (q_lo, q_hi, b_lo, b_hi) only over the pairs of that block
    (one mesh device's share, parallel/sharded.py), which launches
    nothing when the block holds no pair.  CUDA tensors launch K3; CPU
    tensors take the plain version."""
    v, npad, nbytes = var_bits.shape
    if var_bits.dtype != torch.uint8:
        raise ValueError(f"var_bits must be uint8, got {var_bits.dtype}")
    _check_low(low_i32, npad, var_bits)
    block = None if block is None else tuple(int(x) for x in block)
    if not var_bits.is_cuda:
        return scan_row_counts_plain(var_bits, low_i32, sim=sim,
                                     n_total=n_total, block=block)
    if (nbytes not in KERNEL_NBYTES or v not in KERNEL_VARIANTS
            or npad % ROW_ALIGN):
        raise ValueError(f"K3 takes (1|8, k*{ROW_ALIGN}, 8|32) u8, got "
                         f"{tuple(var_bits.shape)}")
    if not (var_bits.is_contiguous() and low_i32.is_contiguous()):
        raise ValueError("K3 takes contiguous tensors")
    counts = torch.zeros((npad, 1), dtype=torch.int32, device=var_bits.device)
    items = _sweep_items_on(int(n_total), npad, var_bits.device, block)
    if len(items):
        next_item = torch.zeros(1, dtype=torch.int32, device=var_bits.device)
        _build.launch(
            scan_row_counts, "hamming_rowcount_kernel",
            "rupp_hamming_rowcount", var_bits, var_bits.data_ptr(),
            low_i32.data_ptr(), items.data_ptr(), len(items),
            next_item.data_ptr(), v, nbytes, npad, int(n_total), int(sim),
            counts.data_ptr())
    return counts


scan_row_counts.launches = 0


# --------------------------------------------------------------------------
# K6: count sweep on +/-1 int8 tensor cores
# --------------------------------------------------------------------------

def scan_row_counts_pm1_plain(var_pm1, low_i32, *, sim=40, n_total=0):
    """Plain PyTorch version of K6: the same float32 +/-1 dots as K3's."""
    v, npad, nbits = var_pm1.shape
    return _row_counts_plain(
        lambda q0, q1: var_pm1[:, q0:q1].float(),
        lambda b0, b1: var_pm1[0, b0:b1].float(),
        low_i32, nbits, npad, sim=sim, n_total=n_total)


def pm1_sweep_items(n_total: int, npad: int) -> np.ndarray:
    """K6's work list: (n_items, 4) int32 rows [c0, q_begin, q_end, 0].

    Item k pairs the base rows (matrix columns) [c0, c0 + PM1_COLS), which
    a block keeps in registers, with the query rows [q_begin, q_end) that
    stream past them: a run of at most PM1_ITEM_ROWS rows in whole
    granules of PM1_QROWS.  Column blocks run over the rows below n; each
    one's query rows run from 0 to the end of the block (rows at or past a
    column have no pair with it) or to the granule holding n - 2.  Every
    pair i < j < n falls in exactly one item.  Items come run-major: all
    column blocks of one query run are neighbours, so the blocks in
    flight read the same query rows.  The runs past 0.8 n, the last
    twenty-fifth of the pairs, are PM1_TAIL_ROWS long, so that the blocks
    finish within a short item of each other."""
    n = min(int(n_total), int(npad))
    if n < 2:
        return np.zeros((0, 4), dtype=np.int32)
    c0 = np.arange(0, n, PM1_COLS, dtype=np.int64)
    q_last = -(-np.minimum(c0 + PM1_COLS - 1, n - 1) // PM1_QROWS) * PM1_QROWS
    q_cut = n * 4 // 5 // PM1_ITEM_ROWS * PM1_ITEM_ROWS
    begin = np.concatenate([np.arange(0, q_cut, PM1_ITEM_ROWS),
                            np.arange(q_cut, q_last[-1], PM1_TAIL_ROWS)])
    end = np.append(begin[1:], q_last[-1])
    # run t meets the column blocks whose query rows reach past its start
    first = np.searchsorted(q_last, begin, side="right")
    blocks = len(c0) - first
    col = np.arange(int(blocks.sum())) - np.repeat(np.cumsum(blocks) - blocks,
                                                   blocks) + np.repeat(first,
                                                                       blocks)
    items = np.zeros((len(col), 4), dtype=np.int32)
    items[:, 0] = c0[col]
    items[:, 1] = np.repeat(begin, blocks)
    items[:, 2] = np.minimum(np.repeat(end, blocks), q_last[col])
    return items


def pm1_sweep_tiles(items: np.ndarray, n_total: int, npad: int):
    """The (q0, w0) tiles of 16 query rows x PM1_WARP_COLS base rows that
    K6's warps compute for `items`, in the kernel's order.  A warp skips a
    tile whose rows all lie at or past its last column, or past n."""
    n = min(int(n_total), int(npad))
    for c0, q_begin, q_end, _ in items.tolist():
        for q0 in range(q_begin, q_end, 16):
            for w0 in range(c0, c0 + PM1_COLS, PM1_WARP_COLS):
                if not (q0 >= w0 + PM1_WARP_COLS - 1 or w0 >= n or q0 >= n):
                    yield q0, w0


@functools.lru_cache(maxsize=8)
def _pm1_items_on(n_total: int, npad: int, dev: torch.device):
    return torch.from_numpy(pm1_sweep_items(n_total, npad)).to(dev)


def scan_row_counts_pm1(var_pm1, low_i32, *, sim=40, n_total=0):
    """var_pm1 (V, Npad, nbits) int8 in {-1, +1} (the TPU kernels' input,
    hamming.unpack_bits_pm1 of the packed hashes); low_i32 (Npad, 1)
    int32 -> (Npad, 1) int32 per-row match counts over pairs j > i,
    both < n_total: K3's counts.  CUDA tensors launch K6; CPU tensors
    take the plain version."""
    v, npad, nbits = var_pm1.shape
    if var_pm1.dtype != torch.int8:
        raise ValueError(f"var_pm1 must be int8, got {var_pm1.dtype}")
    _check_low(low_i32, npad, var_pm1)
    if not var_pm1.is_cuda:
        return scan_row_counts_pm1_plain(var_pm1, low_i32, sim=sim,
                                         n_total=n_total)
    if (nbits not in tuple(8 * b for b in KERNEL_NBYTES)
            or v not in KERNEL_VARIANTS or npad % ROW_ALIGN):
        raise ValueError(f"K6 takes (1|8, k*{ROW_ALIGN}, 64|256) int8, got "
                         f"{tuple(var_pm1.shape)}")
    if not (var_pm1.is_contiguous() and low_i32.is_contiguous()):
        raise ValueError("K6 takes contiguous tensors")
    if var_pm1.data_ptr() % 16 or low_i32.data_ptr() % 16:
        raise ValueError("K6 copies 16 bytes at a time: both tensors must "
                         "start on a 16-byte boundary")
    counts = torch.zeros((npad, 1), dtype=torch.int32, device=var_pm1.device)
    items = _pm1_items_on(int(n_total), npad, var_pm1.device)
    if len(items):
        next_item = torch.zeros(1, dtype=torch.int32, device=var_pm1.device)
        _build.launch(
            scan_row_counts_pm1, "hamming_rowcount_mma_kernel",
            "rupp_hamming_rowcount_mma", var_pm1, var_pm1.data_ptr(),
            low_i32.data_ptr(), items.data_ptr(), len(items),
            next_item.data_ptr(), v, nbits, npad, int(n_total), int(sim),
            counts.data_ptr())
    return counts


scan_row_counts_pm1.launches = 0


# --------------------------------------------------------------------------
# K4: hot-row extraction
# --------------------------------------------------------------------------

_BIT_WEIGHTS = 1 << np.arange(8, dtype=np.int32)


def extract_rows_packed_plain(q_bits, base_bits, qlow, blow, qidx, *,
                              sim=40, n_total=0):
    """Plain PyTorch version of K4."""
    v, mq, nbytes = q_bits.shape
    nbits = nbytes * 8
    npad = base_bits.shape[0]
    dev = q_bits.device
    qv = hamming.unpack_bits_pm1(q_bits).float()
    weights = torch.from_numpy(_BIT_WEIGHTS).to(dev)
    out = torch.empty((mq, npad // 8), dtype=torch.uint8, device=dev)
    qlo = qlow != 0
    for b0 in range(0, npad, _PLAIN_BT):
        b1 = min(b0 + _PLAIN_BT, npad)
        bt = hamming.unpack_bits_pm1(base_bits[b0:b1]).float()
        best = torch.matmul(qv, bt.T).amax(dim=0)            # (mq, tb)
        dotmin = torch.where(qlo | (blow[None, b0:b1, 0] != 0),
                             nbits, nbits - 2 * sim)
        j = torch.arange(b0, b1, device=dev)[None, :]
        mask = ((best >= dotmin) & (j > qidx) & (j < n_total)
                & (qidx < n_total))
        out[:, b0 // 8:b1 // 8] = (mask.view(mq, -1, 8).to(torch.int32)
                                   * weights).sum(dim=-1).to(torch.uint8)
    return out


def extract_rows_packed(q_bits, base_bits, qlow, blow, qidx, *, sim=40,
                        n_total=0):
    """q_bits (V, MQ, nbytes) u8 hot-row variants; base_bits (Npad, nbytes)
    u8 (variant slot 0); qlow (MQ, 1) / blow (Npad, 1) int32; qidx (MQ, 1)
    int32 row indices counted from base row 0 (>= n_total rows inert;
    negative where base_bits is a slice of the rows that starts past the
    query row, as on a mesh device).  Returns (MQ, Npad/8) u8 packed
    match masks.  CUDA tensors launch K4; CPU tensors
    take the plain version."""
    v, mq, nbytes = q_bits.shape
    npad = base_bits.shape[0]
    for name, t, shape in (("q_bits", q_bits, (v, mq, nbytes)),
                           ("base_bits", base_bits, (npad, nbytes)),
                           ("qlow", qlow, (mq, 1)), ("blow", blow, (npad, 1)),
                           ("qidx", qidx, (mq, 1))):
        want = torch.uint8 if name.endswith("bits") else torch.int32
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{name} must be {shape} {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q_bits.device:
            raise ValueError(f"{name} is on {t.device}, q_bits on "
                             f"{q_bits.device}")
    if npad % 8:
        raise ValueError(f"Npad must be a multiple of 8, got {npad}")
    if not q_bits.is_cuda:
        return extract_rows_packed_plain(q_bits, base_bits, qlow, blow, qidx,
                                         sim=sim, n_total=n_total)
    if (nbytes not in KERNEL_NBYTES or v not in KERNEL_VARIANTS
            or npad % SWEEP_BROWS):
        raise ValueError(f"K4 takes (1|8, MQ, 8|32) u8 against k*"
                         f"{SWEEP_BROWS} base rows, got "
                         f"{tuple(q_bits.shape)}, {npad}")
    if not all(t.is_contiguous() for t in (q_bits, base_bits, qlow, blow,
                                           qidx)):
        raise ValueError("K4 takes contiguous tensors")
    # cleared first: the kernel skips the tiles under the diagonal and
    # stores only words with a match
    out = torch.zeros((mq, npad // 8), dtype=torch.uint8, device=q_bits.device)
    if mq and min(int(n_total), npad) > 0:
        next_item = torch.zeros(1, dtype=torch.int32, device=q_bits.device)
        _build.launch(
            extract_rows_packed, "hamming_extract_kernel",
            "rupp_hamming_extract", q_bits, q_bits.data_ptr(),
            base_bits.data_ptr(), qlow.data_ptr(), blow.data_ptr(),
            qidx.data_ptr(), v, nbytes, mq, npad, int(n_total), int(sim),
            EXTRACT_ITEM_TILES, next_item.data_ptr(), out.data_ptr())
    return out


extract_rows_packed.launches = 0


def row_match_counts(base_hashes: np.ndarray,
                     variants: np.ndarray | None = None,
                     low_conf: np.ndarray | None = None,
                     similarity: int = 40):
    """Host convenience: ((N,) int32 per-row match counts over j > i, N)."""
    var_bits, low, n, _ = prepare_inputs_device(base_hashes, variants,
                                                low_conf)
    counts = scan_row_counts(var_bits, low, sim=similarity, n_total=n)
    return counts[:n, 0].cpu().numpy(), n

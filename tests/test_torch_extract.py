"""The tile walk and the bit packing of the hot-row extraction K4
(csrc/hamming.cu), modelled here on the host step by step: the work
items the kernel derives from the hot rows' indices, the masks that walk
gives through the epilogue's packing steps, held against the plain
version; and the packing model against numpy's packbits.  The kernel
itself runs only on a card (tests/test_torch_cuda.py).  Tolerance: exact."""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import hamming_cuda

QROWS = hamming_cuda.SWEEP_QROWS
BROWS = hamming_cuda.SWEEP_BROWS


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


def extract_items(qidx: np.ndarray, n_total: int, npad: int):
    """The (m0, b_begin, b_end) work items K4's blocks compute for hot
    rows `qidx` ((MQ,) or (MQ, 1) global row indices), as the kernel
    derives them (csrc/hamming.cu): query tile m0 .. m0 + QROWS, whose first base
    tile is the one holding its smallest live index + 1 (rows at or past
    n_total are inert), cut into runs of hamming_cuda.EXTRACT_ITEM_TILES tiles up to
    the tile holding n - 1.  Tiles before the first hold no pair j > i
    of the tile's rows and stay as the wrapper cleared them."""
    qidx = np.asarray(qidx).reshape(-1).astype(np.int64)
    n_live = min(int(n_total), int(npad))
    b_last = -(-n_live // BROWS) * BROWS if n_live > 0 else 0
    span = hamming_cuda.EXTRACT_ITEM_TILES * BROWS
    items = []
    for m0 in range(0, len(qidx), QROWS):
        live = qidx[m0:m0 + QROWS]
        live = live[live < n_total]
        if len(live) == 0:
            continue
        first = (max(int(live.min()), -1) + 1) // BROWS * BROWS
        items += [(m0, b0, min(b0 + span, b_last))
                  for b0 in range(first, b_last, span)]
    return items


def pack_quad_model(pred: np.ndarray) -> np.ndarray:
    """(64, 128) bool predicates of one accumulator tile -> (64, 16) u8
    mask bytes by the kernel's own steps (csrc/hamming.cu pack_quad):
    lane q of a quad holds columns 8i + 2q + e of its row as bit 2i + e
    of a word, spreads the two-bit fields of blocks 4d .. 4d + 3 to the
    bytes of a word shifted by 2q, the quad ORs the four words, and lane
    d keeps bytes 4d .. 4d + 3."""
    pred = np.asarray(pred, dtype=bool)
    rows = pred.shape[0]
    out = np.zeros((rows, 16), dtype=np.uint8)
    for r in range(rows):
        words = []
        for q in range(4):
            w = 0
            for i in range(16):
                for e in range(2):
                    w |= int(pred[r, 8 * i + 2 * q + e]) << (2 * i + e)
            words.append(w)
        for d in range(4):
            total = 0
            for q in range(4):
                x = (words[q] >> (8 * d)) & 0xFF
                total |= (((x | x << 6 | x << 12 | x << 18) & 0x03030303)
                          << (2 * q))
            out[r, 4 * d:4 * d + 4] = np.frombuffer(
                int(total).to_bytes(4, "little"), dtype=np.uint8)
    return out


def _hashes(n, v, nbytes, seed):
    """Random hashes with planted exact, near and variant pairs, some of
    them low-confidence; variant slot 0 is the hash."""
    rng = np.random.default_rng(seed)
    variants = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    for k, (i, j) in enumerate(rng.integers(0, n, (max(2, n // 12), 2))):
        variants[j, 0] = variants[i, k % v]
        if k % 3 == 1:
            variants[j, 0, k % nbytes] ^= np.uint8(1 << (k % 8))
        if k % 7 == 3:
            low[[i, j]] = True
    return np.ascontiguousarray(variants[:, 0]), variants, low


def _hot_rows(where, n, seed):
    rng = np.random.default_rng(seed)
    if where == "start":
        rows = np.arange(0, min(n, 40))
    elif where == "end":
        rows = np.arange(max(0, n - 40), n)
    else:
        rows = np.sort(rng.choice(n, min(n, 70), replace=False))
    mq = -(-len(rows) // 32) * 32
    ridx = np.full(mq, n - 1, dtype=np.int64)      # pad slots: row n-1 ...
    qidx = np.full((mq, 1), n, dtype=np.int32)     # ... with qidx = n, inert
    ridx[:len(rows)] = rows
    qidx[:len(rows), 0] = rows
    return rows, ridx, qidx


@pytest.mark.parametrize("where", ["start", "end", "spread"])
@pytest.mark.parametrize("nbytes", [8, 32])
@pytest.mark.parametrize("v", [1, 8])
@pytest.mark.parametrize("n", [33, 1023, 1025, 3000])
def test_items_hold_every_pair_once_and_walk_gives_plain_masks(n, v, nbytes,
                                                               where):
    sim = 40 if nbytes == 32 else 10
    base, variants, low = _hashes(n, v, nbytes, seed=n + v + nbytes)
    var_bits, low_t, _, npad = hamming_cuda.prepare_inputs(base, variants,
                                                           low)
    rows, ridx, qidx = _hot_rows(where, n, seed=n)
    mq = len(ridx)
    qlow = np.ones((mq, 1), dtype=np.int32)
    qlow[:len(rows), 0] = low[rows]
    items = extract_items(qidx, n, npad)

    # every pair (hot row i, j > i, j < n) lies in exactly one visited
    # tile, and so no skipped tile holds one
    visits = np.zeros((mq, npad), dtype=np.int8)
    for m0, b_begin, b_end in items:
        assert m0 % QROWS == 0 and b_begin % BROWS == 0 and b_end % BROWS == 0
        assert 0 < b_end - b_begin <= BROWS * hamming_cuda.EXTRACT_ITEM_TILES
        assert b_end <= npad
        live = qidx[m0:m0 + QROWS, 0]
        live = live[live < n]
        assert b_begin + BROWS > live.min()      # not wholly under the diagonal
        visits[m0:m0 + QROWS, b_begin:b_end] += 1
    j = np.arange(npad)[None, :]
    pairs = (j > qidx) & (j < n) & (qidx < n)
    assert (visits[pairs] == 1).all()
    assert visits.max() <= 1

    # the walk: +/-1 dots of each visited 64 x 128 tile, max over variants,
    # the threshold and masks, packed by the epilogue's steps
    nbits = nbytes * 8
    pm1 = np.unpackbits(var_bits.numpy(), axis=-1,
                        bitorder="little").astype(np.float32) * 2 - 1
    q = np.zeros((v, -(-mq // QROWS) * QROWS, nbits), dtype=np.float32)
    q[:, :mq] = pm1[:, ridx]
    qi = np.full(q.shape[1], np.iinfo(np.int32).max, dtype=np.int64)
    qi[:mq] = np.where(qidx[:, 0] < n, qidx[:, 0], qi[:mq])
    ql = np.ones(q.shape[1], dtype=bool)
    ql[:mq] = qlow[:, 0] != 0
    blow = low_t.numpy()[:, 0] != 0
    walked = np.zeros((q.shape[1], npad // 8), dtype=np.uint8)
    for m0, b_begin, b_end in items:
        for b0 in range(b_begin, b_end, BROWS):
            best = (q[:, m0:m0 + QROWS] @ pm1[0, b0:b0 + BROWS].T).max(0)
            need = np.where(ql[m0:m0 + QROWS, None] | blow[None, b0:b0 + BROWS],
                            nbits, nbits - 2 * sim)
            jj = np.arange(b0, b0 + BROWS)[None, :]
            pred = (best >= need) & (jj > qi[m0:m0 + QROWS, None]) & (jj < n)
            if pred.any():
                walked[m0:m0 + QROWS, b0 // 8:(b0 + BROWS) // 8] = \
                    pack_quad_model(pred)
    plain = hamming_cuda.extract_rows_packed(
        var_bits[:, torch.from_numpy(ridx)], var_bits[0],
        torch.from_numpy(qlow), low_t, torch.from_numpy(qidx), sim=sim,
        n_total=n)
    assert np.array_equal(walked[:mq], plain.numpy())
    assert walked[mq:].sum() == 0
    if where == "spread" and n >= 1023:
        assert plain.sum() > 0


def test_items_skip_inert_tiles_and_tolerate_unsorted_rows():
    n, npad = 3000, 3072
    # second tile all pads; first tile unsorted: its smallest index decides
    qidx = np.full(128, n, dtype=np.int32)
    qidx[:5] = [2900, 700, 1500, 699, 2999]
    items = extract_items(qidx, n, npad)
    span = hamming_cuda.EXTRACT_ITEM_TILES * BROWS
    assert items == [(0, b0, min(b0 + span, 3072))
                     for b0 in range(640, 3072, span)]
    assert extract_items(np.full(64, n), n, npad) == []
    assert extract_items(np.array([n - 1]), n, npad) == [
        (0, 2944, 3072)]


@pytest.mark.parametrize("seed", range(4))
def test_pack_model_equals_packbits(seed):
    rng = np.random.default_rng(seed)
    pred = rng.random((64, 128)) < (0.5, 0.02, 0.98, 0.2)[seed]
    want = np.packbits(pred, axis=1, bitorder="little")
    assert np.array_equal(pack_quad_model(pred), want)


def test_pack_model_places_every_column():
    """One set column at a time: bit c % 8 of byte c // 8, nothing else."""
    for c in range(128):
        pred = np.zeros((2, 128), dtype=bool)
        pred[1, c] = True
        got = pack_quad_model(pred)
        assert got[0].sum() == 0
        assert got[1, c // 8] == 1 << (c % 8)
        assert np.count_nonzero(got[1]) == 1

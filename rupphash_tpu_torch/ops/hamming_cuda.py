"""K3 (count sweep) and K4 (hot-row extraction) of the Hamming edge
search (csrc/hamming.cu), their plain versions and input preparation.

Replaces rupphash_tpu/ops/hamming_pallas.py::_rowcount_kernel and
::_extract_kernel.  The JAX package fed its kernels +/-1 int8
encodings (V, Npad, nbits); the port keeps the hashes packed, as the
(V, Npad, nbytes) u8 tensor the JAX package shipped to the device
before unpacking it.  The kernels read it in place as 8 x u32 words
per 256-bit hash and test XOR + popcount, the same predicate as the
TPU's dot >= nbits - 2 * sim.  Outputs keep the JAX layouts: per-row
counts (Npad, 1) int32 and packed match masks (MQ, Npad / 8) u8 with
bit j % 8 of byte j // 8.

Rows pad to a multiple of ROW_ALIGN, the count sweep's base tile, so
its shared-memory staging never reads past the end.  Padding rows are
marked low-confidence and masked by index.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, hamming

ROW_ALIGN = 1024          # csrc/hamming.cu kBaseTile
KERNEL_NBYTES = 32        # the kernels take 256-bit (PDQ) hashes
KERNEL_VARIANTS = (1, 8)  # query variant counts the kernels are built for

# plain versions: dot tiles of V x 512 x 2048 float32 (32 MiB at V=8)
_PLAIN_QT = 512
_PLAIN_BT = 2048


def _pad_rows(n: int) -> int:
    return max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)


def prepare_inputs(base_hashes: np.ndarray,
                   variants: np.ndarray | None,
                   low_conf: np.ndarray | None):
    """Host-side packing to the kernel layout.  Returns
    (var_bits (V, Npad, nbytes) u8, low (Npad, 1) int32, n, npad) as CPU
    tensors; query variants in every slot, the base hash in slot 0."""
    n, nbytes = base_hashes.shape
    if variants is None:
        variants = base_hashes[:, None, :]
    v = variants.shape[1]
    if low_conf is None:
        low_conf = np.zeros(n, dtype=bool)
    npad = _pad_rows(n)
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


def prepare_inputs_resident(var_dev: torch.Tensor, low_conf):
    """(N, V, nbytes) u8 variants already on the device (the layout
    pdq_hash_batch emits as 'dihedral') -> padded (V, Npad, nbytes) u8 +
    (Npad, 1) int32 low flags on the same device.  Only the (N,) low
    flags cross from the host."""
    n, v, nbytes = var_dev.shape
    npad = _pad_rows(n)
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

def scan_row_counts_plain(var_bits, low_i32, *, sim=40, n_total=0):
    """Plain PyTorch version of K3: +/-1 float32 dots, exact for
    |dot| <= 256, over tiles on or above the diagonal."""
    v, npad, nbytes = var_bits.shape
    nbits = nbytes * 8
    dev = var_bits.device
    counts = torch.zeros(npad, dtype=torch.int32, device=dev)
    low = low_i32[:, 0] != 0
    rows = torch.arange(npad, device=dev)
    n = min(n_total, npad)
    for q0 in range(0, n, _PLAIN_QT):
        q1 = min(q0 + _PLAIN_QT, n)
        qv = hamming.unpack_bits_pm1(var_bits[:, q0:q1]).float()
        qi = rows[q0:q1, None]
        for b0 in range(q0 - q0 % _PLAIN_BT, n, _PLAIN_BT):
            b1 = min(b0 + _PLAIN_BT, n)
            bt = hamming.unpack_bits_pm1(var_bits[0, b0:b1]).float()
            best = torch.matmul(qv, bt.T).amax(dim=0)        # (tq, tb)
            dotmin = torch.where(low[q0:q1, None] | low[None, b0:b1],
                                 nbits, nbits - 2 * sim)
            mask = (best >= dotmin) & (rows[None, b0:b1] > qi)
            counts[q0:q1] += mask.sum(dim=1, dtype=torch.int32)
    return counts[:, None]


def scan_row_counts(var_bits, low_i32, *, sim=40, n_total=0):
    """var_bits (V, Npad, nbytes) u8; low_i32 (Npad, 1) int32 -> (Npad, 1)
    int32 per-row match counts over pairs j > i, both < n_total.  CUDA
    tensors launch K3; CPU tensors take the plain version."""
    v, npad, nbytes = var_bits.shape
    if var_bits.dtype != torch.uint8:
        raise ValueError(f"var_bits must be uint8, got {var_bits.dtype}")
    if (tuple(low_i32.shape) != (npad, 1) or low_i32.dtype != torch.int32
            or low_i32.device != var_bits.device):
        raise ValueError("low_i32 must be (Npad, 1) int32 beside var_bits")
    if not var_bits.is_cuda:
        return scan_row_counts_plain(var_bits, low_i32, sim=sim,
                                     n_total=n_total)
    if (nbytes != KERNEL_NBYTES or v not in KERNEL_VARIANTS
            or npad % ROW_ALIGN):
        raise ValueError(f"K3 takes (1|8, k*{ROW_ALIGN}, {KERNEL_NBYTES}) "
                         f"u8, got {tuple(var_bits.shape)}")
    if not (var_bits.is_contiguous() and low_i32.is_contiguous()):
        raise ValueError("K3 takes contiguous tensors")
    counts = torch.zeros((npad, 1), dtype=torch.int32, device=var_bits.device)
    err = _build.load().lib.rupp_hamming_rowcount(
        var_bits.data_ptr(), low_i32.data_ptr(), v, npad, int(n_total),
        int(sim), counts.data_ptr(), _build.stream_ptr(var_bits))
    _build.check(err, "hamming_rowcount_kernel")
    scan_row_counts.launches += 1
    return counts


scan_row_counts.launches = 0


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
    int32 global row indices (>= n_total rows inert).  Returns (MQ,
    Npad/8) u8 packed match masks.  CUDA tensors launch K4; CPU tensors
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
    if nbytes != KERNEL_NBYTES or v not in KERNEL_VARIANTS:
        raise ValueError(f"K4 takes (1|8, MQ, {KERNEL_NBYTES}) u8, got "
                         f"{tuple(q_bits.shape)}")
    if not all(t.is_contiguous() for t in (q_bits, base_bits, qlow, blow,
                                           qidx)):
        raise ValueError("K4 takes contiguous tensors")
    out = torch.empty((mq, npad // 8), dtype=torch.uint8, device=q_bits.device)
    err = _build.load().lib.rupp_hamming_extract(
        q_bits.data_ptr(), base_bits.data_ptr(), qlow.data_ptr(),
        blow.data_ptr(), qidx.data_ptr(), v, mq, npad, int(n_total), int(sim),
        out.data_ptr(), _build.stream_ptr(q_bits))
    _build.check(err, "hamming_extract_kernel")
    extract_rows_packed.launches += 1
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

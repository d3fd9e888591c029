"""Multi-process scaling: a sharded input pipeline, one process per host
or card, on torch.distributed.

Counterpart of rupphash_tpu/parallel/multihost.py, which runs on
jax.distributed:

  * the file list is sharded deterministically across processes: each
    walks, decodes and hashes only its shard;
  * hashes are small (32 B, 8 x 32 B with the dihedral variants, per
    image), so the all-pairs grouping gathers them across processes once
    and then runs the ('q', 'b') mesh sweep (parallel/sharded.py) over
    each process's local devices.

The caller initializes the process group (torch.distributed.
init_process_group with its address, world size and rank), as the
reference's caller runs jax.distributed.initialize.  The gathers run on
CPU tensors under gloo and on the rank's current card under NCCL.
Everything is an identity without a process group, or with one process.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_files(files, process_index: int | None = None,
                process_count: int | None = None,
                by: str = "hash"):
    """Deterministic file-list shard for this process.

    by="hash": stable content-independent assignment from the path hash
    (rebalances well for heterogeneous directories); by="stride": every
    k-th file (preserves directory locality for cache warmth).  The
    partition is the reference's byte for byte, so every process can
    rebuild the global order (shard 0, then shard 1, ...)."""
    rank, world = process_info()
    pi = process_index if process_index is not None else rank
    pc = process_count if process_count is not None else world
    if pc <= 1:
        return list(files)
    if by == "stride":
        return [f for i, f in enumerate(files) if i % pc == pi]
    out = []
    for f in files:
        h = hashlib.blake2b(str(f).encode(), digest_size=8).digest()
        if int.from_bytes(h, "little") % pc == pi:
            out.append(f)
    return out


def _gather_device() -> torch.device:
    """Where the collectives' tensors live: the rank's current card under
    NCCL, the host otherwise (gloo)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(x: np.ndarray, dev: torch.device, world: int) -> np.ndarray:
    """(world, *x.shape) array of every rank's equally shaped x; bool
    travels as uint8."""
    t = torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)
                         if x.dtype == bool else np.ascontiguousarray(x))
    t = t.to(dev)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    out = torch.stack(parts).cpu().numpy()
    return out.view(bool) if x.dtype == bool else out


def allgather_hashes(local_hashes: np.ndarray,
                     local_variants: np.ndarray | None = None,
                     local_low: np.ndarray | None = None):
    """Gather per-process hash shards into the global matrices every
    process needs for all-pairs grouping, concatenated in rank order.
    One process: identity.

    all_gather needs equal shapes on every rank, but shard_files' hash
    partition gives unequal shards: the per-rank counts are gathered
    first, every array pads to the largest, and each rank's padding is
    trimmed after the gather."""
    _, world = process_info()
    if world <= 1:
        return local_hashes, local_variants, local_low
    dev = _gather_device()
    counts = _all_gather(np.asarray([len(local_hashes)], dtype=np.int64),
                         dev, world).reshape(-1)
    m = int(counts.max())

    def gather(a):
        if a is None:
            return None
        padded = np.zeros((m,) + a.shape[1:], dtype=a.dtype)
        padded[:len(a)] = a
        g = _all_gather(padded, dev, world)
        return np.concatenate([g[i, :counts[i]] for i in range(world)])

    return gather(local_hashes), gather(local_variants), gather(local_low)

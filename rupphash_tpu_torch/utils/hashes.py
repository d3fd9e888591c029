"""Content/meta/pixel hashing tiers.

Mirrors the reference's keyed-hash identity scheme (src/db.rs:300-321,
src/scanner.rs:1344-1406) with one documented substitution: the reference
uses keyed blake3; this build uses keyed blake2b (hashlib's C
implementation) — same 32-byte digests, same key-blinding property (cache
contents cannot be correlated with public image corpora without the
per-install master key).

Tiers:
  1. content_hash  = keyed_hash(file bytes)           bit-identical files
  2. pixel_hash    = keyed_hash(RGBA16 pixel buffer)  pixel-identical across
                     containers/bit-padding (opt-in, scanner.rs:1392-1406)
  3. PDQ/pHash     = perceptual (ops/)

meta_key = keyed_hash(mtime_ns || size || unique_file_id) gives a
rename-surviving cache identity (db.rs:309-321).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

DIGEST_SIZE = 32


def keyed_hash(key: bytes, data: bytes) -> bytes:
    return hashlib.blake2b(data, key=key, digest_size=DIGEST_SIZE).digest()


def derive_key(master_key: bytes, context: str) -> bytes:
    """Domain-separated subkey derivation (mirrors blake3 derive_key,
    db.rs:521-528): content_key / meta_key / encryption_key."""
    return hashlib.blake2b(master_key, key=context.encode()[:64],
                           digest_size=DIGEST_SIZE).digest()


def content_hash(content_key: bytes, data: bytes) -> bytes:
    """Tier 1: keyed hash of the raw file bytes (scanner.rs:1345)."""
    return keyed_hash(content_key, data)


def pixel_hash_rgba16(content_key: bytes, image: np.ndarray) -> bytes:
    """Tier 2: keyed hash of the decoded RGBA16 buffer (scanner.rs:1395-1398).

    u8 channels widen with the standard x * 257 expansion so that e.g. a
    PNG and a JPEG of identical pixels collide regardless of container.
    """
    img = image
    if img.ndim == 2:
        img = np.stack([img, img, img], axis=-1)
    if img.shape[-1] == 3:
        # opaque in the INPUT dtype's own scale: uint8's 255 widens to
        # 65535 below, but uint16 input skips the widening, so a 255
        # fill would make 16-bit decodes hash differently from 8-bit
        # containers of identical pixels (scanner.rs:1395-1398 uses
        # the Rgba16 opaque value)
        opaque = 255 if img.dtype == np.uint8 else 65535
        alpha = np.full(img.shape[:-1] + (1,), opaque, dtype=img.dtype)
        img = np.concatenate([img, alpha], axis=-1)
    if img.dtype == np.uint8:
        img = img.astype(np.uint16) * 257
    elif img.dtype != np.uint16:
        raise ValueError(f"unsupported pixel dtype {img.dtype}")
    return keyed_hash(content_key, np.ascontiguousarray(img).tobytes())


def meta_key(mkey: bytes, mtime_ns: int, size: int, unique_file_id: int) -> bytes:
    """Rename-surviving cache identity (db.rs:309-321)."""
    payload = (mtime_ns.to_bytes(16, "little", signed=True)
               + size.to_bytes(8, "little")
               + unique_file_id.to_bytes(16, "little"))
    return keyed_hash(mkey, payload)


def unique_file_id(st: os.stat_result) -> int:
    """(dev, inode) -> u128 identity (fileops.rs:429-466)."""
    return (st.st_dev << 64) | (st.st_ino & ((1 << 64) - 1))


def file_identity(path: str | os.PathLike):
    """(unique_file_id, size, mtime_ns) for cache probing."""
    st = os.stat(path)
    return unique_file_id(st), st.st_size, st.st_mtime_ns

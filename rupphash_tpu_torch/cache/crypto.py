"""Value encryption for the cache: XChaCha20-Poly1305 with AAD binding.

Mirrors the reference's crypto envelope (src/db.rs:634-673): every stored
value is encrypted with a random 24-byte nonce and the database key as
AAD, so ciphertexts cannot be swapped between cache slots undetected.

The `cryptography` wheel ships ChaCha20Poly1305 (96-bit nonce) but not
XChaCha; the 24-byte extended nonce is derived per RFC draft
(irtf-cfrg-xchacha): subkey = HChaCha20(key, nonce[:16]), then IETF
ChaCha20-Poly1305 with nonce = 4 zero bytes || nonce[16:24].  HChaCha20
is implemented here (pure-Python hot loop is ~20 us/value; a native
fallback lives in native/ruppnative.cpp when built).
"""

from __future__ import annotations

import os
import struct

from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

NONCE_LEN = 24
MASK32 = 0xFFFFFFFF

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter(state, a, b, c, d):
    x = state
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 16) | (x[d] >> 16)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 12) | (x[b] >> 20)) & MASK32
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 8) | (x[d] >> 24)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 7) | (x[b] >> 25)) & MASK32


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 (RFC draft irtf-cfrg-xchacha section 2.2)."""
    assert len(key) == 32 and len(nonce16) == 16
    x = list(_SIGMA) + list(struct.unpack("<8L", key)) \
        + list(struct.unpack("<4L", nonce16))
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return struct.pack("<8L", *(x[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


def _subkey_nonce(key: bytes, nonce24: bytes):
    from .. import native
    subkey = native.hchacha20(key, nonce24[:16]) \
        or hchacha20(key, nonce24[:16])
    return subkey, b"\x00\x00\x00\x00" + nonce24[16:]


def encrypt(key: bytes, plaintext: bytes, aad: bytes) -> bytes:
    """nonce(24) || ciphertext+tag.  AAD = the cache key (db.rs:660-666).

    The full AEAD runs in one native call when the C library is built
    (ruppnative.cpp xchacha20poly1305_seal — a warm rescan decrypts 4
    values per file and the per-value Python envelope measured ~35% of
    the probe loop); byte-compatible fallback below."""
    from .. import native
    nonce = os.urandom(NONCE_LEN)
    ct = native.xchacha_seal(key, nonce, plaintext, aad)
    if ct is None:
        subkey, n12 = _subkey_nonce(key, nonce)
        ct = ChaCha20Poly1305(subkey).encrypt(n12, plaintext, aad)
    return nonce + ct


def decrypt(key: bytes, blob: bytes, aad: bytes) -> bytes:
    """Raises cryptography.exceptions.InvalidTag on tamper/swap/truncation."""
    from .. import native
    if len(blob) < NONCE_LEN + 16:  # full nonce + poly1305 tag minimum
        # a truncated DB row must fail like tampering — passing a short
        # nonce down would over-read in the native HChaCha20 core
        from cryptography.exceptions import InvalidTag
        raise InvalidTag()
    nonce, ct = blob[:NONCE_LEN], blob[NONCE_LEN:]
    try:
        pt = native.xchacha_open(key, nonce, ct, aad)
    except native.NativeTagError:
        from cryptography.exceptions import InvalidTag
        raise InvalidTag() from None
    if pt is not None:
        return pt
    subkey, n12 = _subkey_nonce(key, nonce)
    return ChaCha20Poly1305(subkey).decrypt(n12, ct, aad)

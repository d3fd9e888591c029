"""Shared scaffolding for the fused probe decoders (jpegfast/pngfast).

Each fast path is a lazily-built .so (like ruppnative, built atomically
into build/rupphash_tpu_torch/native/ by native/_build.py) plus a runtime
self-probe: a deterministic corpus is decoded through BOTH the fused
path and the PIL route and bit-compared once per process; any mismatch
(or a missing system library) disables the fast path on this machine,
so production output can never diverge from the PIL semantics the
tests pin down.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

from . import _build


class FastLib:
    """Build-on-first-use ctypes library with a validation probe.

    `configure(lib)` sets restype/argtypes; `self_probe()` returns
    True when the fused output bit-matches the PIL route on the probe
    corpus.  `env_off` force-disables (escape hatch + lets the
    equivalence tests drive the slow path).
    """

    def __init__(self, src: Path, so_name: str, ldflags: list[str],
                 configure, self_probe, env_off: str,
                 deps: list[Path] | None = None):
        self._src = src
        self._deps = list(deps or [])
        self._so_name = so_name
        self._ldflags = ldflags
        self._configure = configure
        self._self_probe = self_probe
        self._env_off = env_off
        self._lock = threading.RLock()
        self._lib = None
        self._state: bool | None = None  # None=unprobed, False=off

    def _build(self) -> Path | None:
        # -march=native vectorizes the luma/resample loops;
        # -ffp-contract=off forbids FMA contraction so the float64
        # resample math stays bit-identical to box_resample_u8 (the
        # golden was compiled contraction-free on baseline x86-64).
        return _build.ensure(
            self._src, self._so_name,
            [["-O3", "-march=native", "-ffp-contract=off"],
             ["-O3", "-ffp-contract=off"]],
            ldflags=self._ldflags, deps=self._deps)

    def get_lib(self):
        if self._lib is not None or self._state is False:
            return self._lib
        with self._lock:
            if self._lib is not None or self._state is False:
                return self._lib
            # staleness vs the source AND every #include'd project
            # header (rupp_stream.h) — editing the shared header must
            # trigger a rebuild too
            so = self._build()
            if so is None:
                self._state = False
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                self._state = False
                return None
            self._configure(lib)
            self._lib = lib
            return self._lib

    def available(self) -> bool:
        if os.environ.get(self._env_off):
            return False
        if self._state is not None:
            return self._state
        with self._lock:
            if self._state is not None:
                return self._state
            ok = self.get_lib() is not None
            if ok:
                try:
                    ok = self._self_probe()
                except Exception:
                    ok = False
            self._state = ok
            return self._state


def _target_dims(w: int, h: int) -> tuple[int, int]:
    """Probe-luma target dims: the reference's <=512 aspect-keeping
    downsample when either side exceeds it, else native size."""
    from ..ops import pdq_ref

    if w > pdq_ref.DOWNSAMPLE_DIMS or h > pdq_ref.DOWNSAMPLE_DIMS:
        return pdq_ref.calculate_target_dimensions(w, h)
    return w, h


def probe_luma_via(available_fn, dims_fn, decode_fn, data: bytes):
    """Shared gating for the per-format probe_luma entry points:
    availability, MIN_HASHABLE_DIM / MAX_PIXELS window, target dims,
    decode, and the header-vs-decoder dims cross-check.  Returns
    (luma, (w, h)) or None => the caller uses the PIL path."""
    from ..ops import pdq_ref
    from ..pipeline.decode import MAX_PIXELS

    if not available_fn():
        return None
    dims = dims_fn(data)
    if dims is None:
        return None
    w, h = dims
    if (w < pdq_ref.MIN_HASHABLE_DIM or h < pdq_ref.MIN_HASHABLE_DIM
            or w * h > MAX_PIXELS):
        return None
    nw, nh = _target_dims(w, h)
    got = decode_fn(data, nw, nh)
    if got is None or got[1] != (w, h):
        return None
    return got[0], (w, h)


def self_probe_via(dims_fn, decode_fn, corpus) -> bool:
    """Shared self-probe loop: every corpus stream must decode through
    BOTH the fused path and the PIL route to bit-identical luma."""
    import numpy as np

    from ..pipeline import decode as dec

    for data in corpus:
        dims = dims_fn(data)
        if dims is None:
            return False
        w, h = dims
        nw, nh = _target_dims(w, h)
        got = decode_fn(data, nw, nh)
        if got is None or got[1] != (w, h):
            return False
        img = dec.decode_bytes(data)
        if img is None:
            return False
        want = dec.prepare_luma_fast(img)
        if want is None or not np.array_equal(got[0], want):
            return False
    return True

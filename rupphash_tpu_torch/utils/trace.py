"""Tracing / observability: greppable stderr tags + phase timing.

The reference's observability is deliberately lightweight (SURVEY.md
section 5): eprintln! with greppable tags ([CACHE-FULL], [SYSTEM],
[ERROR-DB], ...), debug-only verbose logging, and inline Instant timing
of the hash and group phases printed with counts (scanner.rs:1542-1559).
This module provides the same affordances:

  tag(name, msg)        stderr line "[NAME] msg", rate-unlimited
  debug(name, msg)      emitted only when RUPPHASH_DEBUG is set
                        (img_debug! analogue, scanner.rs:51-57)
  Phase("hash")         context manager: wall time + item counts,
                        reported via tag("TIMING", ...)
  counters              process-global counter map for cache hit tiers
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

_counters: dict[str, int] = collections.defaultdict(int)
_lock = threading.Lock()

DEBUG = os.environ.get("RUPPHASH_DEBUG", "").strip().lower() \
    not in ("", "0", "false", "no")


def tag(name: str, msg: str):
    print(f"[{name}] {msg}", file=sys.stderr, flush=True)


def debug(name: str, msg: str):
    if DEBUG:
        tag(name, msg)


def count(name: str, inc: int = 1):
    with _lock:
        _counters[name] += inc


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters():
    with _lock:
        _counters.clear()


class Phase:
    """Timed phase with item count, mirroring the reference's inline
    Instant timing (scanner.rs:1542-1559)."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.items = 0
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def add(self, n: int = 1):
        self.items += n

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet:
            rate = self.items / self.elapsed if self.elapsed > 0 else 0.0
            tag("TIMING", f"{self.name}: {self.elapsed:.3f}s"
                + (f", {self.items} items ({rate:,.0f}/s)"
                   if self.items else ""))
        return False

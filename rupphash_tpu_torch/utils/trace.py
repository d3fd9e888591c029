"""Tracing / observability: greppable stderr tags, phase timing, and
spans on the profiler's clock.

The reference's observability is deliberately lightweight (SURVEY.md
section 5): eprintln! with greppable tags ([CACHE-FULL], [SYSTEM],
[ERROR-DB], ...), debug-only verbose logging, and inline Instant timing
of the hash and group phases printed with counts (scanner.rs:1542-1559).
This module provides the same affordances, and spans besides:

  tag(name, msg)        stderr line "[NAME] msg", rate-unlimited
  debug(name, msg)      emitted only when RUPPHASH_DEBUG is set
                        (img_debug! analogue, scanner.rs:51-57)
  Phase("hash")         context manager: a span that also reports its
                        wall time and item count via tag("TIMING", ...)
  counters              process-global counter map for cache hit tiers
  span(name, **counts)  context manager: one record of the layer it
                        wraps, with the counts taken there

A span records only while RUPPHASH_TRACE is set, a torch profiler is
recording, or the code runs inside recording().  Otherwise span()
returns a shared no-op object after one flag check.  Each record holds
its name, id, the ids of its parent and of its root (one grouping or
one request shares the root's id), the thread, start_ns and end_ns from
time.time_ns() (the Unix clock torch.profiler stamps its host and
device events on) and its counts.  While a profiler records, a span
also opens torch.profiler.record_function(name), so its range sits,
nested, on the profiler's timeline above the kernels it launched.  No
span waits for the device: around an asynchronous launch it holds host
time, and the device time is on the profiler's timeline.

Records stay in memory, the newest MAX_RECORDS of them (spans(),
clear()).  When RUPPHASH_TRACE names a file, the process writes them
there at exit as Chrome trace-event JSON (export()), the format
torch.profiler exports, so that both open together in Perfetto.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time

_counters: dict[str, int] = collections.defaultdict(int)
_lock = threading.Lock()

DEBUG = os.environ.get("RUPPHASH_DEBUG", "").strip().lower() \
    not in ("", "0", "false", "no")

# RUPPHASH_TRACE: unset, "", "0", "false" or "no" is off; "1", "true",
# "yes" or "on" records in memory; any other value is the file the
# records are written to at exit
_TRACE = os.environ.get("RUPPHASH_TRACE", "").strip()
TRACE_FILE = (None if _TRACE.lower() in ("", "0", "false", "no", "1",
                                         "true", "yes", "on") else _TRACE)
MAX_RECORDS = 1_000_000

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()
# > 0 while spans record whatever the profiler does: the switch, plus
# one for each open recording() block
_forced = int(_TRACE.lower() not in ("", "0", "false", "no"))


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


def _profiling() -> bool:
    """Whether a torch profiler records: torch.autograd.profiler's flag,
    set for every thread, where this torch has it.  A process that has
    not imported torch runs no profiler."""
    ap = sys.modules.get("torch.autograd.profiler")
    if ap is None:
        return False
    flag = getattr(ap, "_is_profiler_enabled", None)
    if flag is None:
        import torch

        return torch._C._autograd._profiler_enabled()
    return flag


class _Off:
    """What span() returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int = 1):
        pass


_OFF = _Off()


class Span:
    """One record: a context manager while open, then an entry of
    spans().  Times are time.time_ns() nanoseconds."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "counts", "_range")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        self.thread = threading.get_native_id()
        stack.append(self)
        # stamped before the profiler's range opens and after it closes,
        # so that the range's own cost, about a millisecond the first
        # time a process opens one, lies inside the span
        self.start_ns = time.time_ns()
        self._range = None
        if _profiling():
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def count(self, key: str, n: int = 1):
        self.counts[key] = self.counts.get(key, 0) + n

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _local.stack.pop()
        _records.append(self)
        return False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, {self.duration_ns / 1e6:.3f} ms, "
                f"{self.counts})")


def span(name: str, **counts):
    """A span of `name` with initial counts; `.count(key, n)` adds to
    them.  A no-op object unless spans record (see the module's
    docstring)."""
    if not (_forced or _profiling()):
        return _OFF
    return Span(name, counts)


def spans() -> list[Span]:
    """The records kept, oldest first (each complete: spans still open
    are not listed)."""
    return list(_records)


def clear():
    _records.clear()


@contextlib.contextmanager
def recording():
    """Spans record inside the block whatever the switch and the
    profiler.  Yields a list that is filled, at the block's end, with
    the records of the spans opened in it."""
    global _forced
    with _lock:
        _forced += 1
    first = next(_ids)
    got: list[Span] = []
    try:
        yield got
    finally:
        with _lock:
            _forced -= 1
        got.extend(s for s in spans() if s.id > first)


def export(path) -> int:
    """Write the records kept to `path` as Chrome trace-event JSON: one
    complete event ("ph": "X") a record, "ts" and "dur" in microseconds
    on the Unix clock, the ids and counts in "args".  Returns the number
    of events."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "cat": "rupphash",
               "ts": s.start_ns / 1e3, "dur": s.duration_ns / 1e3,
               "pid": pid, "tid": s.thread,
               "args": dict(s.counts, id=s.id, parent=s.parent,
                            root=s.root)}
              for s in spans()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def _export_at_exit():
    import multiprocessing

    # the process that set the switch writes the file, never a worker
    # that inherited it
    if multiprocessing.parent_process() is None:
        export(TRACE_FILE)


if TRACE_FILE:
    atexit.register(_export_at_exit)


class Phase:
    """Timed phase with item count, mirroring the reference's inline
    Instant timing (scanner.rs:1542-1559); a span "phase.<name>" with
    the count "items"."""

    def __init__(self, name: str):
        self.name = name
        self.items = 0

    def __enter__(self):
        self._span = span("phase." + self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def add(self, n: int = 1):
        self.items += n
        self._span.count("items", n)

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        rate = self.items / elapsed if elapsed > 0 else 0.0
        tag("TIMING", f"{self.name}: {elapsed:.3f}s"
            + (f", {self.items} items ({rate:,.0f}/s)" if self.items else ""))
        return False

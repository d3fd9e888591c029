"""The traced run's two sources: the benchmark's own spans around public
functions of the port, and torch.profiler's device timeline.

Spans are installed by name in the traced run only (each metric reader
lists the functions it times in SPANS) and removed before the check.
Each span is also a profiler range (record_function), so the timeline
can say which span launched a kernel and what the host was doing while
the device idled.  The program's own spans (utils/trace) open such
ranges too while the profiler records, and the timeline takes them
beside the benchmark's: an idle gap goes to the innermost of either.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from collections import defaultdict

WINDOW = "phbench.window"


class Spans:
    """Host-clock spans around named functions, {name: [(t0, t1), ...]}."""

    def __init__(self):
        self.records: dict[str, list] = defaultdict(list)
        self._undo: list = []

    def install(self, name: str, target: str):
        """Wrap `target` ("package.module:Attr.attr") so that each call
        records a span `name` and opens a profiler range of that name."""
        import torch

        module, attr = target.split(":")
        owner = importlib.import_module(module)
        parts = attr.split(".")
        for p in parts[:-1]:
            owner = getattr(owner, p)
        orig = getattr(owner, parts[-1])
        rec = self.records[name]

        @functools.wraps(orig)
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    rec.append((t0, time.perf_counter()))

        setattr(owner, parts[-1], spanned)
        self._undo.append((owner, parts[-1], orig))

    def remove(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for t0, t1 in self.records.get(name, [])]


def all_threads() -> dict:
    """Profiler arguments that record host operations on every thread (the
    service's handlers run on threads of their own), where this torch
    offers it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


def _ns(event, edge: str) -> int:
    fn = getattr(event, f"{edge}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{edge}_us")() * 1000)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Timeline:
    """The profiler's events over the traced window, reduced: device busy
    time, device time by kernel name and by the span that launched it,
    and idle gaps by the span the host was in.  A span is a host range
    of the benchmark's (phbench.*) or any other user annotation
    (record_function), as the program's spans open."""

    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        self.window = None
        self.device_events = []          # (start, end, name, host op id)
        ranges = defaultdict(list)       # span name -> [(start, end)]
        per_thread = defaultdict(lambda: defaultdict(list))
        ops = {}                         # host op id -> (thread, start)
        for e in events:
            name = e.name()
            start = _ns(e, "start")
            end = start + (int(e.duration_ns()) if hasattr(e, "duration_ns")
                           else int(e.duration_us() * 1000))
            if e.device_type() == cuda:
                if name.startswith("phbench.") or getattr(
                        e, "is_user_annotation", lambda: False)():
                    continue     # a span mirrored on the device's timeline
                # a kernel or copy links to the host operation that
                # launched it (the runtime call links to the same id)
                self.device_events.append((start, end, name,
                                           e.linked_correlation_id()))
            elif name == WINDOW:
                self.window = (start, end)
            elif e.linked_correlation_id():
                continue         # a runtime call (cudaLaunchKernel, ...)
            else:
                ops[e.correlation_id()] = (e.start_thread_id(), start)
                if name.startswith("phbench.") or getattr(
                        e, "is_user_annotation", lambda: False)():
                    ranges[name].append((start, end))
                    per_thread[name][e.start_thread_id()].append((start, end))
        if self.window is None:
            raise RuntimeError(f"the profile holds no {WINDOW} range")
        w0, w1 = self.window
        self.window_s = (w1 - w0) / 1e9
        self.device_events = [(max(s, w0), min(e, w1), n, op)
                              for s, e, n, op in self.device_events
                              if e > w0 and s < w1]
        self.busy = _merge((s, e) for s, e, _, _ in self.device_events)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self._ranges = ranges
        self._ops = ops
        self._spans = {n: {t: sorted(v) for t, v in per.items()}
                       for n, per in per_thread.items()}

    def kernel_s(self, substring: str = "") -> float:
        """Device seconds of the events whose name holds `substring`."""
        return sum(e - s for s, e, n, _ in self.device_events
                   if substring in n) / 1e9

    def kernel_count(self, substring: str) -> int:
        return sum(1 for _, _, n, _ in self.device_events if substring in n)

    def _inside(self, name: str, thread, ts) -> bool:
        spans = self._spans.get(name, {}).get(thread)
        if not spans:
            return False
        k = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return k >= 0 and spans[k][0] <= ts <= spans[k][1]

    def span_device_s(self, name: str):
        """Device seconds of the operations launched inside span `name`
        (a kernel's host operation started inside the span on the same
        thread), or None when no device operation could be tied to its
        host operation."""
        total, tied = 0, 0
        for s, e, _, op in self.device_events:
            host = self._ops.get(op)
            if host is None:
                continue
            tied += 1
            if self._inside(name, *host):
                total += e - s
        return total / 1e9 if tied else None

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for s, e, n, _ in self.device_events:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time by the span the host was in: each stretch of
        idle time goes to the innermost span covering it (spans taken
        shortest first), the rest to 'outside spans'."""
        w0, w1 = self.window
        edges = [w0] + [x for b in self.busy for x in b] + [w1]
        idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        names = sorted(self._ranges, key=lambda n: sorted(
            e - s for s, e in self._ranges[n])[len(self._ranges[n]) // 2])
        by = {}
        for n in names:
            span = _merge(self._ranges[n])
            by[n] = _length(_intersect(idle, span))
            idle = _subtract(idle, span)
        by["outside spans"] = _length(idle)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top if v > 0]


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def _intersect(a, b) -> list:
    """Intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a, b) -> list:
    """The parts of sorted disjoint intervals `a` outside those of `b`."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


class Trace:
    """What a metric reader reads: spans, the timeline (None in a run
    without the profiler) and the cell driver's counters."""

    def __init__(self, spans: Spans, timeline, counters: dict):
        self.spans = spans
        self.timeline = timeline
        self.counters = counters

"""The program's own spans (rupphash_tpu_torch.utils.trace), as the
program_span metrics of the grouping path read them.

The program records its spans while a profiler records, so a traced
run's records are those of its window.  The readers clear the records
when they are loaded, before set-up, since the CPU tests run several
cells in one process.  A program without the span registry gives no
records, and every reader then returns None.

A grouping is a root span named "group" (engine.group_files) with the
records that share its id as their root.
"""

import statistics

ROOT = "group"


def _registry():
    from rupphash_tpu_torch.utils import trace

    if hasattr(trace, "spans") and hasattr(trace, "clear"):
        return trace
    return None


def clear() -> None:
    reg = _registry()
    if reg is not None:
        reg.clear()


def groupings() -> list[list]:
    """One list of records a grouping, its root first."""
    reg = _registry()
    if reg is None:
        return []
    records = reg.spans()
    by_root = {s.id: [s] for s in records
               if s.name == ROOT and s.parent is None}
    for s in records:
        if s.root in by_root and s.id != s.root:
            by_root[s.root].append(s)
    return list(by_root.values())


def median_ms(name: str):
    """Median over the groupings of the summed duration (ms) of the spans
    `name` in each, or None where no grouping holds one."""
    groups = groupings()
    if not any(s.name == name for g in groups for s in g):
        return None
    return statistics.median(
        sum(s.end_ns - s.start_ns for s in g if s.name == name)
        for g in groups) / 1e6


def self_ns(root, records) -> int:
    """The part of `root`'s duration that its direct children in
    `records` do not cover."""
    covered, last = 0, root.start_ns
    for s in sorted((s for s in records if s.parent == root.id),
                    key=lambda s: s.start_ns):
        start, end = max(s.start_ns, last), min(s.end_ns, root.end_ns)
        if end > start:
            covered += end - start
            last = end
    return root.end_ns - root.start_ns - covered


def self_ms():
    """Median over the groupings of the root span's self time (ms)."""
    groups = groupings()
    if not groups:
        return None
    return statistics.median(self_ns(g[0], g) for g in groups) / 1e6

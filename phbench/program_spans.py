"""The program's own spans (rupphash_tpu_torch.utils.trace), as the
program_span metrics of the grouping path read them.

The program records its spans while a profiler records, so a traced
run's records are those of its window.  The readers clear the records
when they are loaded, before set-up, since the CPU tests run several
cells in one process.  A program without the span registry gives no
records, and every reader then returns None.

A grouping is a root span named "group" (engine.group_files) with the
records that share its id as their root.  Readers of other paths name
their own root span (a request, a scan stage): each function takes it as
`root`, "group" unless given.
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


def groupings(root: str = ROOT) -> list[list]:
    """One list of records a root span named `root` (a grouping unless
    given), the root first."""
    reg = _registry()
    if reg is None:
        return []
    records = reg.spans()
    by_root = {s.id: [s] for s in records
               if s.name == root and s.parent is None}
    for s in records:
        if s.root in by_root and s.id != s.root:
            by_root[s.root].append(s)
    return list(by_root.values())


def median_ms(name: str, root: str = ROOT):
    """Median over the roots `root` of the summed duration (ms) of the
    spans `name` in each, or None where no root holds one."""
    groups = groupings(root)
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


def self_ms(root: str = ROOT):
    """Median over the roots `root` of their self time (ms)."""
    groups = groupings(root)
    if not groups:
        return None
    return statistics.median(self_ns(g[0], g) for g in groups) / 1e6

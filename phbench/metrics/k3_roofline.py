"""K3's share of its roofline in the library cells: the least time of the
count sweep at this size (roofline.sweep_bound: every pair, 8 variants,
int8 at the published peak, the hashes read once) over the profiler's
device time of hamming_rowcount_kernel per grouping."""

from phbench import roofline

KERNEL = "hamming_rowcount_kernel"


def read(trace):
    tl, c = trace.timeline, trace.counters
    if tl is None or not tl.kernel_count(KERNEL):
        return None
    per_grouping = tl.kernel_s(KERNEL) / c["groupings"]
    n, v, nbits = c["files"], c["variants"], c["nbits"]
    b = roofline.sweep_bound(n, v, nbits, n * v * nbits / 8)
    return 100.0 * b["bound_ms"] / 1e3 / per_grouping

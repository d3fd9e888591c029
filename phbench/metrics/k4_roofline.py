"""K4's share of its roofline in the library cells: the least time of the
hot-row extraction for this input's hot rows (roofline.extract_bound:
each hot row against its later rows, 8 variants, int8 at the published
peak) over the profiler's device time of hamming_extract_kernel per
grouping.  Hot rows are the rows with a later match in the reference's
edge set."""

from phbench import roofline

KERNEL = "hamming_extract_kernel"


def read(trace):
    tl, c = trace.timeline, trace.counters
    if tl is None or not tl.kernel_count(KERNEL) or not len(c["hot_rows"]):
        return None
    per_grouping = tl.kernel_s(KERNEL) / c["groupings"]
    b = roofline.extract_bound(c["files"], c["hot_rows"], c["variants"],
                               c["nbits"])
    return 100.0 * b["bound_ms"] / 1e3 / per_grouping

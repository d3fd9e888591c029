"""Median host wall of grouping.engine.finalize_edges per grouping: the
native union-find, the stem merge, analyze_group and the ordering."""

import statistics

SPANS = {"phbench.cluster":
         "rupphash_tpu_torch.grouping.engine:finalize_edges"}


def read(trace):
    d = trace.spans.durations("phbench.cluster")
    return statistics.median(d) * 1e3 if d else None

"""Median, per grouping, of the host wall of grouping.engine.group_files
less its edge search and its clustering: the scans over the records, the
low-quality flags, _resident_rows' stamp check and the gather."""

import statistics

SPANS = {"phbench.group_files":
         "rupphash_tpu_torch.grouping.engine:group_files",
         "phbench.edge_search":
         "rupphash_tpu_torch.ops.hamming:find_edges_fast_resident",
         "phbench.cluster":
         "rupphash_tpu_torch.grouping.engine:finalize_edges"}


def read(trace):
    whole = trace.spans.durations("phbench.group_files")
    edges = trace.spans.durations("phbench.edge_search")
    clus = trace.spans.durations("phbench.cluster")
    if not whole or not (len(whole) == len(edges) == len(clus)):
        return None
    return statistics.median(
        w - e - c for w, e, c in zip(whole, edges, clus)) * 1e3

"""Median host wall of ops.hamming.find_edges_fast_resident per grouping
(prepare, K3, compaction, K4 chunks, host assembly; it ends in the edges'
readback, so the device work is inside)."""

import statistics

SPANS = {"phbench.edge_search":
         "rupphash_tpu_torch.ops.hamming:find_edges_fast_resident"}


def read(trace):
    d = trace.spans.durations("phbench.edge_search")
    return statistics.median(d) * 1e3 if d else None

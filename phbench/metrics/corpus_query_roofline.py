"""The corpus query's share of its roofline: the least time of one query
whatever implements it (roofline.corpus_query_bound: the packed rows and
their status read once, 8 variants' +/-1 dots as int8), times the
queries, over the device time of the operations launched inside
serve.HashIndex.query (tied to the span by the profiler's correlation of
each launch with its host thread and time)."""

from phbench import roofline

SPANS = {"phbench.corpus_query": "rupphash_tpu_torch.serve:HashIndex.query"}


def read(trace):
    tl, c = trace.timeline, trace.counters
    if tl is None:
        return None
    dev_s = tl.span_device_s("phbench.corpus_query")
    queries = len(trace.spans.durations("phbench.corpus_query"))
    if not dev_s or not queries:
        return None
    b = roofline.corpus_query_bound(c["rows"], c["variants"], c["nbits"])
    return 100.0 * b["bound_ms"] / 1e3 * queries / dev_s

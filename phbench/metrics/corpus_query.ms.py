"""Median host wall of serve.HashIndex.query per request: the upload of
the variants, the unpack, the matmul, the gates, the top-k over the 1M
rows and the readback."""

import statistics

SPANS = {"phbench.corpus_query": "rupphash_tpu_torch.serve:HashIndex.query"}


def read(trace):
    d = trace.spans.durations("phbench.corpus_query")
    return statistics.median(d) * 1e3 if d else None

"""Median host wall of serve.NearDupService.hash_bytes per request: the
decode, the luma plane, K1 at B=1 and the variants' readback."""

import statistics

SPANS = {"phbench.hash_bytes":
         "rupphash_tpu_torch.serve:NearDupService.hash_bytes"}


def read(trace):
    d = trace.spans.durations("phbench.hash_bytes")
    return statistics.median(d) * 1e3 if d else None

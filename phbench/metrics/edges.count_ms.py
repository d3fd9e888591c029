"""Median per grouping of the program's span edges.count, summed within
each grouping: the count sweep's launch (K3) up to the hot rows on the
host, the readback waiting for the sweep."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("edges.count")

"""Median per grouping of the program's span edges.extract, summed within
each grouping: the K4 chunks, their compaction and readback, and the
host's assembly of the edges."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("edges.extract")

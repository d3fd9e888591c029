"""Median per grouping of the program's span cluster.analyze, summed within
each grouping: every analyze_group call, the location sort where asked
and the groups' final order."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("cluster.analyze")

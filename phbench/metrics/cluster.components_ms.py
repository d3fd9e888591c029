"""Median per grouping of the program's span cluster.components, summed
within each grouping: the native union-find and the components built
from its roots (a loop over every file)."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("cluster.components")

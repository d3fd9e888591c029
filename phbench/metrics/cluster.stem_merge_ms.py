"""Median per grouping of the program's span cluster.stem_merge, summed
within each grouping: engine.merge_groups_by_stem."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("cluster.stem_merge")

"""Median per grouping of the program's span group.select, summed within
each grouping: engine.group_files' scans of the records: the hashed
ones, their low-quality flags and the map back to the file list."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("group.select")

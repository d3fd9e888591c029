"""Median per grouping of the self time of the program's root span group
(engine.group_files): its wall less what its direct children
group.select, group.resident_rows, edges and cluster cover."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.self_ms()

"""Median per grouping of the program's span group.resident_rows, summed
within each grouping: engine._resident_rows: the check of every record's
device_slot stamp, the batches' torch.cat and the rows' index_select."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("group.resident_rows")

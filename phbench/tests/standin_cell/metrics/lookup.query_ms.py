"""Median duration of the program's root span index.query
(serve.HashIndex.query): one batch of lookups."""

from phbench import program_spans

program_spans.clear()


def read(trace):
    return program_spans.median_ms("index.query", root="index.query")

"""Duplicate grouping: device edge search + host clustering semantics."""

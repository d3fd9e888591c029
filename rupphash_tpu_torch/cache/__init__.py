"""Encrypted incremental cache: the framework's checkpoint/resume story."""

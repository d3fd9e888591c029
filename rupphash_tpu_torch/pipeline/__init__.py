"""Scan orchestration: walk, decode, hash on the device, group."""

"""The benchmark's own tests: `python -m pytest phbench/tests` from the
root of a checkout.  Those marked `cuda` need a card and skip without
one; the rest run the cells at a tiny size with the port pinned to the
CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs a cell of the benchmark)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)

"""The PyTorch port imports no jax and needs neither triton nor nvcc to
import or to run its plain (CPU) path."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "rupphash_tpu_torch",
    "rupphash_tpu_torch.device",
    "rupphash_tpu_torch.cli",
    "rupphash_tpu_torch.ops._build",
    "rupphash_tpu_torch.ops.pdq_torch",
    "rupphash_tpu_torch.ops.pdq_cuda",
    "rupphash_tpu_torch.ops.hamming",
    "rupphash_tpu_torch.ops.hamming_cuda",
    "rupphash_tpu_torch.grouping.engine",
    "rupphash_tpu_torch.pipeline.scan",
]

_CHILD = """
import importlib, sys
import numpy as np
for m in {mods!r}:
    importlib.import_module(m)
from rupphash_tpu_torch.ops import _build, hamming, pdq_torch
rng = np.random.default_rng(0)
out = pdq_torch.pdq_hash_batch(rng.integers(0, 256, (2, 40, 50), dtype=np.uint8))
assert out["dihedral"].shape == (2, 8, 32)
base = rng.integers(0, 256, (20, 32), dtype=np.uint8)
base[3] = base[11]
ei, ej = hamming.find_edges_fast(base)
assert (ei.tolist(), ej.tolist()) == ([3], [11])
assert "jax" not in sys.modules, "jax imported"
assert "triton" not in sys.modules, "triton imported"
assert _build.load.cache_info().currsize == 0, "kernel library loaded on CPU"
print("OK")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(mods=PORT_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT))
                 for p in (ROOT / "rupphash_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [p.name for p in [ROOT / "chip_smoke.py"]
                  if p.exists() and pattern.search(p.read_text())]
    assert offenders == []

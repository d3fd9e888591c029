"""The port's device policy: it runs on the card unless the caller asks
for the CPU.  Each case runs in a fresh process with no card visible
(CUDA_VISIBLE_DEVICES=""), where every entry point must refuse and name
the missing card instead of falling back to the plain CPU versions."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CALLS = {
    "device.get": "from rupphash_tpu_torch import device; device.get()",
    "scan_and_group": "from rupphash_tpu_torch.pipeline import scan; "
                      "scan.scan_and_group([DIR])",
    "scan": "from rupphash_tpu_torch.pipeline import scan; scan.scan([DIR])",
    "NearDupService": "from rupphash_tpu_torch import serve; "
                      "serve.NearDupService(serve.HashIndex())",
    "pdq_hash_batch": "import numpy as np; "
                      "from rupphash_tpu_torch.ops import pdq_torch; "
                      "pdq_torch.pdq_hash_batch(np.zeros((1, 64, 64), "
                      "np.uint8))",
    "find_edges_fast": "import numpy as np; "
                       "from rupphash_tpu_torch.ops import hamming; "
                       "hamming.find_edges_fast(np.zeros((4, 32), np.uint8))",
}

_CHILD = """
import sys
DIR = sys.argv[1]
try:
    {call}
except RuntimeError as e:
    print("RAISED", e)
else:
    print("RAN")
"""


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(2)
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((320, 240), Image.BILINEAR)
    img.save(d / "a.png")
    img.save(d / "a.jpg", quality=95)
    return d


def _env(tmp_path):
    return {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
            "HOME": str(tmp_path), "RUPPHASH_CONFIG_DIR": str(tmp_path / "c"),
            "RUPPHASH_CACHE_DIR": str(tmp_path / "k")}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_library_entry_points_raise_without_a_card(name, photos, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(call=_CALLS[name]), str(photos)],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out.startswith("RAISED no CUDA device visible"), out
    assert "--device cpu" in out


@pytest.mark.parametrize("args", [
    [], ["--serve", "--port", "0"], ["--rehash-only"], ["--show-build-info"],
    ["--use-gui", "--port", "0"], ["--use-tui"], ["--view"],
], ids=["scan", "serve", "rehash-only", "build-info", "use-gui", "use-tui",
        "view"])
def test_cli_exits_non_zero_without_a_card(args, photos, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rupphash_tpu_torch", "--no-cache", *args,
         str(photos)], cwd=ROOT, env=_env(tmp_path), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "no CUDA device visible" in proc.stderr
    assert "Found" not in proc.stdout and "service at" not in proc.stderr
    assert "GUI at" not in proc.stderr


def test_cli_on_the_cpu_when_asked(photos, tmp_path):
    """`--device cpu` prints what `python -m rupphash_tpu --no-cache`
    prints for the same directory."""
    out = {}
    for module, extra in (("rupphash_tpu_torch", ["--device", "cpu"]),
                          ("rupphash_tpu", [])):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--no-cache", *extra, str(photos)],
            cwd=ROOT, env={**_env(tmp_path), "JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[module] = proc.stdout
    assert out["rupphash_tpu_torch"] == out["rupphash_tpu"]
    assert "Found 1 duplicate groups" in out["rupphash_tpu"]

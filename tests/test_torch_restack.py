"""K5's plain version vs the restack the JAX package's Pallas kernel
computes (rupphash_tpu/tools/mosaic_repro.py::build), written in numpy:
build() has no interpret mode and cannot run on the CPU."""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch.ops import restack
from rupphash_tpu_torch.tools import mosaic_repro


def _numpy_restack(x: np.ndarray, width: int, slices: int = 8) -> np.ndarray:
    big = x[0]                                         # (64, slices*width)
    return np.concatenate([big[:, s * width:(s + 1) * width]
                           for s in range(slices)], axis=0)


@pytest.mark.parametrize("width", [128, 256, 288])
def test_plain_restack_matches_numpy(width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((1, 64, 8 * width)).astype(np.float32)
    got = restack.restack(torch.from_numpy(x), width)
    assert got.shape == (8 * 64, width) and got.dtype == torch.float32
    assert got.numpy().tobytes() == _numpy_restack(x, width).tobytes()
    assert restack.restack.launches == 0


def test_restack_rejects_bad_inputs():
    x = torch.zeros((1, 64, 8 * 128))
    with pytest.raises(ValueError):
        restack.restack(x, 100)                        # not a multiple
    with pytest.raises(ValueError):
        restack.restack(x.double(), 128)
    with pytest.raises(ValueError):
        restack.restack(x[0], 128)


def test_mosaic_repro_tool_on_cpu(capsys):
    assert mosaic_repro.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for width in (128, 256, 288):
        assert f"column restack width={width}: OK" in out
    assert "kernels: restack_kernel=0" in out

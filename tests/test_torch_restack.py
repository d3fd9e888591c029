"""K5's plain version vs the restack the JAX package's Pallas kernel
computes (rupphash_tpu/tools/mosaic_repro.py::build), written in numpy:
build() has no interpret mode and cannot run on the CPU.  Also a numpy
model of the index map of the CUDA kernel (csrc/restack.cu), which runs
only on a card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import restack
from rupphash_tpu_torch.tools import mosaic_repro


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    device.pin("cpu")


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


def _kernel_model(x: np.ndarray, width: int, sms: int):
    """K5's copy as csrc/restack.cu indexes it: pieces of 4 floats when
    the width allows (numpy bases are aligned), single floats otherwise;
    blocks of 8 warps, a warp an output row, striding over the rows by
    the grid; a lane takes pieces lane, lane + 32, ... in groups of 4.
    Returns the output and how often each element was written."""
    rows, slices = x.shape[1], x.shape[2] // width
    piece = 4 if width % 4 == 0 else 1
    w = width // piece
    src = x.reshape(-1, piece)
    n_rows = slices * rows
    grid = min(-(-n_rows // 8), sms * 8)
    out = np.full((n_rows * w, piece), np.nan, dtype=np.float32)
    writes = np.zeros(n_rows * w, dtype=np.int64)
    lanes = np.arange(32)
    for block in range(grid):
        for warp in range(8):
            for orow in range(block * 8 + warp, n_rows, grid * 8):
                s, r = divmod(orow, rows)
                for c0 in range(0, w, 32 * 4):
                    for u in range(4):
                        c = c0 + lanes + 32 * u
                        c = c[c < w]
                        out[orow * w + c] = src[(r * slices + s) * w + c]
                        writes[orow * w + c] += 1
    return out.reshape(n_rows, width), writes, piece


@pytest.mark.parametrize("rows", [1, 64, 65])
@pytest.mark.parametrize("width", [1, 3, 128, 130, 256, 288])
def test_kernel_index_map_matches_plain_and_numpy(width, rows):
    """Both paths of the kernel's index map (16-byte pieces at widths that
    are a multiple of 4, single floats at 1, 3 and 130) write every output
    element once, with what the plain version and the numpy restack put
    there; 2 SMs' worth of blocks makes the warps stride over the rows."""
    rng = np.random.default_rng(1000 * rows + width)
    x = rng.standard_normal((1, rows, 8 * width)).astype(np.float32)
    got, writes, piece = _kernel_model(x, width, sms=2)
    assert piece == (4 if width in (128, 256, 288) else 1)
    assert (writes == 1).all()
    want = restack.restack_plain(torch.from_numpy(x), width).numpy()
    assert got.tobytes() == want.tobytes()
    big = x[0]
    assert got.tobytes() == np.concatenate(
        [big[:, s * width:(s + 1) * width] for s in range(8)],
        axis=0).tobytes()


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

"""Column restack probe: K5 at the widths that broke the TPU compiler.

Run on a machine with a CUDA card:

    python -m rupphash_tpu_torch.tools.mosaic_repro [--device cpu]

Counterpart of rupphash_tpu/tools/mosaic_repro.py, whose Pallas kernel
slices a (1, 64, 8*W) block into 8 column blocks and restacks them as
(8*64, W); on the TPU the remote Mosaic compiler aborted for W = 288,
which is not a multiple of 128 lanes.  Here every width must give OK:
the restack kernel K5 (ops/restack.py) is compared bit for bit with
its plain PyTorch version, and any difference or failure exits 1.
Without a card it exits 3 unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import launches_line, pick_device

WIDTHS = (128, 256, 288)
SLICES = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rupphash_tpu_torch.tools.mosaic_repro",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="cpu runs the plain version; default: the card")
    args = ap.parse_args(argv)
    dev = pick_device(args.device, "mosaic_repro")
    if dev is None:
        return 3

    import torch

    from ..ops import restack

    print(f"device={dev}")
    rng = np.random.default_rng(0)
    ok = True
    for width in WIDTHS:
        x = torch.from_numpy(rng.standard_normal((1, 64, SLICES * width))
                             .astype(np.float32)).to(dev)
        try:
            out = restack.restack(x, width)
            want = restack.restack_plain(x, width)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            same = (out.shape == want.shape
                    and torch.equal(out.view(torch.int32),
                                    want.view(torch.int32)))
            got = "OK" if same else "DIFF (differs from the plain version)"
        except Exception as e:
            got = f"FAIL ({type(e).__name__}: {e})"
        print(f"column restack width={width}: {got}  (expected OK)")
        ok &= got == "OK"
    print(launches_line(("restack_kernel",)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Where K6's time goes: the int8 count sweep with parts taken out.

    python -m rupphash_tpu_torch.tools.k6_ablate

Builds csrc/hamming_mma.cu as it is and in variants that each drop one
part of the work, by editing a copy of the source, and times every
build at N=100,000 hashes x 8 variants, sim 40, on one card in turns
(two rounds):

  shipped        the kernel as it is
  always_test    without the warp's vote on a tile's largest dot: every
                 tile runs the predicate over its 16 x 64 pairs
  no_maximum     the per-pair maximum over the variants dropped (the last
                 variant's dots are kept instead)
  no_loads       the query rows' copies into shared memory dropped (the
                 barriers still complete)
  neither        no_maximum and no_loads: MMAs and ldmatrix alone

Only `shipped` and `always_test` compute the sweep; the tool checks
their counts against K3's and prints for the others that they differ.
The difference between two lines is what that part costs where it
cannot hide under the MMAs.  Needs a card and nvcc (exit 3 without a
card).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops import _build

VOTE = "        if (!__any_sync(0xffffffffu, lane_max(best) >= thr)) continue;\n"
MAXIMUM = "best[nt][c] = max(best[nt][c], acc[nt][c]);"
ROW_COPY = "        cp_async16(dst + srow * kPitch + c * 16, pm1 + grow * KB + c * 16);\n"
LOW_COPY = ("        cp_async16(dst + kStageRows * kPitch + threadIdx.x * 16, "
            "low + q + threadIdx.x * 4);\n")


def _without(src: str, *parts: tuple[str, str]) -> str:
    for old, new in parts:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/hamming_mma.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


NO_MAXIMUM = ((MAXIMUM, "best[nt][c] = acc[nt][c];"),)
NO_LOADS = ((ROW_COPY, "        (void)grow;\n"), (LOW_COPY, "        ;\n"))
VARIANTS = {"shipped": (), "always_test": ((VOTE, ""),), "no_maximum": NO_MAXIMUM,
            "no_loads": NO_LOADS, "neither": NO_MAXIMUM + NO_LOADS}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..ops import hamming, hamming_cuda

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device visible to PyTorch: k6_ablate times "
              "kernels on the card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "hamming_mma.cu").read_text()
    libs = {}
    with tempfile.TemporaryDirectory(prefix="k6_ablate_") as tmp:
        procs = {}
        for name, parts in VARIANTS.items():
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(_without(source, *parts))
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            err = proc.communicate()[1]
            if proc.returncode:
                print(f"FAIL: nvcc on variant {name}:\n{err}", file=sys.stderr)
                return 1
            fn = ctypes.CDLL(str(Path(tmp) / f"{name}.so")).rupp_hamming_rowcount_mma
            fn.argtypes = _build._SIGNATURES["rupp_hamming_rowcount_mma"]
            fn.restype = ctypes.c_int
            libs[name] = fn

    n = 100_000
    rng = np.random.default_rng(20261016)
    base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    pairs = rng.integers(0, n, (2000, 2))
    base[pairs[:, 1]] = base[pairs[:, 0]]
    var[:, 0] = base
    var_bits, low, _, npad = hamming_cuda.prepare_inputs_device(
        base, var, np.zeros(n, dtype=bool))
    pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    want = hamming_cuda.scan_row_counts(var_bits, low, sim=40, n_total=n)
    items = torch.from_numpy(hamming_cuda.pm1_sweep_items(n, npad)).to(dev)
    stream = _build.stream_ptr(pm1)

    def run(fn):
        counts = torch.zeros((npad, 1), dtype=torch.int32, device=dev)
        next_item = torch.zeros(1, dtype=torch.int32, device=dev)
        _build.check(fn(pm1.data_ptr(), low.data_ptr(), items.data_ptr(),
                        len(items), next_item.data_ptr(), 8, 256, npad, n, 40,
                        counts.data_ptr(), stream), "variant")
        return counts

    ok = True
    for rnd in range(2):
        for name, fn in libs.items():
            equal = torch.equal(run(fn), want)
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(5):
                run(fn)
            t1.record()
            torch.cuda.synchronize()
            print(f"round {rnd} {name}: {t0.elapsed_time(t1) / 5:.3f} ms, counts "
                  f"{'equal to' if equal else 'differ from'} K3's")
            ok &= equal or name not in ("shipped", "always_test")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

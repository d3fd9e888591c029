"""Time the main path's kernels of two checkouts on one card, in turns.

    python -m rupphash_tpu_torch.tools.kernel_ab OTHER_CHECKOUT

Runs the same measurement in a fresh process of each checkout, in the
order other, this, this, other, so that the two versions share the card
and its power limit: K1 (`pdq_cuda.pdq_hash`) at B=256 for 288x512,
240x320 and 512x288 (rows x columns) textured lumas; K2 on the 288x512
batch, the kernel alone (`pdq_hybrid.pdq_coeffs`) and the hybrid entry
(`pdq_hybrid.pdq_hash_batch_hybrid`); K3 (`hamming_cuda.scan_row_counts`)
at N=100,000 hashes x 8 variants, sim 40; K4
(`hamming_cuda.extract_rows_packed`) over that input's hot rows, padded
as the edge search pads them; K6 (`hamming_cuda.scan_row_counts_pm1`) on
the same hashes as +/-1 int8; and K5 (`restack.restack`) at (1, 64,
8 * 288) and (1, 8192, 8 * 288) float32, as device time a launch (the
kernels' durations under torch.profiler, or a CUDA graph's replay where
the profiler records nothing; a call of the small size is shorter on
the device than the host takes to make it).  Each process
builds its own checkout's kernels and draws the same inputs from one
seed; a digest of the outputs shows that the two
versions computed the same thing.  Prints one JSON line per run and a
summary line of the mean times.  Needs a card (exit 3 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_CHILD = r"""
import hashlib, json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from rupphash_tpu_torch.ops import (hamming, hamming_cuda, pdq_cuda, pdq_hybrid,
                                    pdq_torch, restack)

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    if us > 0:
        return us / reps / 1e3
    # the profiler's tracing is not open to every process: replay the
    # launches from a CUDA graph, which adds the gap between two nodes
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
    return ms(graph.replay, 10) / 20


out = {}
rng = np.random.default_rng(20261016)
d16 = torch.from_numpy(pdq_torch.dct16x64()).to(dev)
for rows, cols in ((288, 512), (240, 320), (512, 288)):
    small = torch.from_numpy(rng.integers(0, 256, (256, 1, 24, 32))
                             .astype(np.float32)).to(dev)
    lumas = torch.nn.functional.interpolate(
        small, size=(rows, cols), mode="bilinear", align_corners=False
    ).round().clamp(0, 255).to(torch.uint8)[:, 0].contiguous()
    l_op, r_op = pdq_torch.linear_operators(rows, cols)
    args = (lumas, torch.from_numpy(l_op)[None].to(dev),
            torch.from_numpy(r_op)[None].to(dev),
            torch.zeros(256, dtype=torch.int32, device=dev), d16)
    res = pdq_cuda.pdq_hash(*args)
    digest = hashlib.sha256(res["dihedral"].cpu().numpy().tobytes()
                            + res["quality"].cpu().numpy().tobytes())
    out[f"k1_{rows}x{cols}"] = {"ms": ms(lambda: pdq_cuda.pdq_hash(*args), 50),
                                "digest": digest.hexdigest()[:16]}
    if (rows, cols) == (288, 512):
        ops = pdq_hybrid.operators(rows, cols, dev)
        hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
        digest = hashlib.sha256(hyb["dihedral"].cpu().numpy().tobytes()
                                + hyb["quality"].cpu().numpy().tobytes())
        quality = pdq_hybrid.pdq_coeffs(lumas, *ops)[1].cpu().numpy()
        out["k2_kernel_288x512"] = {
            "ms": ms(lambda: pdq_hybrid.pdq_coeffs(lumas, *ops), 50),
            "digest": hashlib.sha256(quality.tobytes()).hexdigest()[:16]}
        out["k2_entry_288x512"] = {
            "ms": ms(lambda: pdq_hybrid.pdq_hash_batch_hybrid(lumas), 20),
            "digest": digest.hexdigest()[:16]}
n = 100_000
base = rng.integers(0, 256, (n, 32), dtype=np.uint8)
var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
pairs = rng.integers(0, n, (2000, 2))
base[pairs[:, 1]] = base[pairs[:, 0]]
var[:, 0] = base
low = np.zeros(n, dtype=bool)
var_bits, low_d, _, _ = hamming_cuda.prepare_inputs_device(base, var, low)
counts = hamming_cuda.scan_row_counts(var_bits, low_d, sim=40, n_total=n)
out["k3_100k"] = {"ms": ms(lambda: hamming_cuda.scan_row_counts(
    var_bits, low_d, sim=40, n_total=n), 5),
    "digest": hashlib.sha256(counts.cpu().numpy().tobytes()).hexdigest()[:16]}
hot = torch.nonzero(counts[:n, 0])[:, 0]
mq = -(-len(hot) // 32) * 32
ridx = torch.full((mq,), n - 1, dtype=torch.int64, device=dev)
qidx = torch.full((mq, 1), n, dtype=torch.int32, device=dev)
qlow = torch.ones((mq, 1), dtype=torch.int32, device=dev)
ridx[:len(hot)] = hot
qidx[:len(hot), 0] = hot.to(torch.int32)
qlow[:len(hot)] = low_d[hot]
k4 = (var_bits.index_select(1, ridx), var_bits[0], qlow, low_d, qidx)
mask = hamming_cuda.extract_rows_packed(*k4, sim=40, n_total=n)
out[f"k4_{len(hot)}_rows_100k"] = {
    "ms": ms(lambda: hamming_cuda.extract_rows_packed(*k4, sim=40, n_total=n),
             10),
    "digest": hashlib.sha256(mask.cpu().numpy().tobytes()).hexdigest()[:16]}
del mask, k4
pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
c6 = hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=40, n_total=n)
out["k6_100k"] = {"ms": ms(lambda: hamming_cuda.scan_row_counts_pm1(
    pm1, low_d, sim=40, n_total=n), 5),
    "digest": hashlib.sha256(c6.cpu().numpy().tobytes()).hexdigest()[:16]}
del pm1, var_bits
for rows, reps in ((64, 200), (8192, 20)):
    x = torch.from_numpy(rng.standard_normal((1, rows, 8 * 288))
                         .astype(np.float32)).to(dev)
    y = restack.restack(x, 288)
    out[f"k5_{rows}x288_device"] = {
        "ms": device_ms(lambda: restack.restack(x, 288), reps),
        "digest": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]}
print(json.dumps(out))
"""


def _run(checkout: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(checkout)}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rupphash_tpu_torch.tools.kernel_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout of the repo")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device visible to PyTorch: kernel_ab times "
              "kernels on the card", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        res = _run(args.other.resolve() if who == "other" else ROOT)
        runs[who].append(res)
        print(json.dumps({"checkout": who, **res}), flush=True)
    summary = {}
    for key in runs["this"][0]:
        this = [r[key]["ms"] for r in runs["this"]]
        other = [r[key]["ms"] for r in runs["other"]]
        same = len({r[key]["digest"] for r in runs["this"] + runs["other"]})
        summary[key] = {"this_ms": sum(this) / 2, "other_ms": sum(other) / 2,
                        "same_output": same == 1}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

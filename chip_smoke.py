#!/usr/bin/env python3
"""Smoke test of rupphash_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in the order they run, each printing its own lines; any
failure exits non-zero:
  1. environment: torch/CUDA versions, card name and power limit,
     float32 precision flags, Pillow/cryptography availability;
  2. build of the CUDA kernels from rupphash_tpu_torch/csrc;
  3. K1 (PDQ hash) against its plain PyTorch version (dihedral and
     quality bit-identical) and the numpy golden, at B=256 for 512x288,
     320x240 and a batch of 8 mixed shapes, with its bound and share;
  4. K2 (hybrid PDQ hasher) against its plain version, its fused
     dihedral hashes against dihedral_from_coeffs of its own coefficients,
     against K1's and the numpy golden, on phase 3's batches, a B=256
     batch of 512 rows x 288 columns (the self-test's shape) and batches
     of 1 and 257; the hybrid entry timed with the epilogue in the kernel
     and with the PyTorch epilogue after the coefficients;
  5. K3 (count sweep) and K4 (hot-row extraction) against their plain
     versions at N=100,000 hashes with planted clusters (sim 31 and 40);
     K4 also on one padded tile of 32 rows, on a chunk of late rows (the
     tiles under the diagonal are skipped), on low-confidence hot rows,
     and at N=3,000 for both hash widths and variant counts; the edge
     search's wall split into K3, K4, compaction and host assembly; and
     the edge search against the brute-force oracle at N=4,096;
  6. K6 (int8 tensor-core count sweep) against K3 and its plain
     version on phase 5's N=100,000 hashes, K6 ms beside K3 ms, and at
     N=3,000 for both hash widths and variant counts; then K3
     against K6 at N=1,000,000 x 8 variants, sim 40, K4's launches over
     that input's hot rows, and the edge search there, its wall split by
     stage, against a host oracle on a sample of rows;
 6a. mesh: parallel/sharded.py on virtual meshes of the one card, [card]
     (1 x 1) and [card] * 4 (2 x 2): the cells' K3 counts at N=1M x 8
     variants, sim 40 (phase 6's input) bit-identical to one K3 launch,
     one launch per cell that holds pairs; sharded_find_edges at
     N=100,000 and 1M equal to find_edges_fast_resident, hot rows
     included, K4 launched; sharded_pdq_hasher at B=256, 288x512
     bit-identical to K1 unsharded; full_dedup_step; wall times (one
     card's: the cells share it, so these are no multi-GPU scaling);
  7. K5 (column restack) against its plain version, bit for bit, at
     W = 128, 256, 288 and at (1, 8192, 8 * 288), 75.5 MB each way,
     beside one PyTorch permute-and-copy: device time a launch (kernel
     durations under torch.profiler, and a CUDA graph's replay, which
     stands in where the profiler records nothing) next to the time of
     a Python call, which at the tool's size is the host's;
  8. demosaic: the port's RAW pipeline (plain PyTorch, no kernel) on
     the card against the CPU at 24 MP, RGGB with a colour matrix and
     X-Trans: at most 1 u8 level apart on at most 1e-4 of the values;
  9. end to end: `python -m rupphash_tpu_torch --no-cache DIR` on a
     generated directory of textured images with 60 planted duplicate
     groups and 20 preview-less DNGs with PNG twins (80 groups); checks
     the printed groups and that every kernel launched;
 9m. mesh groups: phase 9's tree scanned in a new process whose device
     list is a 2 x 2 virtual mesh of the card: the engine takes the
     multi-device route (sharded_find_edges over make_mesh()) and
     sharded_group_files on the scan's records, both with the CLI's
     groups;
 9a. gui: `--use-gui` on phase 9's tree with a cache of its own (the
     scan in the GUI's worker thread while the server answers): the
     groups equal the CLI's, K1, K3 and K4 launched; /api/image and
     /api/analysis from 4 threads at once for a JPEG and three
     preview-less DNGs, each DNG within the demosaic's bound of the
     port's CPU rendition; a mark and a move through /api/intent; quit
     with exit 0; then a restart on the same tree and cache: the same
     groups less the moved file, K1 0 (every hash cached), K3 and K4
     again; the GUI's host-clock latencies;
 9b. tui: `--use-tui` through a pseudo-terminal on 300 files with two
     planted pairs: the list draws, the sort menu opens and closes, z
     quits with exit 0, K1, K3 and K4 launched; then `--view --use-gui`
     on the same directory lists its files and quits with exit 0;
 9c. multihost: two processes on the one card under gloo (NCCL refuses
     two ranks on one GPU), each hashing its shard_files share of 32
     images with K1; allgather_hashes reassembles the unequal shards,
     and the planted twin pair split across the ranks is the only pair;
 10. serve: NearDupService in process over a 1,000,000-row index
     (planted near copies at distances 0-40, low-quality rows,
     tombstones), ~200 images added through /v1/add, ~200 /v1/query
     bodies (JPEG re-encodes, rotations, unrelated, nearly flat and two
     preview-less DNGs) sent serially and from 8 concurrent clients;
     every answer equal to a host numpy oracle, K1 launched once per
     hash, uploads O(delta); latency, query and K1 times, peak memory;
     then NearDupService(mesh=...) with the index sharded over a 2 x 2
     virtual mesh: a /v1/add and a /v1/remove after its first push
     (uploads O(delta)) and ~50 queries, each answer equal to the
     one-device query and the host oracle;
 11. serve CLI: `python -m rupphash_tpu_torch --serve DIR --port 0
     --index-file F` on 300 images (10 preview-less DNGs): queried,
     added to, stopped with SIGINT; exit 0, F reloads, K1 launched;
 12. tools: the self-test, mosaic_repro and prof_nz, each as its own
     process, must exit 0; their launch counts show that the self-test
     ran K2, mosaic_repro K5 and prof_nz K6 (which holds K6 against K3
     and its plain version at N=200,000); then phash_test IMG --pdq and
     position_test on a JPEG with a GPS position, each its own process,
     exit 0.
Then one JSON line with each kernel's numbers (its time, its plain
version's, its bound on this card from the run's own shapes and what
sets it, its share of that bound, and the time of one PyTorch call that
computes the same function where there is one), and the device JSON as
the last line.  Every kernel-vs-plain timing runs plain, kernel, kernel,
plain on the same inputs and reports the mean of the two of each.  The
launch counts in the JSON line come from the runs of phase 9 (K1, K3,
K4) and phase 12 (K2, K5, K6), each a new process whose counts start at
0; phases 9a, 9b, 9m and 9c read their own children's counts the same
way, and phases 6a and 10 (one device and mesh) set the counts they
check to 0 before they drive their path and read them after.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def textured_lumas(gen, b, rows, cols, dev):
    """Random 24x32 planes upscaled bilinear to u8 (rows, cols) on dev."""
    import torch

    small = torch.randint(0, 256, (b, 1, 24, 32), generator=gen).float()
    big = torch.nn.functional.interpolate(small.to(dev), size=(rows, cols),
                                          mode="bilinear", align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8)[:, 0]


# Published peaks of one H100 SXM at 700 W (dense): float32 outside the
# tensor cores, bf16 and int8 on them, HBM bandwidth.
FP32_FLOPS, BF16_FLOPS, INT8_OPS, HBM_BYTES = 67e12, 989e12, 1979e12, 3.35e12


def bound(ops_s: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations'
    time at their peak rate(s) and the bytes moved once over HBM."""
    bytes_s = nbytes / HBM_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def with_share(res: dict) -> dict:
    res["share"] = res["bound_ms"] / res["ms"]
    res.setdefault("library_ms", None)
    return res


def k1_bound(shapes, planes_shape, n_ops) -> dict:
    """K1 on images of true (rows, cols) `shapes`, read as u8 planes
    padded to planes_shape (B, Hp, Wp), with n_ops (S) operator pairs:
    X.R^T, L.XR and the two D16 products in fp32 FMA."""
    b, hp, wp = planes_shape
    flop = sum(2 * (64 * r * c + 64 * 64 * r + 16 * 64 * 64 + 16 * 16 * 64)
               for r, c in shapes)
    nbytes = (b * hp * wp + 4 * n_ops * 64 * (hp + wp) + 4 * 16 * 64
              + b * (8 * 32 + 4 + 4 * 256))
    return bound(flop / FP32_FLOPS, nbytes)


def sweep_bound(n, v, nbits, in_bytes) -> dict:
    """K3/K6: every pair j > i < n, all v variants, a +/-1 dot of nbits
    (2 * nbits int8 operations); the hashes read once, counts written."""
    return bound(n * (n - 1) / 2 * v * 2 * nbits / INT8_OPS,
                 in_bytes + 8 * n)


# --------------------------------------------------------------------------

def phase_env():
    import torch

    from rupphash_tpu_torch import device

    dev = device.get()
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(dev)} "
          f"count {torch.cuda.device_count()}")
    phase("env", f"card: {card_line()}")
    flags = device.precision_flags()
    check(not flags["cuda.matmul.allow_tf32"] and not flags["cudnn.allow_tf32"]
          and flags["float32_matmul_precision"] == "highest",
          f"precision flags not set: {flags}")
    phase("env", f"precision {json.dumps(flags)}")
    found = {}
    for mod in ("PIL", "cryptography"):
        try:
            __import__(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    phase("env", f"imports {json.dumps(found)}")
    check(found["PIL"], "Pillow is missing: the end-to-end phase cannot "
          "decode its corpus")
    return dev


def phase_build():
    from rupphash_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load()
    phase("build", f"{lib.path.name} nvcc {lib.build_seconds:.2f} s, "
          f"load total {time.perf_counter() - t0:.2f} s")


def phase_k1(dev):
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import pdq_cuda, pdq_torch

    golden = pdq_torch.pdq_ref   # the numpy PDQ golden the operators come from
    gen = torch.Generator().manual_seed(SEED)
    d16 = torch.from_numpy(pdq_torch.dct16x64()).to(dev)
    result = {"max_abs_err": 0.0}

    def compare(label, args, lumas_np, reps):
        k = pdq_cuda.pdq_hash(*args)
        p = pdq_cuda.pdq_hash_plain(*args)
        torch.cuda.synchronize()
        b = args[0].shape[0]
        bad = int((k["dihedral"] != p["dihedral"]).flatten(1).any(1).sum())
        dq = float((k["quality"] - p["quality"]).abs().max())
        dc = float((k["coeffs"] - p["coeffs"]).abs().max())
        check(bad == 0, f"K1 {label}: {bad}/{b} images' dihedral hashes "
              "differ from the plain version")
        check(torch.equal(k["quality"].view(torch.int32),
                          p["quality"].view(torch.int32)),
              f"K1 {label}: quality not bit-identical (max diff {dq})")
        check(torch.allclose(k["coeffs"], p["coeffs"], rtol=1e-4, atol=0.5),
              f"K1 {label}: coeffs differ by {dc}")
        result["max_abs_err"] = max(result["max_abs_err"], dc)
        dih = k["dihedral"].cpu().numpy()
        qual = k["quality"].cpu().numpy()
        for i in range(16):
            coeffs, _, quality = golden.pdq_from_luma(lumas_np[i])
            want = golden.dihedral_hashes(coeffs)
            check([bytes(dih[i, v]) for v in range(8)] == want,
                  f"K1 {label}: image {i} differs from the golden")
            check(abs(float(qual[i]) - quality) < 1e-6,
                  f"K1 {label}: image {i} quality {qual[i]} vs {quality}")
        ms, plain_ms = paired_ms(lambda: pdq_cuda.pdq_hash(*args),
                                 lambda: pdq_cuda.pdq_hash_plain(*args), reps)
        shapes = [tuple(x.shape) for x in lumas_np]
        bnd = k1_bound(shapes, tuple(args[0].shape), args[1].shape[0])
        phase("k1", f"{label} B={b}: dihedral and quality bit-identical to "
              f"plain, 16/16 identical to the golden; max |dcoeff| {dc}; "
              f"kernel {ms:.4f} ms ({b / ms * 1e3:.0f} img/s), plain "
              f"{plain_ms:.4f} ms ({b / plain_ms * 1e3:.0f} img/s), "
              f"plain/kernel {plain_ms / ms:.2f}; bound {bnd['bound_ms']:.4f} "
              f"ms ({bnd['bound_by']}), share {bnd['bound_ms'] / ms:.3f}")
        return ms, plain_ms, bnd

    batches = []
    for rows, cols in ((288, 512), (240, 320)):
        lumas = textured_lumas(gen, 256, rows, cols, dev)
        batches.append(lumas)
        l_op, r_op = pdq_torch.linear_operators(rows, cols)
        # shape_idx on the host, as the scan passes it (pdq_torch._run)
        args = (lumas, torch.from_numpy(l_op)[None].to(dev),
                torch.from_numpy(r_op)[None].to(dev),
                torch.zeros(256, dtype=torch.int32), d16)
        ms, plain_ms, bnd = compare(f"{cols}x{rows}", args,
                                    lumas.cpu().numpy(), 20)
        if rows == 288:
            result.update(ms=ms, plain_ms=plain_ms, **bnd)

    shapes = [(288, 512), (240, 320), (512, 288), (200, 300), (333, 250),
              (64, 500), (480, 360), (97, 131)]
    mixed = [textured_lumas(gen, 1, *shapes[k % len(shapes)], "cpu")[0].numpy()
             for k in range(256)]
    planes, l_u, r_u, idx = pdq_torch.pad_mixed(mixed)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (planes, l_u, r_u)) + (torch.from_numpy(idx), d16)
    compare(f"mixed {len(shapes)} shapes padded to "
            f"{planes.shape[2]}x{planes.shape[1]}", args, mixed, 20)
    got = pdq_torch.pdq_hash_batch_mixed(mixed[:16])
    for i in range(16):
        single = pdq_torch.pdq_hash_batch(mixed[i][None])
        check(torch.equal(got["dihedral"][i], single["dihedral"][0]),
              f"K1 mixed batch image {i} differs from its per-shape batch")
    phase("k1", "mixed-shape batch bit-identical to per-shape batches")
    return result, batches


def planted_hashes(n, clusters, seed):
    """Random 256-bit hashes with 8 random variants each (slot 0 = the
    hash), planted with exact copies, near copies (1-31 and 32-40 bit
    flips), dihedral twins and low-quality rows (an exact low pair and a
    near low row that must not pair)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    var = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    rows = rng.permutation(n)[:3 * clusters].reshape(clusters, 3)

    def flipped(h, nbits):
        o = h.copy()
        for p in rng.choice(256, nbits, replace=False):
            o[p // 8] ^= np.uint8(1 << (p % 8))
        return o

    for c, (i, j, k) in enumerate(rows):
        kind = c % 5
        if kind == 0:
            var[j, 0] = var[i, 0]
        elif kind == 1:
            var[j, 0] = flipped(var[i, 0], int(rng.integers(1, 32)))
        elif kind == 2:
            var[j, 0] = flipped(var[i, 0], int(rng.integers(32, 41)))
        elif kind == 3:
            var[j, 0] = var[i, int(rng.integers(1, 8))]
        else:
            var[j, 0] = var[i, 0]
            var[k, 0] = flipped(var[i, 0], 2)
            low[[i, j, k]] = True
    return np.ascontiguousarray(var[:, 0]), var, low


def small_planted(n, v, nbytes, seed):
    """Random hashes of nbytes with v variants (slot 0 = the hash) and
    planted exact, near and variant pairs, some of them low quality."""
    import numpy as np

    rng = np.random.default_rng(seed)
    var = rng.integers(0, 256, (n, v, nbytes), dtype=np.uint8)
    low = np.zeros(n, dtype=bool)
    for c, (i, j) in enumerate(rng.integers(0, n, (n // 40, 2))):
        var[j, 0] = var[i, c % v]
        if c % 3 == 1:
            var[j, 0, c % nbytes] ^= np.uint8(3)
        if c % 11 == 5:
            low[[i, j]] = True
    return np.ascontiguousarray(var[:, 0]), var, low


def hot_row_inputs(var_bits, low_d, rows, n, pad_to=None):
    """K4's operands for hot rows `rows` (a device index tensor), padded
    as the edge search pads them: slots past the rows point at row n - 1
    with qidx = n and the low flag set, which keeps them inert."""
    import torch

    dev = var_bits.device
    m = len(rows)
    mq = pad_to or -(-m // 32) * 32
    ridx = torch.full((mq,), n - 1, dtype=torch.int64, device=dev)
    qidx = torch.full((mq, 1), n, dtype=torch.int32, device=dev)
    qlow = torch.ones((mq, 1), dtype=torch.int32, device=dev)
    ridx[:m] = rows
    qidx[:m, 0] = rows.to(torch.int32)
    qlow[:m] = low_d[rows]
    return var_bits.index_select(1, ridx), var_bits[0], qlow, low_d, qidx


def k4_against_plain(label, var_bits, low_d, rows, n, sim, pad_to=None):
    """K4's masks for hot rows `rows` and their pad slots against the
    plain version's, byte for byte; returns the number of match bits."""
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import hamming_cuda

    args = hot_row_inputs(var_bits, low_d, rows, n, pad_to)
    km = hamming_cuda.extract_rows_packed(*args, sim=sim, n_total=n)
    pm = hamming_cuda.extract_rows_packed_plain(*args, sim=sim, n_total=n)
    torch.cuda.synchronize()
    check(torch.equal(km, pm), f"K4 {label}: masks differ from the plain "
          "version's")
    check(int(km[len(rows):].sum()) == 0, f"K4 {label}: a pad slot has a "
          "match")
    return int(np.unpackbits(km.cpu().numpy()).sum())


def spanned(call):
    """call() with the port's spans recorded (utils/trace.recording()):
    (its result, the host ms of the spans it recorded, by name)."""
    from rupphash_tpu_torch.utils import trace

    with trace.recording() as rec:
        out = call()
    return out, stage_split(rec)


def stage_split(spans) -> str:
    by: dict = {}
    for s in spans:
        by[s.name] = by.get(s.name, 0) + s.duration_ns
    return ", ".join(f"{k} {v / 1e6:.1f} ms" for k, v in by.items())


def phase_hamming(dev):
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import hamming, hamming_cuda

    res = {"k3": {"max_abs_err": 0.0}, "k4": {"max_abs_err": 0.0}}
    n = 100_000
    base, var, low = planted_hashes(n, 2000, SEED)
    var_bits, low_d, _, npad = hamming_cuda.prepare_inputs_device(base, var,
                                                                  low)
    for sim in (31, 40):
        kc = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
        pc = hamming_cuda.scan_row_counts_plain(var_bits, low_d, sim=sim,
                                                n_total=n)
        torch.cuda.synchronize()
        err3 = int((kc - pc).abs().max())
        check(err3 == 0, f"K3 sim {sim}: counts differ by up to {err3}")

        (ei, ej), split = spanned(lambda: hamming.find_edges_fast(
            base, var, low, similarity=sim))
        # the plain flow over the same hot rows: plain K3 counts, plain K4
        hot = torch.nonzero(pc[:n, 0])[:, 0]
        m = len(hot)
        ridx = hot.to(dev)
        qidx = hot.to(torch.int32)[:, None]
        qlow = low_d[hot]
        q_bits = var_bits.index_select(1, ridx)
        km = hamming_cuda.extract_rows_packed(q_bits, var_bits[0], qlow, low_d,
                                              qidx, sim=sim, n_total=n)
        pm = hamming_cuda.extract_rows_packed_plain(
            q_bits, var_bits[0], qlow, low_d, qidx, sim=sim, n_total=n)
        torch.cuda.synchronize()
        err4 = int((km.int() - pm.int()).abs().max()) if m else 0
        check(err4 == 0, f"K4 sim {sim}: masks differ")
        res["k3"]["max_abs_err"] = max(res["k3"]["max_abs_err"], err3)
        res["k4"]["max_abs_err"] = max(res["k4"]["max_abs_err"], err4)
        rr, cc = np.nonzero(np.unpackbits(pm.cpu().numpy(), axis=1,
                                          bitorder="little"))
        plain_edges = set(zip(hot.cpu().numpy()[rr].tolist(), cc.tolist()))
        kernel_edges = set(zip(ei.tolist(), ej.tolist()))
        check(kernel_edges == plain_edges,
              f"sim {sim}: kernel edge set ({len(kernel_edges)}) differs from "
              f"the plain one ({len(plain_edges)})")
        check(len(ei) == int(pc.sum()), f"sim {sim}: edges vs counts")
        k3_ms, k3_plain = paired_ms(
            lambda: hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim,
                                                 n_total=n),
            lambda: hamming_cuda.scan_row_counts_plain(var_bits, low_d,
                                                       sim=sim, n_total=n), 2)
        k4_ms, k4_plain = paired_ms(
            lambda: hamming_cuda.extract_rows_packed(
                q_bits, var_bits[0], qlow, low_d, qidx, sim=sim, n_total=n),
            lambda: hamming_cuda.extract_rows_packed_plain(
                q_bits, var_bits[0], qlow, low_d, qidx, sim=sim, n_total=n), 5)
        phase("k3k4", f"N={n} sim={sim}: counts identical, masks identical, "
              f"edge sets identical ({len(ei)} edges, {m} hot rows); K3 "
              f"{k3_ms:.3f} ms vs plain {k3_plain:.3f} ms; K4 ({m} rows) "
              f"{k4_ms:.3f} ms vs plain {k4_plain:.3f} ms")
        k3_bnd = sweep_bound(n, var_bits.shape[0], 256,
                             var_bits.numel() + low_d.numel() * 4)
        # K4: each hot row against every later row, all 8 variants
        hot_np = hot.cpu().numpy()
        k4_bnd = bound(float((n - 1 - hot_np).sum()) * 8 * 2 * 256 / INT8_OPS,
                       var_bits[0].numel() + q_bits.numel() + km.numel()
                       + 4 * (low_d.numel() + 2 * m))
        phase("k3k4", f"N={n} sim={sim}: K3 bound {k3_bnd['bound_ms']:.3f} ms "
              f"({k3_bnd['bound_by']}), share "
              f"{k3_bnd['bound_ms'] / k3_ms:.3f}; K4 bound "
              f"{k4_bnd['bound_ms']:.4f} ms ({k4_bnd['bound_by']}), share "
              f"{k4_bnd['bound_ms'] / k4_ms:.3f}")
        if sim == 40:
            res["k3"].update(ms=k3_ms, plain_ms=k3_plain, **k3_bnd)
            res["k4"].update(ms=k4_ms, plain_ms=k4_plain, **k4_bnd)
            # K4's corners on the same input: one padded tile, late rows
            # (their first base tile is far from tile 0), low-quality rows
            late = hot[hot > n // 2][:200]
            lowq = hot[low_d[hot, 0] != 0][:40]
            check(len(late) > 64 and int(late[0]) > 128 and len(lowq) > 0,
                  "the planted input lacks late or low-quality hot rows")
            bits = [k4_against_plain("one padded tile", var_bits, low_d,
                                     hot[:20], n, sim, pad_to=32),
                    k4_against_plain("late rows", var_bits, low_d, late, n,
                                     sim, pad_to=224),
                    k4_against_plain("low-quality rows", var_bits, low_d,
                                     lowq, n, sim, pad_to=64)]
            phase("k3k4", f"N={n} sim={sim}: K4 masks identical to plain on "
                  f"one tile of 20 rows + 12 pads ({bits[0]} bits), on "
                  f"{len(late)} rows past row {int(late[0])} ({bits[1]} "
                  f"bits) and on {len(lowq)} low-quality rows ({bits[2]} "
                  f"bits); find_edges_fast split: {split}")

    for v, nbytes, sim in ((1, 32, 40), (8, 8, 10), (1, 8, 6)):
        n3 = 3000
        sb, sv, sl = small_planted(n3, v, nbytes, SEED + v + nbytes)
        vb, ld, _, _ = hamming_cuda.prepare_inputs_device(sb, sv, sl)
        kc = hamming_cuda.scan_row_counts(vb, ld, sim=sim, n_total=n3)
        pc = hamming_cuda.scan_row_counts_plain(vb, ld, sim=sim, n_total=n3)
        check(torch.equal(kc, pc), f"K3 V={v} {nbytes * 8} bits: counts "
              "differ from plain")
        hot3 = torch.nonzero(pc[:n3, 0])[:, 0]
        bits = k4_against_plain(f"V={v} {nbytes * 8} bits", vb, ld, hot3, n3,
                                sim)
        check(bits == int(pc.sum()), f"K4 V={v} {nbytes * 8} bits: {bits} "
              f"mask bits for {int(pc.sum())} counted matches")
        phase("k3k4", f"N={n3} V={v} {nbytes * 8} bits sim={sim}: K3 counts "
              f"and K4 masks identical to plain ({len(hot3)} hot rows, "
              f"{bits} matches)")

    small = planted_hashes(4096, 200, SEED + 1)
    for sim in (31, 40):
        got = hamming.find_edges_fast(*small, similarity=sim)
        want = hamming.brute_force_edges(*small, similarity=sim)
        check(set(zip(*(a.tolist() for a in got)))
              == set(zip(*(a.tolist() for a in want))),
              f"N=4096 sim {sim}: edges differ from brute_force_edges")
        phase("k3k4", f"N=4096 sim={sim}: {len(got[0])} edges identical to "
              "brute_force_edges")
    return res, (var_bits, low_d, n)


def phase_k2(dev, batches):
    import torch

    from rupphash_tpu_torch.ops import pdq_cuda, pdq_hybrid, pdq_torch

    golden = pdq_torch.pdq_ref
    result = {"max_abs_err": 0.0}
    # phase k1's batches, 512 rows x 288 columns (the self-test's shape
    # and K2's largest shared-memory setup), and batches of 1 and 257
    gen = torch.Generator().manual_seed(SEED + 2)
    tall = textured_lumas(gen, 256, 512, 288, dev)
    one = textured_lumas(gen, 1, 288, 512, dev)
    odd = textured_lumas(gen, 257, 288, 512, dev)
    for lumas in (*batches, tall, one, odd):
        b, rows, cols = lumas.shape
        label = f"{cols}x{rows}"
        ops = pdq_hybrid.operators(rows, cols, dev)
        before = pdq_hybrid.pdq_coeffs.launches
        hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
        check(pdq_hybrid.pdq_coeffs.launches == before + 1,
              f"K2 {label}: the hybrid entry did not launch K2 once")
        kc, kq = pdq_hybrid.pdq_coeffs(lumas, *ops)
        pc, pq = pdq_hybrid.pdq_coeffs_plain(lumas, *ops)
        own = pdq_torch.dihedral_from_coeffs(hyb["coeffs"].reshape(-1, 16, 16))
        l_op, r_op = pdq_torch.linear_operators(rows, cols)
        k1 = pdq_cuda.pdq_hash(lumas, torch.from_numpy(l_op)[None].to(dev),
                               torch.from_numpy(r_op)[None].to(dev),
                               torch.zeros(b, dtype=torch.int32, device=dev),
                               ops[4])
        torch.cuda.synchronize()
        check(torch.equal(hyb["coeffs"].view(torch.int32),
                          kc.view(torch.int32))
              and torch.equal(hyb["quality"].view(torch.int32),
                              kq.view(torch.int32)),
              f"K2 {label}: coefficients or quality change with the epilogue")
        check(torch.equal(hyb["dihedral"], own), f"K2 {label}: the kernel's "
              "dihedral hashes differ from dihedral_from_coeffs of its own "
              "coefficients")
        dq = float((kq - pq).abs().max())
        dc = float((kc - pc).abs().max())
        check(dq <= 1e-6, f"K2 {label}: quality differs from plain by {dq}")
        check(torch.allclose(kc, pc, rtol=1e-4, atol=0.5),
              f"K2 {label}: coeffs differ from plain by {dc}")
        diff = (hyb["dihedral"] != k1["dihedral"]).flatten(1).any(1)
        bad = [int(i) for i in torch.nonzero(diff)[:, 0].tolist()]
        check(not bad, f"K2 {label}: images {bad[:10]} ({len(bad)}/{b}) "
              "have dihedral hashes that differ from K1's")
        dq1 = float((hyb["quality"] - k1["quality"]).abs().max())
        check(dq1 <= 1e-6, f"K2 {label}: quality differs from K1 by {dq1}")
        dih = hyb["dihedral"].cpu().numpy()
        qual = hyb["quality"].cpu().numpy()
        lumas_np = lumas.cpu().numpy()
        n_gold = min(16, b)
        for i in range(n_gold):
            coeffs, _, quality = golden.pdq_from_luma(lumas_np[i])
            check([bytes(dih[i, v]) for v in range(8)]
                  == golden.dihedral_hashes(coeffs),
                  f"K2 {label}: image {i} differs from the golden")
            check(abs(float(qual[i]) - quality) <= 1e-6,
                  f"K2 {label}: image {i} quality {qual[i]} vs {quality}")
        result["max_abs_err"] = max(result["max_abs_err"], dc)
        if b != 256:
            phase("k2", f"{label} B={b}: fused dihedral identical to "
                  f"dihedral_from_coeffs of its own coefficients and to K1, "
                  f"{n_gold}/{n_gold} identical to the golden; vs plain max "
                  f"|dquality| {dq} max |dcoeff| {dc}")
            continue

        def unfused():   # the earlier path: coefficients, then PyTorch's epilogue
            c, _ = pdq_hybrid.pdq_coeffs(lumas, *ops)
            return pdq_torch.dihedral_from_coeffs(c.reshape(-1, 16, 16))

        ms, plain_ms = paired_ms(
            lambda: pdq_hybrid.pdq_hash_batch_hybrid(lumas),
            lambda: pdq_hybrid.pdq_hash_batch_hybrid_plain(lumas), 20)
        front_ms = cuda_ms(lambda: pdq_hybrid.pdq_coeffs(lumas, *ops), 20)
        unfused_ms = cuda_ms(unfused, 20)
        phase("k2", f"{label} B={b}: fused dihedral identical to "
              f"dihedral_from_coeffs of its own coefficients and to K1, 16/16 "
              f"identical to the golden; vs plain max |dquality| {dq} max "
              f"|dcoeff| {dc}; hybrid entry, one launch with the epilogue in "
              f"the kernel {ms:.4f} ms ({b / ms * 1e3:.0f} img/s), plain "
              f"{plain_ms:.4f} ms, plain/kernel {plain_ms / ms:.2f}; "
              f"coefficients and quality only {front_ms:.4f} ms; that plus "
              f"the PyTorch epilogue {unfused_ms:.4f} ms")
        # stage 1 on the bf16 tensor cores (three split terms of L) plus
        # one fp32 add per MMA output (the exact-sum rule), stage 2 and the
        # D16 products in fp32 FMA; the median sorts are not counted
        adds = b * 3 * 64 * cols * rows / 16
        bnd = bound(b * 2 * 3 * 64 * rows * cols / BF16_FLOPS
                    + (b * 2 * (64 * 64 * cols + 16 * 64 * 64 + 16 * 16 * 64)
                       + 2 * adds) / FP32_FLOPS,
                    lumas.numel() + 4 * 64 * (rows + cols)
                    + b * (4 * 257 + 8 * 32))
        phase("k2", f"{label}: bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; {adds:.3g} exact-sum adds counted at "
              f"{FP32_FLOPS / 2:.3g} add/s), share {bnd['bound_ms'] / ms:.3f}")
        if rows == 288:
            result.update(ms=ms, plain_ms=plain_ms, front_ms=front_ms,
                          unfused_ms=unfused_ms, **bnd)
    return result


def phase_k6(inputs):
    import torch

    from rupphash_tpu_torch.ops import hamming, hamming_cuda

    var_bits, low_d, n = inputs
    pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    result = {"max_abs_err": 0}
    for sim in (31, 40):
        k3 = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
        k6 = hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=sim, n_total=n)
        plain = hamming_cuda.scan_row_counts_pm1_plain(pm1, low_d, sim=sim,
                                                       n_total=n)
        torch.cuda.synchronize()
        err = int((k6 - plain).abs().max())
        check(torch.equal(k6, k3), f"K6 sim {sim}: counts differ from K3's")
        check(err == 0, f"K6 sim {sim}: counts differ from plain by {err}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        ms, plain_ms = paired_ms(
            lambda: hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=sim,
                                                     n_total=n),
            lambda: hamming_cuda.scan_row_counts_pm1_plain(
                pm1, low_d, sim=sim, n_total=n), 2)
        k3_ms = cuda_ms(lambda: hamming_cuda.scan_row_counts(
            var_bits, low_d, sim=sim, n_total=n), 3)
        phase("k6", f"N={n} V={var_bits.shape[0]} sim={sim}: counts identical "
              f"to K3 and plain ({int(k6.sum())} matches); K6 {ms:.3f} ms vs "
              f"K3 {k3_ms:.3f} ms vs plain {plain_ms:.3f} ms; K3/K6 "
              f"{k3_ms / ms:.2f}")
        if sim == 40:
            result.update(ms=ms, plain_ms=plain_ms, k3_ms=k3_ms,
                          **sweep_bound(n, pm1.shape[0], 256,
                                        pm1.numel() + 4 * low_d.numel()))
            phase("k6", f"N={n} sim={sim}: bound {result['bound_ms']:.3f} ms "
                  f"({result['bound_by']}), share "
                  f"{result['bound_ms'] / ms:.3f}")
    for v, nbytes, sim in ((1, 32, 40), (8, 8, 10), (1, 8, 6)):
        n3 = 3000
        sb, sv, sl = small_planted(n3, v, nbytes, SEED + v + nbytes)
        vb, ld, _, _ = hamming_cuda.prepare_inputs_device(sb, sv, sl)
        p3 = hamming.unpack_bits_pm1(vb).contiguous()
        before = hamming_cuda.scan_row_counts_pm1.launches
        k6 = hamming_cuda.scan_row_counts_pm1(p3, ld, sim=sim, n_total=n3)
        check(hamming_cuda.scan_row_counts_pm1.launches == before + 1,
              f"K6 V={v} {nbytes * 8} bits: the wrapper did not launch once")
        check(torch.equal(k6, hamming_cuda.scan_row_counts_pm1_plain(
            p3, ld, sim=sim, n_total=n3)) and torch.equal(
                k6, hamming_cuda.scan_row_counts(vb, ld, sim=sim, n_total=n3)),
            f"K6 V={v} {nbytes * 8} bits: counts differ from plain or K3")
        phase("k6", f"N={n3} V={v} {nbytes * 8} bits sim={sim}: counts "
              f"identical to plain and K3 ({int(k6.sum())} matches)")
    return result


def host_oracle_rows(rows, var, base, low, sim):
    """{(i, j)}: for each sampled row i, every j > i within the
    threshold, by XOR + popcount of 64-bit words in numpy."""
    import numpy as np

    b64 = np.ascontiguousarray(base).view(np.uint64)            # (N, 4)
    edges = set()
    for i in rows:
        q = np.ascontiguousarray(var[i]).view(np.uint64)        # (V, 4)
        d = np.full(len(base) - i - 1, 1 << 10, dtype=np.int64)
        for qv in q:
            x = b64[i + 1:] ^ qv[None]
            d = np.minimum(d, popcount(x).sum(1, dtype=np.int64))
        thr = np.where(low[i] | low[i + 1:], 0, sim)
        edges.update((int(i), int(j)) for j in np.nonzero(d <= thr)[0] + i + 1)
    return edges


def phase_k3_1m(dev, n=1_000_000):
    """K3 against K6 at N=1,000,000 x 8 variants, sim 40 (no plain run
    at this size), and find_edges_fast's edges against a host oracle on
    a sample of rows."""
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import hamming, hamming_cuda

    sim = 40
    t0 = time.perf_counter()
    base, var, low = planted_hashes(n, n // 50, SEED + 3)
    var_bits, low_d, _, npad = hamming_cuda.prepare_inputs_device(base, var,
                                                                  low)
    k3 = hamming_cuda.scan_row_counts(var_bits, low_d, sim=sim, n_total=n)
    pm1 = hamming.unpack_bits_pm1(var_bits).contiguous()
    k6 = hamming_cuda.scan_row_counts_pm1(pm1, low_d, sim=sim, n_total=n)
    torch.cuda.synchronize()
    check(torch.equal(k3, k6), "K3 at N=1M: counts differ from K6's")
    k3_ms = cuda_ms(lambda: hamming_cuda.scan_row_counts(
        var_bits, low_d, sim=sim, n_total=n), 2)
    k6_ms = cuda_ms(lambda: hamming_cuda.scan_row_counts_pm1(
        pm1, low_d, sim=sim, n_total=n), 1)
    del pm1
    bnd = sweep_bound(n, 8, 256, var_bits.numel() + 4 * low_d.numel())
    # K4 over this input's hot rows, chunked as the edge search chunks them
    hot = torch.nonzero(k3[:n, 0])[:, 0]
    chunk = hamming._default_row_chunk(npad)
    launches = [hot_row_inputs(var_bits, low_d, hot[c0:c0 + chunk], n)
                for c0 in range(0, len(hot), chunk)]

    def k4_all():
        for args in launches:
            hamming_cuda.extract_rows_packed(*args, sim=sim, n_total=n)

    k4_ms = cuda_ms(k4_all, 2)
    hot_np = hot.cpu().numpy()
    k4_bnd = bound(float((n - 1 - hot_np).sum()) * 8 * 2 * 256 / INT8_OPS,
                   len(launches) * var_bits[0].numel()
                   + len(hot) * (8 * 32 + npad // 8))
    del launches
    torch.cuda.empty_cache()
    (ei, ej), split = spanned(lambda: hamming.find_edges_fast(
        base, var, low, similarity=sim))
    check(len(ei) == int(k3.sum()), "N=1M: edges vs K3 counts")
    rng = np.random.default_rng(SEED)
    sample = sorted(set(ei[rng.integers(0, len(ei), 24)].tolist())
                    | set(rng.integers(0, n - 1, 24).tolist()))
    want = host_oracle_rows(sample, var, base, low, sim)
    picked = np.isin(ei, sample)
    got = set(zip(ei[picked].tolist(), ej[picked].tolist()))
    check(got == want, f"N=1M: edges of {len(sample)} sampled rows differ "
          f"from the host oracle ({len(got)} vs {len(want)})")
    phase("k3-1m", f"N={n} V=8 sim={sim}: K3 counts identical to K6 "
          f"({int(k3.sum())} matches); K3 {k3_ms:.3f} ms vs K6 {k6_ms:.3f} ms; "
          f"K3 bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}), share "
          f"{bnd['bound_ms'] / k3_ms:.3f}; K4 {k4_ms:.3f} ms for "
          f"{len(hot)} hot rows in {-(-len(hot) // chunk)} launches of up to "
          f"{chunk} rows (each mask's clear included), bound "
          f"{k4_bnd['bound_ms']:.3f} ms ({k4_bnd['bound_by']}); "
          f"find_edges_fast {len(ei)} edges, split: {split}; "
          f"{len(sample)} sampled rows ({len(want)} edges) equal to the host "
          f"oracle; phase {time.perf_counter() - t0:.1f} s")
    return ({"k3_1m_ms": k3_ms, "k6_1m_ms": k6_ms,
             "k3_1m_bound_ms": bnd["bound_ms"]},
            {"k4_1m_ms": k4_ms, "k4_1m_launches": -(-len(hot) // chunk),
             "k4_1m_bound_ms": k4_bnd["bound_ms"]},
            (base, var, low, k3[:n, 0].cpu().numpy()))


def scan_counts() -> dict:
    """The launch counts of the scan route's kernels in this process."""
    from rupphash_tpu_torch.ops import hamming_cuda, pdq_cuda

    return {"pdq_hash_kernel": pdq_cuda.pdq_hash.launches,
            "hamming_rowcount_kernel": hamming_cuda.scan_row_counts.launches,
            "hamming_extract_kernel": hamming_cuda.extract_rows_packed.launches}


def cells_with_pairs(mesh, n) -> int:
    """The cells of `mesh` whose block holds a pair i < j < n: K3's
    launches for one sweep on it."""
    from rupphash_tpu_torch.ops import hamming_cuda
    from rupphash_tpu_torch.parallel import sharded

    nq, nb = mesh.shape["q"], mesh.shape["b"]
    npad = sharded._mesh_npad(n, nq, nb)
    qs, bs = npad // nq, npad // nb
    return sum(len(hamming_cuda.sweep_items(
        n, npad, (q * qs, (q + 1) * qs, b * bs, (b + 1) * bs))) > 0
        for q, b, _ in mesh.cells())


def phase_mesh(dev, big):
    """The ('q', 'b') mesh of parallel/sharded.py on virtual meshes of the
    one card, [dev] (1 x 1) and [dev] * 4 (2 x 2): K3 per cell at N=1M x 8
    variants, sim 40 (phase 6's input) bit-identical to one K3 launch;
    sharded_find_edges at N=100,000 and 1M equal to
    find_edges_fast_resident (edges and hot rows); the sharded hasher at
    B=256, 288x512 bit-identical to K1 unsharded; full_dedup_step.  The
    launch counts are set to 0 before each run of the path and read after
    it.  Times are one card's: the cells of a virtual mesh share it."""
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import hamming, pdq_torch
    from rupphash_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    sim = 40
    base_1m, var_1m, low_1m, k3_1m = big
    base_100k, var_100k, low_100k = planted_hashes(100_000, 2000, SEED)
    single = {}
    for label, (base, var, low) in (("100k", (base_100k, var_100k, low_100k)),
                                     ("1M", (base_1m, var_1m, low_1m))):
        var_dev = torch.from_numpy(var).to(dev)
        single[label] = spanned(lambda: hamming.find_edges_fast_resident(
            var_dev, low, similarity=sim, return_stats=True))
        del var_dev
    for n_dev in (1, 4):
        mesh = sharded.make_mesh(n_dev, devices=[dev] * n_dev)
        n = len(base_1m)
        inputs = sharded.mesh_inputs(mesh, var_1m, low_1m)
        reset_scan_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = sharded.sharded_row_counts(mesh, sim)(inputs)
        torch.cuda.synchronize()
        rc_s = time.perf_counter() - t0
        got = scan_counts()
        cells = cells_with_pairs(mesh, n)
        check(np.array_equal(counts[:n].cpu().numpy(), k3_1m),
              f"mesh {mesh.shape}: row counts at N=1M differ from one K3 "
              f"launch's")
        check(got["hamming_rowcount_kernel"] == cells,
              f"mesh {mesh.shape}: K3 launched {got} times, {cells} cells "
              f"hold pairs")
        del inputs, counts
        torch.cuda.empty_cache()
        runs = {}
        # host arrays (uploaded to the cells) at 100k and 1M, and at 1M
        # the scan's resident rows as the engine passes them (a tensor on
        # the card, padded there)
        for label, run, (base, var, low) in (
                ("100k", "100k", (base_100k, var_100k, low_100k)),
                ("1M", "1M host", (base_1m, var_1m, low_1m)),
                ("1M", "1M resident", (None, var_1m, low_1m))):
            if base is None:
                var = torch.from_numpy(var).to(dev)
            reset_scan_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (ei, ej, st), split = spanned(lambda: sharded.sharded_find_edges(
                mesh, base, var, low, similarity=sim, return_stats=True))
            wall = time.perf_counter() - t0
            del var
            e_got = scan_counts()
            (si, sj, sst), _ = single[label]
            base = base_100k if label == "100k" else base_1m
            check(np.array_equal(np.sort(ei * len(base) + ej),
                                 np.sort(si * len(base) + sj)),
                  f"mesh {mesh.shape} N={label}: {len(ei)} edges, the "
                  f"one-device search {len(si)}")
            check(st["hot_rows"] == sst["hot_rows"],
                  f"mesh {mesh.shape} N={label}: hot rows {st['hot_rows']} "
                  f"vs {sst['hot_rows']}")
            check(e_got["hamming_extract_kernel"] > 0
                  and e_got["hamming_rowcount_kernel"] == cells_with_pairs(
                      mesh, len(base)),
                  f"mesh {mesh.shape} N={label}: launches {e_got}")
            runs[run] = (len(ei), wall, st, e_got, split)
            torch.cuda.empty_cache()
        e100k, e1m = runs["100k"][0], runs["1M resident"][0]
        st1m, l1m = runs["1M resident"][2:4]
        walls = "; ".join(f"{run} {w * 1e3:.1f} ms ({split})"
                          for run, (_, w, _, _, split) in runs.items())
        phase("mesh", f"{mesh.shape} on {n_dev} x {dev} (virtual): "
              f"sharded_row_counts N={n} V=8 sim={sim} identical to one K3 "
              f"launch, K3 launches {got['hamming_rowcount_kernel']} (= cells "
              f"holding pairs), {rc_s * 1e3:.1f} ms wall; sharded_find_edges "
              f"N=100k {e100k} edges, N=1M {e1m} edges, each run equal to "
              f"find_edges_fast_resident with its hot rows "
              f"({st1m['hot_rows']} at 1M); wall by run: {walls} (the "
              f"one-device resident search at 1M: "
              f"{single['1M'][1]}); readback "
              f"{st1m['readback_bytes']} bytes at 1M, launches at 1M {l1m}; "
              f"card: {card_line()}")

    gen = torch.Generator().manual_seed(SEED + 8)
    lumas = textured_lumas(gen, 256, 288, 512, dev)
    lumas[31] = lumas[17]
    want = pdq_torch.pdq_hash_batch(lumas)
    for n_dev in (1, 4):
        mesh = sharded.make_mesh(n_dev, devices=[dev] * n_dev)
        reset_scan_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sharded.sharded_pdq_hasher(mesh, 288, 512)(lumas)
        torch.cuda.synchronize()
        hash_ms = (time.perf_counter() - t0) * 1e3
        k1 = scan_counts()["pdq_hash_kernel"]
        check(torch.equal(out["dihedral"], want["dihedral"])
              and torch.equal(out["quality"], want["quality"]),
              f"mesh {mesh.shape}: sharded hashes differ from K1 unsharded")
        check(k1 == n_dev, f"mesh {mesh.shape}: K1 launched {k1} times")
        reset_scan_counts()
        hashes, quality, cell = sharded.full_dedup_step(mesh, 288, 512)(lumas)
        step = scan_counts()
        check(torch.equal(hashes, want["hash"]) and int(cell.sum()) >= 1
              and step["pdq_hash_kernel"] == n_dev
              and step["hamming_rowcount_kernel"] > 0,
              f"mesh {mesh.shape}: full_dedup_step {cell.tolist()} {step}")
        phase("mesh", f"{mesh.shape}: sharded_pdq_hasher B=256 288x512 "
              f"bit-identical to K1 unsharded ({k1} K1 launches, "
              f"{hash_ms:.2f} ms wall); full_dedup_step cell counts "
              f"{cell.tolist()}, launches {step}; card: {card_line()}")
    phase("mesh", f"phase {time.perf_counter() - t_phase:.1f} s")


MESH_GROUPS_CHILD = r"""
import json, sys
import torch
from rupphash_tpu_torch import device
from rupphash_tpu_torch.parallel import sharded
from rupphash_tpu_torch.pipeline import scan
dev = device.pin("cuda")
virtual = [dev] * 4
sharded.local_devices = lambda: list(virtual)   # a 2 x 2 mesh of the one card
calls = []
real = sharded.sharded_find_edges
def spy(mesh, *a, **k):
    calls.append(mesh.shape)
    return real(mesh, *a, **k)
sharded.sharded_find_edges = spy
groups, infos, records, stats = scan.scan_and_group([sys.argv[1]],
                                                    scan.ScanConfig())
by_engine = [sorted(f.path.name for f in g) for g in groups]
engine_calls = list(calls)
mesh_groups, _, edges = sharded.sharded_group_files(
    sharded.make_mesh(4, devices=virtual), records)
print(json.dumps({"engine": by_engine, "calls": engine_calls, "edges": edges,
                  "files": [sorted(f.path.name for f in g)
                            for g in mesh_groups],
                  "failed": stats.failed}))
print("[KERNELS] " + scan.kernel_counts(), file=sys.stderr)
"""


def phase_mesh_groups(tmp: Path, cli_groups: list):
    """Phase 9's tree in a new process whose device list is a 2 x 2 mesh of
    the one card: the engine takes the multi-device route
    (sharded_find_edges over make_mesh()), and sharded_group_files on the
    scan's records; both give the CLI's groups."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", MESH_GROUPS_CHILD, str(tmp / "photos")],
        cwd=ROOT, env=child_env(tmp, "mesh"), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"mesh groups child exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = kernel_counts(proc.stderr)
    want = sorted(sorted(g) for g in cli_groups)
    check(out["calls"] == [{"q": 2, "b": 2}],
          f"the engine's search did not take the mesh: {out['calls']}")
    check(sorted(out["engine"]) == want, "the engine's groups on the mesh "
          "differ from the CLI's")
    check(sorted(out["files"]) == want, "sharded_group_files' groups differ "
          "from the CLI's")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the mesh route: {launches}")
    phase("mesh", f"scan of phase 9's tree with a 2 x 2 virtual mesh: the "
          f"engine took sharded_find_edges, {len(want)} groups = the CLI's; "
          f"sharded_group_files on its records: the same groups, "
          f"{out['edges']} edges; launches {launches}; {wall:.1f} s wall "
          f"(a new process, decode included); card: {card_line()}")


MULTIHOST_CHILD = r"""
import datetime, json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
rank, port, corpus = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
from rupphash_tpu_torch import device
from rupphash_tpu_torch.ops import pdq_cuda, pdq_torch
from rupphash_tpu_torch.parallel import multihost
from rupphash_tpu_torch.pipeline import decode
dev = device.pin("cuda")
assert multihost.process_info() == (rank, 2)
paths = sorted(corpus.glob("*.png"))
shards = [multihost.shard_files(paths, i, 2, by="hash") for i in range(2)]
mine = multihost.shard_files(paths, by="hash")
assert mine == shards[rank]
lumas = np.stack([decode.prepare_luma_fast(decode.load_image(p)[0])
                  for p in mine])
out = pdq_torch.pdq_hash_batch(lumas)
local_h = out["hash"].cpu().numpy()
local_v = out["dihedral"].cpu().numpy()
local_low = out["quality"].cpu().numpy() * 100 < 50
hashes, variants, low = multihost.allgather_hashes(local_h, local_v, local_low)
order = [p.name for s in shards for p in s]
d = np.unpackbits(hashes[:, None] ^ hashes[None], axis=-1).sum(-1)
ii, jj = np.nonzero(np.triu(d <= 31, k=1))
print(json.dumps({"rank": rank, "local": len(mine), "total": len(hashes),
                  "variants": list(variants.shape), "low": int(low.sum()),
                  "pairs": [[order[i], order[j]] for i, j in zip(ii, jj)],
                  "k1": pdq_cuda.pdq_hash.launches,
                  "hashes": hashes.tobytes().hex()}))
dist.destroy_process_group()
"""


def phase_multihost(tmp: Path):
    """Two processes on the one card under gloo (NCCL refuses two ranks on
    one GPU): each hashes its shard_files(by="hash") share of 32 images
    with K1 on the card, allgather_hashes reassembles the unequal shards
    in rank order, and the planted twin pair, split across the ranks, is
    the only pair within distance 31.  Every wait is bounded."""
    import socket

    import numpy as np
    from PIL import Image

    sys.path.insert(0, str(ROOT))
    from rupphash_tpu_torch.parallel import multihost

    names = ["dup_a.png", "dup_b.png"] + [f"f{i:02d}.png" for i in range(30)]
    rng = np.random.default_rng(SEED + 9)
    corpus = None
    for k in range(200):
        d = tmp / f"multihost_{k:03d}"
        paths = sorted(d / name for name in names)
        s0 = {p.name for p in multihost.shard_files(paths, 0, 2, by="hash")}
        if len({"dup_a.png", "dup_b.png"} & s0) == 1 \
                and len(s0) * 2 != len(paths):
            corpus = d
            break
    check(corpus is not None, "no corpus directory splits the twins")
    corpus.mkdir()
    twin = textured_rgb(rng)
    for name in names:
        img = twin if name.startswith("dup_") else textured_rgb(rng)
        Image.fromarray(img).save(corpus / name)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_CHILD, str(rank), str(port),
         str(corpus)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    except subprocess.TimeoutExpired:
        raise SmokeFailure("a multihost rank ran past 180 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    wall = time.perf_counter() - t0
    res = []
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"multihost rank exited {p.returncode}:\n"
              f"{err[-3000:]}")
        res.append(json.loads(out.strip().splitlines()[-1]))
    check(res[0]["hashes"] == res[1]["hashes"]
          and res[0]["total"] == len(names)
          and res[0]["local"] + res[1]["local"] == len(names)
          and res[0]["local"] != res[1]["local"],
          f"the gathered hashes differ between ranks or miss rows: "
          f"{[(r['local'], r['total']) for r in res]}")
    for r in res:
        check(r["pairs"] == [["dup_a.png", "dup_b.png"]]
              or r["pairs"] == [["dup_b.png", "dup_a.png"]],
              f"rank {r['rank']}: pairs {r['pairs']}")
        check(r["k1"] > 0 and r["variants"] == [len(names), 8, 32],
              f"rank {r['rank']}: K1 {r['k1']}, variants {r['variants']}")
    phase("multihost", f"2 ranks on one card under gloo (NCCL refuses two "
          f"ranks on one GPU): shards of {res[0]['local']} and "
          f"{res[1]['local']} images hashed by K1 ({res[0]['k1']} and "
          f"{res[1]['k1']} launches), gathered to {res[0]['total']} rows on "
          f"both ranks, the planted twin pair split across them the only "
          f"pair; {wall:.1f} s wall for both processes; card: {card_line()}")


def gps_jpeg(path: Path):
    """A JPEG whose EXIF holds a position, an altitude and times."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 10)
    ex = Image.Exif()
    ex[0x8769] = {36867: "2024:06:21 12:00:00"}
    ex[0x8825] = {1: "N", 2: (60.0, 10.0, 11.64), 3: "E",
                  4: (24.0, 56.0, 18.24), 5: 0, 6: 26.0,
                  7: (10.0, 0.0, 0.0), 29: "2024:06:21"}
    buf = io.BytesIO()
    Image.fromarray(textured_rgb(rng)).save(buf, format="JPEG", exif=ex)
    path.write_bytes(buf.getvalue())
    return path


def run_host_tool(module, args, expect):
    """One host tool as its own process: exit 0 and `expect` printed."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0 and expect in proc.stdout,
          f"{module} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        phase("tools", f"{module.rsplit('.', 1)[1]}: {line}")


def device_ms(fn, reps):
    """Mean device time of one fn() in ms: the durations of the kernels
    it launches, as torch.profiler records them.  Unlike a pair of events
    around many calls, this leaves out the time the host takes to make
    a call, which exceeds a few-microsecond kernel's own.  None where the
    profiler records no device activity (its tracing is not open to
    every process): the caller then reads graph_ms instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / reps / 1e3 if us > 0 else None


def graph_ms(fn, launches=20, replays=10):
    """Mean ms of one fn() when `launches` of them replay from a CUDA
    graph: device time plus the gap between two nodes of a graph, with
    no host work between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays) / launches


def phase_k5(dev):
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import restack

    rng = np.random.default_rng(SEED)
    result = {"max_abs_err": 0.0}
    # the tool's three widths at its 64 rows, then a size that device
    # memory bounds: 8192 rows, 75.5 MB each way
    for rows, width in ((64, 128), (64, 256), (64, 288), (8192, 288)):
        x = torch.from_numpy(rng.standard_normal((1, rows, 8 * width))
                             .astype(np.float32)).to(dev)
        before = restack.restack.launches
        got = restack.restack(x, width)
        check(restack.restack.launches == before + 1,
              f"K5 {rows}x{width}: the wrapper did not launch the kernel once")
        want = restack.restack_plain(x, width)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K5 {rows}x{width}: differs from the plain version")
        del got

        def kernel():
            return restack.restack(x, width)

        def plain():
            return restack.restack_plain(x, width)

        def library():   # one PyTorch copy computes the same restack
            return x[0].view(rows, 8, width).permute(1, 0, 2).contiguous() \
                .view(8 * rows, width)

        check(torch.equal(library(), want), f"K5 {rows}x{width}: the "
              "library call differs")
        del want
        reps = 200 if rows == 64 else 20
        call_ms, plain_call_ms = paired_ms(kernel, plain, reps)
        lib_call_ms = cuda_ms(library, reps)
        # device time, in the order plain, kernel, library, library,
        # kernel, plain
        runs = [device_ms(f, reps) for f in (plain, kernel, library, library,
                                             kernel, plain)]
        g_ms, g_lib_ms = graph_ms(kernel), graph_ms(library)
        if None in runs:
            timed_by = "a CUDA graph's replay: torch.profiler recorded none"
            plain_ms, ms, lib_ms = graph_ms(plain), g_ms, g_lib_ms
        else:
            timed_by = "torch.profiler"
            plain_ms, ms, lib_ms = ((runs[0] + runs[5]) / 2,
                                    (runs[1] + runs[4]) / 2,
                                    (runs[2] + runs[3]) / 2)
        bnd = bound(0.0, 2 * x.numel() * 4)
        phase("k5", f"rows={rows} W={width} ({x.numel() * 4 / 1e6:.1f} MB each "
              f"way): bit-identical to plain; device time a launch "
              f"({timed_by}): kernel {ms * 1e3:.2f} us, "
              f"permute+contiguous {lib_ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us; from a CUDA graph of 20 launches: "
              f"kernel {g_ms * 1e3:.2f} us, permute+contiguous "
              f"{g_lib_ms * 1e3:.2f} us; per Python call (events around "
              f"{reps} calls): kernel {call_ms * 1e3:.2f} us, "
              f"permute+contiguous {lib_call_ms * 1e3:.2f} us, plain "
              f"{plain_call_ms * 1e3:.2f} us; bound {bnd['bound_ms'] * 1e3:.2f} "
              f"us ({bnd['bound_by']}), share {bnd['bound_ms'] / ms:.3f}")
        if (rows, width) == (64, 288):
            result.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          timed_by=timed_by, graph_ms=g_ms, library_graph_ms=g_lib_ms,
                          call_ms=call_ms, plain_call_ms=plain_call_ms,
                          library_call_ms=lib_call_ms, **bnd)
        elif rows == 8192:
            result.update(large_ms=ms, large_plain_ms=plain_ms,
                          large_library_ms=lib_ms, large_graph_ms=g_ms,
                          large_bound_ms=bnd["bound_ms"],
                          large_share=bnd["bound_ms"] / ms)
        del x
        torch.cuda.empty_cache()
    return result


def run_tool(module, want_kernels):
    """Run one tool as its own process; its launch counts start at 0.
    Returns the counts it printed and its standard output."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{module} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    m = re.search(r"^kernels: (.*)$", proc.stdout, re.MULTILINE)
    check(m is not None, f"{module} printed no kernels line")
    launches = {k: int(v) for k, v in
                (kv.split("=") for kv in m.group(1).split())}
    for k in want_kernels:
        check(launches.get(k, 0) > 0, f"{module} never launched {k}: "
              f"{launches}")
    for line in proc.stdout.splitlines():
        phase("tools", f"{module.rsplit('.', 1)[1]}: {line}")
    phase("tools", f"{module}: exit 0 in {wall:.1f} s")
    return launches, proc.stdout


def phase_tools():
    launches = {}
    got, out = run_tool("rupphash_tpu_torch.tools.selftest",
                        ["pdq_coeffs_kernel", "pdq_hash_kernel",
                         "hamming_rowcount_kernel", "hamming_extract_kernel"])
    check(re.search(r"^PASS \(0 failing checks\)$", out, re.MULTILINE)
          is not None, "the self-test printed no PASS line")
    launches["pdq_coeffs_kernel"] = got["pdq_coeffs_kernel"]
    got, _ = run_tool("rupphash_tpu_torch.tools.mosaic_repro",
                      ["restack_kernel"])
    launches["restack_kernel"] = got["restack_kernel"]
    got, _ = run_tool("rupphash_tpu_torch.tools.prof_nz",
                      ["hamming_rowcount_mma_kernel",
                       "hamming_rowcount_kernel"])
    launches["hamming_rowcount_mma_kernel"] = got["hamming_rowcount_mma_kernel"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        import numpy as np
        from PIL import Image

        img = Path(tmp) / "photo.png"
        Image.fromarray(textured_rgb(np.random.default_rng(SEED))).save(img)
        run_host_tool("rupphash_tpu_torch.tools.phash_test", [img, "--pdq"],
                      "PDQ (Hex)")
        run_host_tool("rupphash_tpu_torch.tools.position_test",
                      [gps_jpeg(Path(tmp) / "gps.jpg")], "Sun Azimuth")
    return launches


XYZ2SRGB = [[3.2406, -1.5372, -0.4986], [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570]]


def write_dng(mosaic) -> bytes:
    """A minimal uncompressed DNG with no embedded preview: IFD0 holds
    DNGVersion, ColorMatrix1 (XYZ->sRGB, so that the pipeline's
    camera->sRGB step is the identity for an sRGB-primary scene) and a
    neutral AsShotNeutral; one SubIFD holds the 16-bit RGGB CFA strip."""
    import struct

    h, w = mosaic.shape
    raster = mosaic.astype("<u2").tobytes()
    formats = {1: "B", 3: "H", 4: "I", 5: "II", 10: "ii"}

    def build(raster_off: int) -> bytes:
        ifd0 = [(254, 4, [1]), (274, 3, [1]), (330, 4, [0]),
                (50706, 1, [1, 4, 0, 0]),
                (50721, 10, [(round(v * 10000), 10000)
                             for row in XYZ2SRGB for v in row]),
                (50728, 5, [(10000, 10000)] * 3)]
        sub = [(254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [16]),
               (259, 3, [1]), (262, 3, [32803]), (273, 4, [raster_off]),
               (278, 4, [h]), (279, 4, [len(raster)]), (33421, 3, [2, 2]),
               (33422, 1, [0, 1, 1, 2]), (50714, 4, [0]), (50717, 4, [65535])]
        sub_off = 8 + 2 + 12 * len(ifd0) + 4
        ifd0[2] = (330, 4, [sub_off])
        extra_off = sub_off + 2 + 12 * len(sub) + 4
        extra = bytearray()

        def ifd(entries):
            out = struct.pack("<H", len(entries))
            for tag, typ, vals in entries:
                flat = [x for v in vals for x in (v if isinstance(v, tuple)
                                                  else (v,))]
                payload = struct.pack("<" + formats[typ][0] * len(flat), *flat)
                if len(payload) <= 4:
                    out += struct.pack("<HHI4s", tag, typ, len(vals),
                                       payload.ljust(4, b"\0"))
                else:
                    out += struct.pack("<HHII", tag, typ, len(vals),
                                       extra_off + len(extra))
                    extra.extend(payload)
            return out + struct.pack("<I", 0)

        return (struct.pack("<2sHI", b"II", 42, 8) + ifd(ifd0) + ifd(sub)
                + bytes(extra))

    head = build(0)
    return build(len(head)) + raster


def dng_scene(rng, h=240, w=320):
    """A smooth textured sRGB scene and the preview-less DNG of its
    linear-light RGGB mosaic (a sensor records linear values)."""
    import numpy as np
    from PIL import Image

    base = rng.integers(30, 220, (8, 12, 3), dtype=np.uint8)
    rgb = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    srgb = rgb.astype(np.float64) / 255.0
    lin = np.where(srgb <= 0.04045, srgb / 12.92,
                   ((srgb + 0.055) / 1.055) ** 2.4)
    site = np.tile(np.array([[0, 1], [1, 2]]), (h // 2, w // 2))
    mosaic = np.round(np.take_along_axis(lin, site[:, :, None], axis=2)[
        :, :, 0] * 65535.0).astype(np.uint16)
    return rgb, write_dng(mosaic)


def write_corpus(d: Path):
    """Textured images in four working shapes plus odd sizes (full
    256-batches per shape and mixed leftovers), 60 planted groups of an
    original, a JPEG re-encode and a brightened PNG, and 20 planted
    pairs of a preview-less DNG and a PNG of its scene."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    sizes = ([(320, 240)] * 900 + [(512, 288)] * 700 + [(288, 512)] * 400
             + [(int(w), int(h)) for w, h in rng.integers(64, 513, (100, 2))])
    planted = []
    for k, (w, h) in enumerate(sizes):
        small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(small).resize((w, h),
                                                       Image.BILINEAR))
        name = f"img_{k:04d}"
        Image.fromarray(img).save(d / f"{name}.png", compress_level=1)
        if k % 35 == 0 and len(planted) < 60:
            Image.fromarray(img).save(d / f"{name}_copy.jpg", quality=90)
            bright = np.clip(img.astype(np.int16) + 10, 0, 255).astype(np.uint8)
            Image.fromarray(bright).save(d / f"{name}_bright.png",
                                         compress_level=1)
            planted.append({f"{name}.png", f"{name}_copy.jpg",
                            f"{name}_bright.png"})
    n_files = len(sizes) + 2 * len(planted)
    for k in range(20):
        rgb, dng = dng_scene(rng)
        (d / f"raw_{k:02d}.dng").write_bytes(dng)
        Image.fromarray(rgb).save(d / f"raw_{k:02d}_twin.png")
        planted.append({f"raw_{k:02d}.dng", f"raw_{k:02d}_twin.png"})
    return n_files + 40, planted


def reset_scan_counts():
    """Set the scan route's launch counts in this process to 0."""
    from rupphash_tpu_torch.ops import hamming_cuda, pdq_cuda

    for fn in (pdq_cuda.pdq_hash, hamming_cuda.scan_row_counts,
               hamming_cuda.extract_rows_packed):
        fn.launches = 0


def kernel_counts(text: str) -> dict:
    """The last [KERNELS] line of a child's stderr, as {name: count}."""
    lines = re.findall(r"\[KERNELS\] (.*)", text)
    check(lines, "no [KERNELS] line:\n" + text[-3000:])
    return {k: int(v) for k, v in (kv.split("=") for kv in lines[-1].split())}


def child_env(tmp: Path, label: str) -> dict:
    """The environment of a child of this script: the checkout on the
    path, the debug lines on, a configuration and cache of its own."""
    return {**os.environ, "RUPPHASH_DEBUG": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT), os.environ.get("PYTHONPATH", "")]),
            "RUPPHASH_CONFIG_DIR": str(tmp / f"{label}_cfg"),
            "RUPPHASH_CACHE_DIR": str(tmp / f"{label}_cache")}


def phase_e2e(tmp: Path):
    """The CLI's scan route on the corpus, written to tmp/photos (the gui
    phase scans the same tree); the launch counts and the printed groups
    as sets of file names."""
    photos = tmp / "photos"
    photos.mkdir()
    t0 = time.perf_counter()
    n_files, planted = write_corpus(photos)
    phase("e2e", f"wrote {n_files} images ({len(planted)} planted groups) "
          f"in {time.perf_counter() - t0:.1f} s")
    # the run's launch counts start at 0 in the new process; the
    # in-process counts are reset too, so nothing earlier can count
    reset_scan_counts()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rupphash_tpu_torch", "--no-cache",
         str(photos)], cwd=ROOT, env=child_env(tmp, "e2e"),
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    launches = kernel_counts(proc.stderr)
    out = re.sub(r"\x1b\[[0-9;]*m", "", proc.stdout)
    groups = [set(re.findall(r"/([^/\n]+)$", block, re.MULTILINE))
              for block in out.split("--- Group")[1:]]
    check(len(groups) == len(planted),
          f"{len(groups)} groups printed, {len(planted)} planted")
    for want in planted:
        check(any(want <= g for g in groups),
              f"planted group {sorted(want)} not printed together")
    check(all(launches[k] > 0 for k in launches),
          f"a kernel never launched on the main path: {launches}")
    timing = re.findall(r"\[TIMING\][^\n]*", proc.stderr)
    phase("e2e", f"python -m rupphash_tpu_torch --no-cache: {wall:.2f} s "
          f"wall, {len(groups)} groups = planted; launches {launches}; "
          f"{' | '.join(timing)}")
    return launches, groups


class StderrLines:
    """A child's stderr, drained by a thread: waits have a deadline."""

    def __init__(self, stream):
        self.lines: list[str] = []
        self.eof = False
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._pump, args=(stream,),
                                       daemon=True)
        self.thread.start()

    def _pump(self, stream):
        try:
            for line in iter(stream.readline, ""):
                with self.cond:
                    self.lines.append(line)
                    self.cond.notify_all()
        finally:
            with self.cond:
                self.eof = True
                self.cond.notify_all()

    def text(self) -> str:
        with self.cond:
            return "".join(self.lines)

    def wait_for(self, pattern: str, timeout: float):
        rx = re.compile(pattern)
        end = time.monotonic() + timeout
        with self.cond:
            while True:
                for line in self.lines:
                    m = rx.search(line)
                    if m:
                        return m
                left = end - time.monotonic()
                why = ("the child closed its stderr" if self.eof
                       else f"{timeout} s")
                check(left > 0 and not self.eof,
                      f"no {pattern!r} ({why}):\n"
                      + "".join(self.lines)[-3000:])
                self.cond.wait(min(left, 1.0))


class Gui:
    """A `--use-gui` child of this script and its HTTP surface; the
    CSRF token comes from the page at `/`, as a browser takes it."""

    def __init__(self, args: list, env: dict, label: str):
        self.label = label
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "rupphash_tpu_torch", "--use-gui",
             "--port", "0", *args], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self.err = StderrLines(self.proc.stderr)
        try:
            self.base = self.err.wait_for(r"GUI at (http://\S+)/",
                                          600).group(1)
            _, page, _ = self.get("/")
            self.token = re.search(rb"const TOKEN = '([0-9a-f]+)'",
                                   page).group(1).decode()
        except BaseException:
            self.stop()
            raise

    def get(self, path: str, data: bytes | None = None, headers=None):
        """(status, body bytes, seconds) of one request."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=data,
                                     headers=headers or {})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                code, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        return code, body, time.perf_counter() - t0

    def state(self) -> dict:
        code, body, _ = self.get("/api/state")
        check(code == 200, f"{self.label}: /api/state {code}")
        return json.loads(body)

    def intent(self, name: str, arg=None) -> dict:
        code, body, _ = self.get(
            "/api/intent", json.dumps({"intent": name, "arg": arg}).encode(),
            {"Content-Type": "application/json",
             "X-Session-Token": self.token})
        check(code == 200, f"{self.label}: intent {name}: {code} {body[:300]}")
        return json.loads(body)

    def wait_scanned(self, timeout: float) -> tuple[dict, float, float]:
        """Poll /api/state until the scan is done: (state, seconds from
        the start to the first answer, seconds to the scan's end)."""
        first = None
        end = time.monotonic() + timeout
        while True:
            snap = self.state()
            if first is None:
                first = time.perf_counter() - self.t0
            check(not snap["status"].startswith("scan failed"),
                  f"{self.label}: {snap['status']}")
            if snap["scanning"] is None:
                return snap, first, time.perf_counter() - self.t0
            check(time.monotonic() < end, f"{self.label}: scan not done "
                  f"in {timeout} s: {snap['scanning']}")
            time.sleep(0.2)

    def quit(self) -> str:
        """Quit through the page's intent; exit 0; the stderr."""
        check(self.intent("quit")["quit"], f"{self.label}: quit refused")
        try:
            rc = self.proc.wait(timeout=120)
        finally:
            self.stop()
        self.err.thread.join(30)
        err = self.err.text()
        check(rc == 0, f"{self.label} exited {rc}:\n{err[-3000:]}")
        return err

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def group_names(snap: dict) -> list:
    return sorted(sorted(f["name"] for f in g["files"])
                  for g in snap["groups"])


def file_index(snap: dict, name: str) -> tuple[int, int]:
    for gi, g in enumerate(snap["groups"]):
        for fi, f in enumerate(g["files"]):
            if f["name"] == name:
                return gi, fi
    raise SmokeFailure(f"{name} is in no group of the GUI")


_CPU_RENDER = """
import sys
from pathlib import Path
from rupphash_tpu_torch import device
device.pin("cpu")
from rupphash_tpu_torch.gui import imaging
eng = imaging.ImageEngine()
for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
    Path(dst).write_bytes(eng.render(Path(src), 1, None, max_side=2048,
                                     fmt="png16"))
"""


def png16(data: bytes):
    """The (H, W, 3) pixels of a 48-bit PNG as /api/image?deep=1 and
    gui.imaging.encode_png16 write it (unfiltered scanlines), as int64;
    Pillow would read it as 8-bit RGB."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", payload)
            check((depth, ctype) == (16, 2), f"PNG {depth}-bit type {ctype}")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(
        h, 1 + 6 * w)
    check(not rows[:, 0].any(), "filtered PNG scanlines")
    return rows[:, 1:].copy().view(">u2").reshape(h, w, 3).astype(np.int64)


def phase_gui(tmp: Path, cli_groups: list):
    """`--use-gui` on phase 9's tree with a cache of its own: the scan
    runs in the GUI's worker thread on the card while the server
    answers; the groups equal the CLI's, K1, K3 and K4 launch there;
    /api/image and /api/analysis from 4 threads at once (a JPEG and
    three preview-less DNGs, each DNG within the demosaic's bound of the
    port's CPU rendition); a mark and a move; quit with exit 0.  Then
    the same again on the same tree and cache: the same groups less the
    moved file, every hash from the cache (K1 0), K3 and K4 again."""
    import concurrent.futures

    import numpy as np

    t_phase = time.perf_counter()
    photos = tmp / "photos"
    moved = tmp / "gui_moved"
    moved.mkdir()
    env = child_env(tmp, "gui")
    want = sorted(sorted(g) for g in cli_groups)
    reset_scan_counts()
    gui = Gui(["--move-marked", str(moved), str(photos)], env, "gui")
    try:
        snap, first_s, done_s = gui.wait_scanned(900)
        check(group_names(snap) == want, "the GUI's groups differ from the "
              f"CLI's: {len(snap['groups'])} against {len(want)}")
        # /api/state latency at this size (host clock)
        state_s = []
        for _ in range(20):
            state_s.append(gui.get("/api/state")[2])
        state_ms = 1e3 * sorted(state_s)[len(state_s) // 2]
        names = ["img_0000_copy.jpg", "raw_00.dng", "raw_01.dng", "raw_02.dng"]
        where = {n: file_index(snap, n) for n in names}

        def fetch(name):
            g, f = where[name]
            out = {}
            for key, q in (("jpeg", ""), ("deep", "&deep=1")):
                code, body, sec = gui.get(f"/api/image?g={g}&f={f}{q}")
                check(code == 200, f"/api/image {name}{q}: {code}")
                out[key], out[key + "_s"] = body, sec
            code, body, _ = gui.get(f"/api/analysis?g={g}&f={f}")
            a = json.loads(body)
            check(code == 200 and len(a["luma"]) == 256 and a["palette"],
                  f"/api/analysis {name}: {code}")
            return name, out

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            served = dict(ex.map(fetch, names))
        check(served["img_0000_copy.jpg"]["jpeg"][:2] == b"\xff\xd8",
              "the JPEG's /api/image is no JPEG")
        # the same DNGs rendered by the port on the CPU, in a child
        dngs = [n for n in names if n.endswith(".dng")]
        args = [x for n in dngs for x in (str(photos / n),
                                          str(tmp / f"{n}.cpu.png"))]
        proc = subprocess.run([sys.executable, "-c", _CPU_RENDER, *args],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"CPU rendition: {proc.stderr[-3000:]}")
        worst = []
        for n in dngs:
            card = png16(served[n]["deep"])
            cpu = png16((tmp / f"{n}.cpu.png").read_bytes())
            check(card.shape == cpu.shape == (240, 320, 3),
                  f"{n}: {card.shape} against {cpu.shape}")
            diff = np.abs(card - cpu) / 257.0      # in u8 levels
            n_diff = int(np.count_nonzero(diff))
            check(diff.max() <= 1 and n_diff <= 1e-4 * diff.size,
                  f"{n}: card against CPU max {diff.max()} levels on "
                  f"{n_diff} of {diff.size} values")
            worst.append((float(diff.max()), n_diff))
        # one cold request each, after the concurrent ones
        jpeg_s = gui.get("/api/image?g=%d&f=%d" % file_index(
            snap, "img_0035_copy.jpg"))[2]
        dng_s = gui.get("/api/image?g=%d&f=%d" % file_index(
            snap, "raw_03.dng"))[2]
        # mark a member of a planted group of three, move it
        victim = "img_0000_bright.png"
        gui.intent("select", list(file_index(snap, victim)))
        check(gui.intent("toggle_mark")["marked"] == 1, "mark not taken")
        check(gui.intent("move_marked")["pending_confirm"] == "move",
              "move not armed")
        after = gui.intent("move_marked")
        check((moved / victim).is_file() and not (photos / victim).exists(),
              f"{victim} not moved: {after['status']}")
        err = gui.quit()
    finally:
        gui.stop()
    launches = kernel_counts(err)
    check(all(launches[k] > 0 for k in launches),
          f"a kernel never launched in the GUI's scan: {launches}")
    phase("gui", f"--use-gui on {sum(1 for _ in photos.iterdir()) + 1} files: "
          f"groups = the CLI's ({len(want)}); launches {launches}; "
          f"4 concurrent clients: JPEG and 3 DNGs served, DNG card against "
          f"CPU (max levels, values apart) {worst} (gate: <=1 on <=1e-4); "
          f"{victim} marked and moved; quit -> exit 0")

    # the same tree and cache again: a cached rescan
    want = sorted(sorted(n for n in g if n != victim) for g in cli_groups)
    reset_scan_counts()
    gui = Gui([str(photos)], env, "gui-rescan")
    try:
        snap, re_first_s, re_done_s = gui.wait_scanned(900)
        check(group_names(snap) == want, "the rescan's groups differ: "
              f"{len(snap['groups'])} against {len(want)}")
        err = gui.quit()
    finally:
        gui.stop()
    relaunch = kernel_counts(err)
    check(relaunch["pdq_hash_kernel"] == 0,
          f"K1 launched on a fully cached rescan: {relaunch}")
    check(relaunch["hamming_rowcount_kernel"] > 0
          and relaunch["hamming_extract_kernel"] > 0,
          f"K3 or K4 did not launch on the rescan: {relaunch}")
    cache = re.findall(r"\[CACHE\][^\n]*", err)
    phase("gui", f"cached rescan: the same {len(want)} groups, launches "
          f"{relaunch}; {' | '.join(cache)}")
    phase("gui", f"host clock: start to first /api/state {first_s:.2f} s, "
          f"to scan done {done_s:.2f} s; rescan start to scan done "
          f"{re_done_s:.2f} s (first answer {re_first_s:.2f} s); /api/state "
          f"median {state_ms:.2f} ms with {len(cli_groups)} groups; cold "
          f"/api/image JPEG {jpeg_s * 1e3:.1f} ms, DNG {dng_s * 1e3:.1f} ms; "
          f"phase {time.perf_counter() - t_phase:.1f} s; card: {card_line()}")


def phase_tui(tmp: Path):
    """`--use-tui` on the card through a pseudo-terminal, on 300 files
    with two planted pairs (more than 256 hashes, so the edge search runs
    on the card and not in the host's brute force): the group list
    renders, the sort menu opens and closes, z quits with exit 0, and
    the stderr (a file, off the terminal) shows K1, K3 and K4 launched.
    Then `--view --use-gui` on the same directory lists its files and
    quits with exit 0."""
    import pty
    import select

    import numpy as np
    from PIL import Image

    t_phase = time.perf_counter()
    d = tmp / "tui"
    d.mkdir()
    rng = np.random.default_rng(SEED + 7)
    for k in range(296):
        Image.fromarray(textured_rgb(rng, (160, 120))).save(
            d / f"t_{k:03d}.png", compress_level=1)
    for k in (3, 150):
        Image.fromarray(np.asarray(Image.open(d / f"t_{k:03d}.png"))).save(
            d / f"t_{k:03d}_copy.jpg", quality=92)
    for k in (7, 9):        # two files past the pairs: 300 in all
        Image.fromarray(textured_rgb(rng, (200, 150))).save(
            d / f"u_{k}.png")
    env = {**child_env(tmp, "tui"), "TERM": "xterm-256color", "LINES": "40",
           "COLUMNS": "120"}
    err_path = tmp / "tui_stderr.txt"
    reset_scan_counts()
    fd, slave = pty.openpty()
    t0 = time.perf_counter()
    with err_path.open("w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "rupphash_tpu_torch", "--use-tui", str(d)],
            cwd=ROOT, env=env, stdin=slave, stdout=slave, stderr=err_file,
            close_fds=True, start_new_session=True)
    os.close(slave)
    screen = b""

    def read_until(needle: bytes, timeout: float):
        nonlocal screen
        end = time.monotonic() + timeout
        while needle not in screen and time.monotonic() < end:
            r, _, _ = select.select([fd], [], [], 0.3)
            if r:
                try:
                    chunk = os.read(fd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                screen += chunk
        return needle in screen

    try:
        check(read_until(b"-- Group 1", 600), "the TUI drew no group list:\n"
              + err_path.read_text()[-3000:])
        up_s = time.perf_counter() - t0
        check(read_until(b"t_150_copy.jpg", 30), "a planted pair is missing")
        os.write(fd, b"s")
        check(read_until(b"Sort order", 30), "the sort menu did not open")
        os.write(fd, b"\x1b")
        time.sleep(0.5)
        os.write(fd, b"z")
        rc = proc.wait(timeout=60)
    finally:
        os.close(fd)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    err = err_path.read_text()
    check(rc == 0, f"--use-tui exited {rc}:\n{err[-3000:]}")
    launches = kernel_counts(err)
    check(all(launches[k] > 0 for k in launches),
          f"a kernel never launched in the TUI's scan: {launches}")
    phase("tui", f"--use-tui on 300 files: list drawn {up_s:.1f} s after "
          f"the start, both planted pairs shown, sort menu opened and "
          f"closed, z -> exit 0; launches {launches}")

    gui = Gui(["--view", str(d)], env, "view-gui")
    try:
        snap = gui.state()
        n = sum(len(g["files"]) for g in snap["groups"])
        check(n == 300, f"--view --use-gui lists {n} files, want 300")
        err = gui.quit()
    finally:
        gui.stop()
    phase("tui", f"--view --use-gui: {n} files listed, quit -> exit 0; "
          f"phase {time.perf_counter() - t_phase:.1f} s")


XTRANS = [[1, 2, 1, 1, 0, 1], [0, 1, 0, 2, 1, 2], [1, 2, 1, 1, 0, 1],
          [1, 0, 1, 1, 2, 1], [2, 1, 2, 0, 1, 0], [1, 0, 1, 1, 2, 1]]


def phase_demosaic(dev):
    """The port's process_raw on the card and on the CPU, at 24 MP
    (6000x4002) for an RGGB mosaic with a colour matrix and an X-Trans
    6x6 mosaic: at most 1 u8 level apart, on at most 1e-4 of the
    values."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import demosaic

    rng = np.random.default_rng(SEED + 4)
    h, w = 4002, 6000
    small = torch.from_numpy(rng.random((1, 3, 40, 60), dtype=np.float32))
    lin = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                          align_corners=False)[0].numpy()
    lin = np.clip(lin + rng.normal(0, 0.01, (1, h, w)).astype(np.float32),
                  0, 1)
    camera = np.array([[0.9, -0.3, -0.1], [-0.4, 1.2, 0.2],
                       [-0.05, 0.2, 0.6]])
    for label, cfa in (("RGGB", np.array([[0, 1], [1, 2]])),
                       ("X-Trans", np.array(XTRANS))):
        n = cfa.shape[0]
        site = np.tile(cfa, (h // n, w // n))
        mosaic = np.round(512 + np.take_along_axis(lin, site[None], axis=0)[0]
                          * (16383 - 512)).astype(np.uint16)
        raw = SimpleNamespace(mosaic=mosaic, cfa=cfa, black=512.0,
                              white=16383.0, linear=False,
                              as_shot_neutral=np.array([0.5, 1.0, 0.7]),
                              color_matrix=camera)
        got = demosaic.process_raw(raw, dev)
        t0 = time.perf_counter()
        want = demosaic.process_raw(raw, "cpu")
        cpu_s = time.perf_counter() - t0
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        n_diff = int(np.count_nonzero(diff))
        check(got.shape == want.shape == (h, w, 3),
              f"demosaic {label}: shapes {got.shape} vs {want.shape}")
        check(int(diff.max()) <= 1 and n_diff <= 1e-4 * diff.size,
              f"demosaic {label}: CUDA vs CPU max {int(diff.max())} levels "
              f"on {n_diff} of {diff.size} values")
        ms = cuda_ms(lambda: demosaic.process_raw(raw, dev), 3)
        phase("demosaic", f"{label} {w}x{h}: CUDA vs CPU max |d| "
              f"{int(diff.max())} level(s) on {n_diff} of {diff.size} values "
              f"(gate: <=1 on <=1e-4); process_raw on the card {ms:.2f} ms "
              f"(CUDA events, upload and readback included), on the CPU "
              f"{cpu_s * 1e3:.1f} ms (host clock); card: {card_line()}")


def textured_rgb(rng, size=(320, 240)):
    import numpy as np
    from PIL import Image

    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize(size, Image.BILINEAR))


def encoded(img, fmt, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


def popcount(x):
    """Popcount of each element of a u64 array, as int32."""
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int32)
    lut = np.array([bin(i).count("1") for i in range(256)], np.int32)
    return lut[x[..., None].view(np.uint8)].sum(axis=-1, dtype=np.int32)


def golden_variants(data, dev):
    """The host's answer to 'what does this body hash to': decoded with
    the port's decoder on the service's device, hashed by the numpy PDQ
    golden (no kernel); ((8, 32) u8 variants, quality 0-100) or None."""
    import numpy as np

    from rupphash_tpu_torch import serve
    from rupphash_tpu_torch.ops import pdq_torch

    img = serve.decode.sniff_decode_bytes(data, device=dev)
    luma = None if img is None else serve.prepare_luma_fast(img)
    if luma is None:
        return None
    coeffs, _, quality = pdq_torch.pdq_ref.pdq_from_luma(luma)
    variants = np.stack([np.frombuffer(v, np.uint8) for v in
                         pdq_torch.pdq_ref.dihedral_hashes(coeffs)])
    return variants, float(np.float32(quality)) * 100.0


def index_oracle(ix):
    """The /v1/query answer computed on the host from the index's host
    arrays (which must not change while it is used): min over the 8
    variants of popcount(XOR) against every row, dead rows never,
    low-quality rows only at 0, a low-quality query only at 0, within
    the radius, sorted by (distance, slot)."""
    import numpy as np

    n = ix._n
    words = [np.ascontiguousarray(c) for c in
             np.ascontiguousarray(ix._hashes[:n]).view(np.uint64).T]
    live = ~ix._dead[:n]
    good = ix._quality[:n] >= 50
    rank = np.cumsum(live) - 1

    def answer(variants, quality, sim=40, max_results=100):
        dist = None
        for v in np.ascontiguousarray(variants).view(np.uint64):
            d = sum(popcount(col ^ w) for col, w in zip(words, v))
            dist = d if dist is None else np.minimum(dist, d)
        radius = 0 if quality < 50 else max(0, min(sim, 255))
        sel = np.flatnonzero(live & (good | (dist == 0)) & (dist <= radius))
        sel = sel[np.lexsort((sel, dist[sel]))][:max_results]
        return [{"path": ix._paths[i], "distance": int(dist[i]),
                 "index": int(rank[i])} for i in sel]

    return answer


def http(port, path, data=None):
    """(status, JSON body, seconds) of one request to the service."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, time.perf_counter() - t0


def host_ms(fn, reps):
    """Mean host-clock ms of fn(), after one warm-up call; fn ends in a
    device-to-host copy, so the device work is inside the window."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_requests(port, bodies) -> str:
    """Serial /v1/query requests under torch.profiler, tracing device
    activity only: the device's busy share of the requests (sum of
    kernel self times over the sum of the requests' own latencies; the
    profiler's start and stop, seconds of CUPTI set-up and trace
    processing, lie outside them) and the kernels that took most of it.
    Each request ends after its results are read back, so its device
    work lies inside its latency.  The profiler's cost per launch is
    inside, so the share is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        walls = [http(port, "/v1/query", b)[2] for b in bodies]
        torch.cuda.synchronize()
    wall_us = sum(walls) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    if not total:
        return "torch.profiler saw no device time (busy share not measured)"
    top = sorted(events, key=dev_us, reverse=True)[:4]
    return (f"torch.profiler (device activity) over {len(bodies)} serial "
            f"queries: device busy {total / 1e3:.2f} ms of "
            f"{wall_us / 1e3:.1f} ms of request latency "
            f"({100 * total / wall_us:.1f}%), top: " + ", ".join(
                f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms" for e in top))


def build_corpus_index(path: Path, imgs_golden, n_rows, rng):
    """An index file of n_rows 256-bit hashes: random rows (1 in 50 of
    them low quality), and for every indexed image near copies of its
    hash at distances 0-40 (1 in 7 low quality), at random slots."""
    import numpy as np

    hashes = rng.integers(0, 256, (n_rows, 32), dtype=np.uint8)
    quality = rng.integers(50, 101, n_rows).astype(np.int32)
    quality[rng.random(n_rows) < 0.02] = 20
    paths = [f"/corpus/{i:07d}.jpg" for i in range(n_rows)]
    slots = iter(rng.permutation(n_rows))
    planted = []
    for k, (variants, _) in enumerate(imgs_golden):
        for j in range(1 + k % 4):
            dist = int(rng.integers(0, 41))
            h = variants[0].copy()
            for bit in rng.choice(256, dist, replace=False):
                h[bit // 8] ^= np.uint8(1 << (bit % 8))
            i = int(next(slots))
            hashes[i] = h
            quality[i] = 20 if (k + j) % 7 == 3 else 90
            paths[i] = f"/planted/{k}/{j}_d{dist}.jpg"
            planted.append(paths[i])
    with open(path, "wb") as fh:
        np.savez(fh, hashes=hashes, quality=quality,
                 paths_json=np.frombuffer(json.dumps(paths).encode(),
                                          np.uint8))
    return planted


N_ROWS = 1_000_000   # rows of the in-process service's index


def phase_serve(dev):
    """NearDupService in process over a 1M-row index: ~200 images added
    through /v1/add, ~200 /v1/query bodies sent serially and then from 8
    concurrent clients; every answer equal to the host oracle; K1
    launched once per hash."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from rupphash_tpu_torch import serve
    from rupphash_tpu_torch.ops import pdq_cuda, pdq_torch

    n_rows, n_images = N_ROWS, 200
    rng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tmp = Path(tmp)
        imgs_dir = tmp / "imgs"
        imgs_dir.mkdir()
        sizes = [(320, 240), (512, 288), (288, 512), (640, 480)]
        imgs = [textured_rgb(rng, sizes[k % 4]) for k in range(n_images)]
        for k, img in enumerate(imgs):
            Image.fromarray(img).save(imgs_dir / f"img_{k:03d}.png",
                                      compress_level=1)
        dng_bodies = []
        for k in range(2):
            rgb, dng = dng_scene(rng)
            Image.fromarray(rgb).save(imgs_dir / f"raw_twin_{k}.png")
            dng_bodies.append(dng)
        add_paths = sorted(imgs_dir.iterdir())
        t0 = time.perf_counter()
        golden_add = [golden_variants(p.read_bytes(), dev) for p in add_paths]
        planted = build_corpus_index(tmp / "index.npz", golden_add[:n_images],
                                     n_rows - len(add_paths), rng)
        ix = serve.HashIndex.load(tmp / "index.npz")
        for path in planted[::9]:                          # tombstones
            check(ix.remove(path) == 1, f"could not remove {path}")
        phase("serve", f"index of {len(ix)} live rows ({ix._n_dead} "
              f"tombstones, {len(planted)} planted near copies) built in "
              f"{time.perf_counter() - t0:.1f} s")

        # nearly flat: texture of +-2 levels, PDQ quality far below 50
        # (a truly constant image's coefficients are rounding noise, and
        # its hash bits depend on the order of summation)
        flat = [np.round(100.0 + 5 * k + (textured_rgb(rng) - 127.5) / 64
                         ).astype(np.uint8) for k in range(20)]
        bodies = ([encoded(imgs[k], "JPEG", quality=85) for k in range(0, 200, 2)]
                  + [encoded(np.rot90(imgs[k]), "PNG")
                     for k in range(1, 80, 2)]
                  + [encoded(textured_rgb(rng), "JPEG", quality=90)
                     for _ in range(40)]
                  + [encoded(f, "PNG") for f in flat] + dng_bodies)
        kinds = (["JPEG re-encode"] * 100 + ["rotated PNG"] * 40
                 + ["unrelated JPEG"] * 40 + ["nearly flat PNG"] * 20
                 + ["DNG"] * 2)
        # a low-quality query matches only at distance 0: plant one flat
        # image's exact hash (low quality) and a 3-bit copy of another's
        for k, (body, q) in enumerate(((bodies[-12], 10), (bodies[-5], 90))):
            h = golden_variants(body, dev)[0][0].copy()
            h[0] ^= np.uint8(7 * k)
            ix.add(f"/planted/flat_{k}.png", h, q)
        svc = serve.NearDupService(ix, roots=[imgs_dir])
        httpd, port = svc.serve()
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            pdq_cuda.pdq_hash.launches = 0
            torch.cuda.synchronize()
            code, _, first_s = http(port, "/v1/query", bodies[0])
            check(code == 200, f"first query answered {code}")
            push = serve.UPLOAD_BYTES
            for p, gold in zip(add_paths, golden_add):
                code, out, _ = http(port, f"/v1/add?path={p}", b"")
                check(code == 200 and out["hash"] == bytes(gold[0][0]).hex(),
                      f"/v1/add {p.name}: {code} {out}")
            removed = [http(port, f"/v1/remove?path={add_paths[k]}", b"")[1]
                       for k in (3, 5)]
            check([r["removed"] for r in removed] == [1, 1],
                  f"/v1/remove: {removed}")
            code, _, _ = http(port, "/v1/query", b"not an image at all")
            check(code == 415, f"junk body answered {code}")
            torch.cuda.reset_peak_memory_stats()
            serial = [http(port, "/v1/query", b) for b in bodies]
            peak_serial = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                concurrent = list(pool.map(
                    lambda b: http(port, "/v1/query", b), bodies))
            conc_wall = time.perf_counter() - t0
            peak_conc = torch.cuda.max_memory_allocated()
            uploaded = serve.UPLOAD_BYTES - push
            code, stats, _ = http(port, "/v1/stats")
            launches = pdq_cuda.pdq_hash.launches
            stats_ms = np.array([http(port, "/v1/stats")[2]
                                 for _ in range(50)]) * 1e3
            busy = profile_requests(port, bodies[:20])
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)

        t0 = time.perf_counter()
        n_match = 0
        oracle = index_oracle(ix)
        for body, (code, got, _), (code2, got2, _) in zip(bodies, serial,
                                                          concurrent):
            variants, quality = golden_variants(body, dev)
            want = oracle(variants, quality)
            check(code == 200 and got["hash"] == bytes(variants[0]).hex()
                  and abs(got["quality"] - quality) < 1e-3
                  and got["matches"] == want,
                  f"a serial answer differs from the oracle: {got} vs {want}")
            check((code2, got2) == (code, got),
                  "a concurrent answer differs from the serial one")
            n_match += bool(want)
        oracle_s = time.perf_counter() - t0
        n_hashes = 1 + len(add_paths) + 2 * len(bodies)
        check(launches == n_hashes, f"K1 launched {launches} times for "
              f"{n_hashes} hashes")
        check(stats["indexed"] == len(ix)
              and stats["queries"] == 1 + 2 * len(bodies),
              f"/v1/stats: {stats}")
        n_req = len(add_paths) + 2 + 1 + 2 * len(bodies)
        check(uploaded < n_req * 4096,
              f"{uploaded} bytes uploaded for {n_req} requests at "
              f"{ix._n} rows: not O(delta)")

        serve_mesh(dev, ix, imgs_dir, imgs, bodies[::4])

        lat = np.array([t for _, _, t in serial]) * 1e3
        clat = np.array([t for _, _, t in concurrent]) * 1e3
        [(base_dev, st_dev)], _, n, _ = ix._device_arrays()
        q = torch.from_numpy(golden_variants(bodies[0], dev)[0][None]).to(dev)
        query_ms = cuda_ms(lambda: serve._query_topk(q, base_dev, st_dev, n,
                                                     256, 128), 20)
        luma = serve.prepare_luma_fast(
            serve.decode.sniff_decode_bytes(bodies[0], device=dev))
        t0 = time.perf_counter()
        for _ in range(20):
            serve.prepare_luma_fast(serve.decode.sniff_decode_bytes(
                bodies[0], device=dev))
        decode_ms = (time.perf_counter() - t0) / 20 * 1e3
        planes = torch.from_numpy(luma[None]).to(dev)
        k1_ms = cuda_ms(lambda: pdq_torch.pdq_hash_batch(planes), 50)
        variants = golden_variants(bodies[0], dev)[0][None]
        index_ms = host_ms(lambda: ix.query(variants, 40, 100), 20)
        library_ms = host_ms(lambda: svc.query_bytes(bodies[0]), 20)
        by_kind = "; ".join(
            f"{kind} p50 {np.percentile(lat[[k == kind for k in kinds]], 50):.2f}"
            for kind in dict.fromkeys(kinds))
        phase("serve", f"{len(bodies)} bodies ({n_match} with matches), "
              f"serial and 8 concurrent clients: every answer equal to the "
              f"host oracle ({oracle_s:.1f} s); K1 launches {launches} = "
              f"hashes {n_hashes}; /v1/stats {json.dumps(stats)}")
        phase("serve", f"index {ix._n} slots (capacity "
              f"{int(base_dev.shape[0])}): serial latency p50 "
              f"{np.percentile(lat, 50):.2f} ms p99 "
              f"{np.percentile(lat, 99):.2f} ms; 8 clients p50 "
              f"{np.percentile(clat, 50):.2f} ms p99 "
              f"{np.percentile(clat, 99):.2f} ms, {len(bodies) / conc_wall:.1f} "
              f"req/s; first query (corpus push) {first_s * 1e3:.1f} ms; "
              f"serial p50 by body (ms): {by_kind}")
        phase("serve", f"per request, JPEG 320x240 body: decode+luma "
              f"{decode_ms:.3f} ms (host clock), K1 at B=1 {k1_ms:.4f} ms "
              f"(host prep + launch, CUDA events), query top-k at "
              f"{n} rows {query_ms:.3f} ms (CUDA events); HashIndex.query "
              f"{index_ms:.3f} ms and NearDupService.query_bytes "
              f"{library_ms:.3f} ms (host clock, no HTTP); GET /v1/stats "
              f"round trip p50 {np.percentile(stats_ms, 50):.3f} ms; "
              f"{busy}; peak device "
              f"memory {peak_serial / 2**20:.0f} MiB serial, "
              f"{peak_conc / 2**20:.0f} MiB with 8 clients; uploads "
              f"{uploaded} bytes for {n_req} requests after the first push; "
              f"card: {card_line()}")
    return launches


def serve_mesh(dev, ix, imgs_dir, imgs, bodies):
    """NearDupService(mesh=...) over the serve phase's index, its corpus
    sharded over a 2 x 2 virtual mesh of the card: one /v1/add and one
    /v1/remove after the mesh's first push (uploads O(delta)), then
    ~50 /v1/query bodies, each answer equal to the one-device query and
    to the host oracle.  K1's count is set to 0 before and read after."""
    import numpy as np
    import torch
    from PIL import Image

    from rupphash_tpu_torch import serve
    from rupphash_tpu_torch.ops import pdq_cuda
    from rupphash_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(4, devices=[dev] * 4)
    svc = serve.NearDupService(ix, roots=[imgs_dir], mesh=mesh)
    extra = imgs_dir / "mesh_add.png"
    Image.fromarray(imgs[0]).save(extra)
    httpd, port = svc.serve()
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        pdq_cuda.pdq_hash.launches = 0
        push = serve.UPLOAD_BYTES
        code, _, first_s = http(port, "/v1/query", bodies[0])
        check(code == 200, f"mesh: first query answered {code}")
        first_push = serve.UPLOAD_BYTES - push
        push = serve.UPLOAD_BYTES
        code, added, _ = http(port, f"/v1/add?path={extra}", b"")
        check(code == 200, f"mesh: /v1/add answered {code} {added}")
        gone = imgs_dir / "img_007.png"
        code, removed, _ = http(port, f"/v1/remove?path={gone}", b"")
        check(code == 200 and removed["removed"] == 1,
              f"mesh: /v1/remove answered {code} {removed}")
        answers = [http(port, "/v1/query", b) for b in bodies]
        delta = serve.UPLOAD_BYTES - push
        launches = pdq_cuda.pdq_hash.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    # the one-device answers come from a copy of the index after the
    # mutations (save and load keep the live rows in order, so indices
    # agree), which leaves ix's residency on the mesh
    ix.save(imgs_dir.parent / "mesh_copy.npz")
    one = serve.HashIndex.load(imgs_dir.parent / "mesh_copy.npz")
    t0 = time.perf_counter()
    oracle = index_oracle(ix)
    n_match = 0
    for body, (code, got, _) in zip(bodies, answers):
        variants, quality = golden_variants(body, dev)
        sim = 40 if quality >= 50 else 0
        single = [{"path": p, "distance": d, "index": i}
                  for i, p, d in one.query(variants[None], sim, 100)[0]]
        want = oracle(variants, quality)
        check(code == 200 and got["matches"] == single == want,
              f"mesh: an answer differs from the one-device query or the "
              f"oracle: {got} vs {single} vs {want}")
        n_match += bool(want)
    check(any(m["path"] == str(extra) for m in answers[0][1]["matches"]),
          "mesh: the added file is not found")
    check(launches == 2 + len(bodies),
          f"mesh: K1 launched {launches} times for {2 + len(bodies)} hashes")
    check(delta < (2 + len(bodies)) * 4096,
          f"mesh: {delta} bytes uploaded after the first push: not O(delta)")
    variants = golden_variants(bodies[0], dev)[0][None]
    mesh_ms = host_ms(lambda: ix.query(variants, 40, 100, mesh=mesh), 20)
    one_ms = host_ms(lambda: one.query(variants, 40, 100), 20)
    shards = ix._dev["shards"]
    phase("serve", f"mesh {mesh.shape} of {dev} (virtual): first push "
          f"{first_push} bytes in 4 shards of {len(shards[0][0])} rows, "
          f"{first_s * 1e3:.1f} ms; /v1/add + /v1/remove + {len(bodies)} "
          f"queries uploaded {delta} bytes; {len(bodies)} answers "
          f"({n_match} with matches) equal to the one-device query and the "
          f"host oracle ({time.perf_counter() - t0:.1f} s); K1 launches "
          f"{launches}; HashIndex.query {mesh_ms:.3f} ms on the mesh vs "
          f"{one_ms:.3f} ms on one device (host clock, one card); card: "
          f"{card_line()}")


def phase_serve_cli():
    """`python -m rupphash_tpu_torch --serve DIR --port 0 --index-file F`
    on ~300 images (10 of them preview-less DNGs): read its URL, query
    it, add a file, SIGINT; exit 0, F reloads with the adds, K1 > 0."""
    import signal

    import numpy as np
    from PIL import Image

    from rupphash_tpu_torch import serve

    rng = np.random.default_rng(SEED + 6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        photos = tmp / "photos"
        photos.mkdir()
        imgs = [textured_rgb(rng) for _ in range(280)]
        for k, img in enumerate(imgs):
            Image.fromarray(img).save(photos / f"img_{k:03d}.png",
                                      compress_level=1)
        dngs = []
        for k in range(10):
            rgb, dng = dng_scene(rng)
            (photos / f"raw_{k}.dng").write_bytes(dng)
            Image.fromarray(rgb).save(photos / f"raw_{k}_twin.png")
            dngs.append(dng)
        n_files = len(imgs) + 20
        index_file = tmp / "index.npz"
        env = {**os.environ, "RUPPHASH_DEBUG": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]),
               "RUPPHASH_CONFIG_DIR": str(tmp / "cfg"),
               "RUPPHASH_CACHE_DIR": str(tmp / "cache")}
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "rupphash_tpu_torch", "--serve",
             str(photos), "--port", "0", "--index-file", str(index_file)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        err_lines = StderrLines(proc.stderr)
        try:
            port = int(err_lines.wait_for(
                r"service at http://[^:]+:(\d+)/v1/", 600).group(1))
            up_s = time.perf_counter() - t0
            m = re.search(r"indexed (\d+) images \((\d+) failures\)",
                          err_lines.text())
            check(m is not None and int(m.group(1)) == n_files
                  and m.group(2) == "0",
                  f"scan of {n_files} files: {m and m.group(0)}")
            code, out, _ = http(port, "/v1/query",
                                encoded(imgs[7], "JPEG", quality=85))
            check(code == 200 and out["matches"] and out["matches"][0][
                "path"].endswith("img_007.png"), f"JPEG query: {out}")
            code, out, _ = http(port, "/v1/query", dngs[3])
            names = {Path(m["path"]).name for m in out["matches"]}
            check(code == 200 and {"raw_3.dng", "raw_3_twin.png"} <= names,
                  f"DNG query: {code} {names}")
            late = photos / "late.png"
            Image.fromarray(textured_rgb(rng)).save(late)
            code, out, _ = http(port, f"/v1/add?path={late}", b"")
            check(code == 200 and out["size"] == n_files + 1,
                  f"/v1/add: {code} {out}")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err_lines.thread.join(timeout=30)
        err = err_lines.text()
        check(rc == 0, f"--serve exited {rc}:\n{err[-3000:]}")
        ix = serve.HashIndex.load(index_file)
        check(len(ix) == n_files + 1 and str(late) in ix.paths,
              f"index file holds {len(ix)} hashes, want {n_files + 1}")
        launches = kernel_counts(err)
        check(launches["pdq_hash_kernel"] > 0, f"K1 never launched: {launches}")
        phase("serve-cli", f"--serve on {n_files} files (10 preview-less "
              f"DNGs): URL after {up_s:.1f} s, JPEG and DNG queries matched, "
              f"/v1/add, SIGINT -> exit 0, index file reloads with "
              f"{len(ix)} hashes; launches {launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not (ROOT / "rupphash_tpu_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no rupphash_tpu_torch package; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    dev = phase_env()
    phase_build()
    k1, batches = phase_k1(dev)
    k2 = phase_k2(dev, batches)
    hm, inputs = phase_hamming(dev)
    k6 = phase_k6(inputs)
    del batches, inputs
    torch.cuda.empty_cache()
    k3_1m, k4_1m, big = phase_k3_1m(dev)
    hm["k3"].update(k3_1m)
    k6.update(ms_1m=k3_1m["k6_1m_ms"], bound_ms_1m=k3_1m["k3_1m_bound_ms"])
    hm["k4"].update(k4_1m)
    torch.cuda.empty_cache()
    phase_mesh(dev, big)
    del big
    torch.cuda.empty_cache()
    k5 = phase_k5(dev)
    phase_demosaic(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, cli_groups = phase_e2e(Path(tmp))
        phase_mesh_groups(Path(tmp), cli_groups)
        phase_gui(Path(tmp), cli_groups)
        phase_tui(Path(tmp))
        phase_multihost(Path(tmp))
    phase_serve(dev)
    phase_serve_cli()
    launches.update(phase_tools())
    kernels = [
        {"name": "pdq_hash_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/pdq.cu",
         "replaces": "rupphash_tpu/ops/pdq_pallas.py:91",
         "launches": launches["pdq_hash_kernel"], **k1},
        {"name": "hamming_rowcount_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/hamming.cu",
         "replaces": "rupphash_tpu/ops/hamming_pallas.py:42",
         "launches": launches["hamming_rowcount_kernel"], **hm["k3"]},
        {"name": "hamming_extract_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/hamming.cu",
         "replaces": "rupphash_tpu/ops/hamming_pallas.py:152",
         "launches": launches["hamming_extract_kernel"], **hm["k4"]},
        {"name": "pdq_coeffs_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/pdq_coeffs.cu",
         "replaces": "rupphash_tpu/ops/pdq_pallas.py:207",
         "launches": launches["pdq_coeffs_kernel"], **k2},
        {"name": "restack_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/restack.cu",
         "replaces": "rupphash_tpu/tools/mosaic_repro.py:30",
         "launches": launches["restack_kernel"], **k5},
        {"name": "hamming_rowcount_mma_kernel", "route": "cuda",
         "source": "rupphash_tpu_torch/csrc/hamming_mma.cu",
         "replaces": "_prof_nz.py:78",
         "launches": launches["hamming_rowcount_mma_kernel"], **k6},
    ]
    for k in kernels:
        with_share(k)
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

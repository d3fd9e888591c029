#!/usr/bin/env python3
"""Smoke test of rupphash_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in the order they run, each printing its own lines; any
failure exits non-zero:
  1. environment: torch/CUDA versions, card name and power limit,
     float32 precision flags, Pillow/cryptography availability;
  2. build of the CUDA kernels from rupphash_tpu_torch/csrc;
  3. K1 (PDQ hash) against its plain PyTorch version and the numpy
     golden, at B=256 for 512x288, 320x240 and a mixed-shape batch;
  4. K2 (hybrid PDQ front half) against its plain version, and its
     hashes against K1's and the numpy golden, on phase 3's batches and
     a B=256 batch of 512 rows x 288 columns (the self-test's shape);
  5. K3 (count sweep) and K4 (hot-row extraction) against their plain
     versions at N=100,000 hashes with planted clusters, and the edge
     search against the brute-force oracle at N=4,096;
  6. K6 (int8 tensor-core count sweep) against K3 and its plain
     version on phase 5's N=100,000 hashes, K6 ms beside K3 ms;
  7. K5 (column restack) against its plain version, bit for bit, at
     W = 128, 256, 288;
  8. demosaic: the port's RAW pipeline (plain PyTorch, no kernel) on
     the card against the CPU at 24 MP, RGGB with a colour matrix and
     X-Trans: at most 1 u8 level apart on at most 1e-4 of the values;
  9. end to end: `python -m rupphash_tpu_torch --no-cache DIR` on a
     generated directory of textured images with 60 planted duplicate
     groups and 20 preview-less DNGs with PNG twins (80 groups); checks
     the printed groups and that every kernel launched;
 10. serve: NearDupService in process over a 1,000,000-row index
     (planted near copies at distances 0-40, low-quality rows,
     tombstones), ~200 images added through /v1/add, ~200 /v1/query
     bodies (JPEG re-encodes, rotations, unrelated, nearly flat and two
     preview-less DNGs) sent serially and from 8 concurrent clients;
     every answer equal to a host numpy oracle, K1 launched once per
     hash, uploads O(delta); latency, query and K1 times, peak memory;
 11. serve CLI: `python -m rupphash_tpu_torch --serve DIR --port 0
     --index-file F` on 300 images (10 preview-less DNGs): queried,
     added to, stopped with SIGINT; exit 0, F reloads, K1 launched;
 12. tools: the self-test, mosaic_repro and prof_nz, each as its own
     process, must exit 0; their launch counts show that the self-test
     ran K2, mosaic_repro K5 and prof_nz K6 (which holds K6 against K3
     and its plain version at N=200,000).
Then one JSON line with each kernel's numbers, and the device JSON as
the last line.  Every kernel-vs-plain timing runs plain, kernel, kernel,
plain on the same inputs and reports the mean of the two of each.  The
launch counts in the JSON line come from the runs of phase 9 (K1, K3,
K4) and phase 12 (K2, K5, K6), each a new process whose counts start at
0; phase 10 resets K1's count before it serves and checks it after.
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
        check(dq < 1e-6, f"K1 {label}: quality differs by {dq}")
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
        phase("k1", f"{label} B={b}: dihedral identical to plain, 16/16 "
              f"identical to the golden; max |dquality| {dq} max |dcoeff| "
              f"{dc}; kernel {ms:.4f} ms ({b / ms * 1e3:.0f} img/s), plain "
              f"{plain_ms:.4f} ms ({b / plain_ms * 1e3:.0f} img/s), "
              f"plain/kernel {plain_ms / ms:.2f}")
        return ms, plain_ms

    batches = []
    for rows, cols in ((288, 512), (240, 320)):
        lumas = textured_lumas(gen, 256, rows, cols, dev)
        batches.append(lumas)
        l_op, r_op = pdq_torch.linear_operators(rows, cols)
        args = (lumas, torch.from_numpy(l_op)[None].to(dev),
                torch.from_numpy(r_op)[None].to(dev),
                torch.zeros(256, dtype=torch.int32, device=dev), d16)
        ms, plain_ms = compare(f"{cols}x{rows}", args, lumas.cpu().numpy(), 20)
        if rows == 288:
            result["ms"], result["plain_ms"] = ms, plain_ms

    shapes = [(288, 512), (240, 320), (512, 288), (200, 300), (333, 250),
              (64, 500), (480, 360), (97, 131)]
    mixed = [textured_lumas(gen, 1, *shapes[k % len(shapes)], "cpu")[0].numpy()
             for k in range(256)]
    planes, l_u, r_u, idx = pdq_torch.pad_mixed(mixed)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (planes, l_u, r_u, idx)) + (d16,)
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

        ei, ej, stats = hamming.find_edges_fast(base, var, low, similarity=sim,
                                                return_stats=True)
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
        if sim == 40:
            res["k3"].update(ms=k3_ms, plain_ms=k3_plain)
            res["k4"].update(ms=k4_ms, plain_ms=k4_plain)

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
    # phase k1's batches, and 512 rows x 288 columns: the self-test's
    # shape and K2's largest shared-memory setup
    tall = textured_lumas(torch.Generator().manual_seed(SEED + 2), 256, 512,
                          288, dev)
    for lumas in (*batches, tall):
        b, rows, cols = lumas.shape
        label = f"{cols}x{rows}"
        ops = pdq_hybrid.operators(rows, cols, dev)
        kc, kq = pdq_hybrid.pdq_coeffs(lumas, *ops)
        pc, pq = pdq_hybrid.pdq_coeffs_plain(lumas, *ops)
        hyb = pdq_hybrid.pdq_hash_batch_hybrid(lumas)
        l_op, r_op = pdq_torch.linear_operators(rows, cols)
        k1 = pdq_cuda.pdq_hash(lumas, torch.from_numpy(l_op)[None].to(dev),
                               torch.from_numpy(r_op)[None].to(dev),
                               torch.zeros(b, dtype=torch.int32, device=dev),
                               ops[4])
        torch.cuda.synchronize()
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
        for i in range(16):
            coeffs, _, quality = golden.pdq_from_luma(lumas_np[i])
            check([bytes(dih[i, v]) for v in range(8)]
                  == golden.dihedral_hashes(coeffs),
                  f"K2 {label}: image {i} differs from the golden")
            check(abs(float(qual[i]) - quality) <= 1e-6,
                  f"K2 {label}: image {i} quality {qual[i]} vs {quality}")
        result["max_abs_err"] = max(result["max_abs_err"], dc)
        ms, plain_ms = paired_ms(lambda: pdq_hybrid.pdq_coeffs(lumas, *ops),
                                 lambda: pdq_hybrid.pdq_coeffs_plain(lumas,
                                                                     *ops), 20)
        hyb_ms = cuda_ms(lambda: pdq_hybrid.pdq_hash_batch_hybrid(lumas), 20)
        phase("k2", f"{label} B={b}: dihedral identical to K1, 16/16 "
              f"identical to the golden; vs plain max |dquality| {dq} max "
              f"|dcoeff| {dc}; kernel {ms:.4f} ms ({b / ms * 1e3:.0f} img/s), "
              f"plain {plain_ms:.4f} ms, plain/kernel {plain_ms / ms:.2f}; "
              f"with the dihedral epilogue {hyb_ms:.4f} ms")
        if rows == 288:
            result["ms"], result["plain_ms"] = ms, plain_ms
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
            result.update(ms=ms, plain_ms=plain_ms, k3_ms=k3_ms)
    return result


def phase_k5(dev):
    import numpy as np
    import torch

    from rupphash_tpu_torch.ops import restack

    rng = np.random.default_rng(SEED)
    result = {"max_abs_err": 0.0}
    for width in (128, 256, 288):
        x = torch.from_numpy(rng.standard_normal((1, 64, 8 * width))
                             .astype(np.float32)).to(dev)
        got = restack.restack(x, width)
        want = restack.restack_plain(x, width)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K5 W={width}: differs from the plain version")
        ms, plain_ms = paired_ms(lambda: restack.restack(x, width),
                                 lambda: restack.restack_plain(x, width), 200)
        phase("k5", f"W={width}: bit-identical to plain; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if width == 288:
            result.update(ms=ms, plain_ms=plain_ms)
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


def phase_e2e():
    from rupphash_tpu_torch.ops import hamming_cuda, pdq_cuda

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        photos = Path(tmp) / "photos"
        photos.mkdir()
        t0 = time.perf_counter()
        n_files, planted = write_corpus(photos)
        phase("e2e", f"wrote {n_files} images ({len(planted)} planted groups) "
              f"in {time.perf_counter() - t0:.1f} s")
        env = {**os.environ, "RUPPHASH_DEBUG": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]),
               "RUPPHASH_CONFIG_DIR": str(Path(tmp) / "cfg"),
               "RUPPHASH_CACHE_DIR": str(Path(tmp) / "cache")}
        # the run's launch counts start at 0 in the new process; the
        # in-process counts are reset too, so nothing earlier can count
        for fn in (pdq_cuda.pdq_hash, hamming_cuda.scan_row_counts,
                   hamming_cuda.extract_rows_packed):
            fn.launches = 0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rupphash_tpu_torch", "--no-cache",
             str(photos)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exited {proc.returncode}:\n"
              f"{proc.stderr[-4000:]}")
        m = re.search(r"\[KERNELS\] (.*)", proc.stderr)
        check(m is not None, "CLI printed no [KERNELS] line")
        launches = {k: int(v) for k, v in
                    (kv.split("=") for kv in m.group(1).split())}
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
        return launches


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

        lat = np.array([t for _, _, t in serial]) * 1e3
        clat = np.array([t for _, _, t in concurrent]) * 1e3
        base_dev, st_dev, _, n, _ = ix._device_arrays()
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
        lines: list[str] = []
        ready = threading.Event()

        def read_stderr():
            for line in proc.stderr:
                lines.append(line)
                if "service at http://" in line:
                    ready.set()

        reader = threading.Thread(target=read_stderr, daemon=True)
        reader.start()
        try:
            check(ready.wait(600), "the service printed no URL:\n"
                  + "".join(lines[-40:]))
            up_s = time.perf_counter() - t0
            port = int(re.search(r"service at http://[^:]+:(\d+)/v1/",
                                 "".join(lines)).group(1))
            m = re.search(r"indexed (\d+) images \((\d+) failures\)",
                          "".join(lines))
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
            reader.join(timeout=30)
        err = "".join(lines)
        check(rc == 0, f"--serve exited {rc}:\n{err[-3000:]}")
        ix = serve.HashIndex.load(index_file)
        check(len(ix) == n_files + 1 and str(late) in ix.paths,
              f"index file holds {len(ix)} hashes, want {n_files + 1}")
        kern = re.findall(r"\[KERNELS\] (.*)", err)
        check(kern, "--serve printed no [KERNELS] line")
        launches = {k: int(v) for k, v in
                    (kv.split("=") for kv in kern[-1].split())}
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
    k5 = phase_k5(dev)
    phase_demosaic(dev)
    launches = phase_e2e()
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
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

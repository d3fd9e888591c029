#!/usr/bin/env python3
"""Smoke test of rupphash_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. environment: torch/CUDA versions, card name and power limit,
     float32 precision flags, Pillow/cryptography availability;
  2. build of the CUDA kernels from rupphash_tpu_torch/csrc;
  3. K1 (PDQ hash) against its plain PyTorch version and the numpy
     golden, at B=256 for 512x288, 320x240 and a mixed-shape batch;
  4. K3 (count sweep) and K4 (hot-row extraction) against their plain
     versions at N=100,000 hashes with planted clusters, and the edge
     search against the brute-force oracle at N=4,096;
  5. end to end: `python -m rupphash_tpu_torch --no-cache DIR` on a
     generated directory of textured images with planted duplicate
     groups; checks the printed groups and that every kernel launched.
Then one JSON line with each kernel's numbers, and the device JSON as
the last line.  Every kernel-vs-plain timing runs plain, kernel, kernel,
plain on the same inputs and reports the mean of the two of each.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
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

    for rows, cols in ((288, 512), (240, 320)):
        lumas = textured_lumas(gen, 256, rows, cols, dev)
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
    return result


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
    return res


def write_corpus(d: Path):
    """Textured images in four working shapes plus odd sizes (full
    256-batches per shape and mixed leftovers), and 60 planted groups of
    an original, a JPEG re-encode and a brightened PNG."""
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
    return len(sizes) + 2 * len(planted), planted


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
    k1 = phase_k1(dev)
    hm = phase_hamming(dev)
    launches = phase_e2e()
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
    ]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Scan orchestration: walk -> cache probe -> decode -> device hash -> group.

Port of rupphash_tpu/pipeline/scan.py (the analogue of scan_and_group,
scanner.rs:1146-1580), hashing through the port's PDQ (ops/pdq_torch.py):

  * a host pool decodes and preps luma planes (pool sized from RAM like
    init_smart_limits, scanner.rs:59-105)
  * decoded planes accumulate in *shape buckets*; each full bucket is one
    device batch for the fused PDQ kernel; leftovers go as mixed-shape
    padded batches
  * cache probing mirrors the reference tiers (scanner.rs:1202-1521):
    meta_key hit -> reuse content_hash -> reuse pdqhash/coeffs/features;
    miss -> read, EXIF, keyed content hash, decode, optional pixel hash,
    hash on the device; every product streams to the cache writer thread
  * grouping runs on the device edge search + host clustering
    (grouping/engine.py)

The cache format is the JAX package's, so either package reads the
other's cache.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import device
from ..grouping import engine
from ..ops import hamming_cuda, pdq_cuda, pdq_ref, pdq_torch
from ..utils import hashes as H
from ..utils import trace
from . import walker


@dataclasses.dataclass
class ScanConfig:
    similarity: int = engine.DEFAULT_SIMILARITY
    pixel_hash: bool = False
    rehash: bool = False
    sort: str = "name"
    batch_size: int = 256
    workers: int | None = None
    recursive: bool = True


@dataclasses.dataclass
class ScanStats:
    total: int = 0
    cache_full: int = 0
    decoded: int = 0
    failed: int = 0
    hashed: int = 0


def _default_workers() -> int:
    """RAM-aware sizing (scanner.rs:59-105): ~1.5 GiB budget per decode,
    75% of RAM, clamped to core count."""
    cores = os.cpu_count() or 4
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        ram = pages * page
    except (ValueError, OSError):
        return cores
    budget = int(ram * 0.75 / (1.5 * 2**30))
    return max(1, min(cores, budget))


def _probe_batch(files, cfg: ScanConfig, store, identities,
                 meta_refresh: list):
    """Cheap parent-side half: stat + cache probe (no decode), batched.
    Yields one result per file in order: {record, cached: True, ...} on
    a full cache hit, {record, miss: True, mkey, content} to hand to
    _heavy_one, or None on a stat failure.

    Batching structure (each a single chunked IN(...) query instead of
    a per-file execute — per-file point lookups were ~20% of the warm
    rescan): stat a chunk of files -> get_meta_many over its meta keys
    -> get_{pdqhash,features,coefficients,pixel_hash}_many over the hit
    content hashes -> per-file assembly.  The probe runs in bounded
    chunks (not the whole corpus at once) so peak RAM is O(chunk), not
    O(corpus) — at 1M files the parsed feature dicts alone would be
    ~1 GB against the README's ~2.5 GiB budget; 8192-file chunks keep
    >99% of the IN(...) batching win.  `identities` carries the
    (fid, size, mtime_ns) triples the hardlink prepass already stat()ed
    (re-statting 1M files doubles syscall load and opens a TOCTOU
    window).  Cache-hit timestamp refreshes collect into `meta_refresh`
    for chunked put_meta_many writer submissions (a handful of writer
    wakes per scan instead of one per hit; each wake is a GIL bounce,
    measured at ~24% of warm rescan time on a one-core host)."""
    files = list(files)
    for lo in range(0, len(files), _PROBE_CHUNK):
        yield from _probe_chunk(files[lo:lo + _PROBE_CHUNK], cfg, store,
                                identities, meta_refresh)


_PROBE_CHUNK = 8192
_DIHEDRAL_CHUNK = 8192


def _probe_chunk(files, cfg: ScanConfig, store, identities,
                 meta_refresh: list):
    staged = []  # (rec | None, mkey)
    for p in files:
        try:
            fid, size, mtime_ns = identities.get(p) or H.file_identity(p)
        except OSError:
            staged.append((None, None))
            continue
        rec = engine.FileRecord(path=p, size=size, modified=mtime_ns / 1e9,
                                unique_file_id=fid)
        mkey = store.compute_meta_key(mtime_ns, size, fid) if store else None
        staged.append((rec, mkey))

    metas: dict = {}
    if store and not cfg.rehash:
        metas = store.get_meta_many(
            [mk for rec, mk in staged if rec is not None])
    chs = list({metas[mk] for rec, mk in staged
                if rec is not None and mk in metas})
    pdqs = store.get_pdqhash_many(chs) if chs else {}
    feats_all = store.get_features_many(chs) if chs else {}
    coeffs_all = store.get_coefficients_many(chs) if chs else {}
    px_all = (store.get_pixel_hash_many(chs)
              if chs and cfg.pixel_hash else {})

    for rec, mkey in staged:
        if rec is None:
            yield None
            continue
        content = metas.get(mkey) if mkey is not None else None
        if content is not None:
            rec.content_hash = content
            got = pdqs.get(content)
            feats = feats_all.get(content)
            px = px_all.get(content) if cfg.pixel_hash else None
            if got and feats is not None and (not cfg.pixel_hash or px):
                trace.count("CACHE-FULL")
                trace.debug("CACHE-FULL", str(rec.path))
                pdq, quality = got
                rec.pdqhash = pdq
                rec.pdq_quality = quality
                rec.pixel_hash = px
                rec.resolution = (feats.get("width", 0),
                                  feats.get("height", 0))
                rec.orientation = feats.get("orientation", 1)
                rec.gps_pos = (tuple(feats["gps"])
                               if feats.get("gps") else None)
                rec.exif_timestamp = feats.get("exif_timestamp")
                meta_refresh.append((mkey, content))  # batched refresh
                # dihedral regen from cached coefficients happens
                # BATCHED in the caller (pdq_ref.dihedral_hashes_batch):
                # per-file packing is a Python loop that dominated
                # rescan rate
                yield {"record": rec, "luma": None, "cached": True,
                       "coeffs_cached": coeffs_all.get(content)}
                continue

        tag = "CACHE-PARTIAL" if content is not None else "CACHE-MISS"
        trace.count(tag)
        trace.debug(tag, str(rec.path))
        yield {"record": rec, "miss": True, "mkey": mkey,
               "content": content}


def _merge_heavy(rec, heavy, mkey, content, cfg, store, write_buf):
    """Fold a _heavy_one result into the record + cache (parent side).
    Cache puts append (ns, key, value) triples to write_buf — the caller
    flushes them in chunks via submit_many (one writer wake per chunk,
    not per file)."""
    rec.content_hash = heavy["content_hash"]
    if store and content is None:
        write_buf.append(store.meta_item(mkey, rec.content_hash))
    feats = heavy.get("features") or {}
    rec.orientation = feats.get("orientation", 1)
    rec.gps_pos = tuple(feats["gps"]) if feats.get("gps") else None
    rec.exif_timestamp = feats.get("exif_timestamp")
    if heavy.get("decode_failed"):
        return {"record": rec, "luma": None, "cached": False,
                "features": feats, "decode_failed": True}
    rec.resolution = heavy["res"]
    if "pixel_hash" in heavy:
        rec.pixel_hash = heavy["pixel_hash"]
        if store:
            write_buf.append(store.pixel_hash_item(rec.content_hash,
                                                   rec.pixel_hash))
    return {"record": rec, "luma": heavy["luma"], "cached": False,
            "features": feats}


def scan(paths, cfg: ScanConfig | None = None, store=None,
         progress=None, device_sink: list | None = None):
    """Scan paths, hash on device, and return
    (records: list[FileRecord], stats: ScanStats).

    device_sink (optional list): when given, the per-batch device
    dihedral tensors are retained and appended as
    ([FileRecord, ...], (B, 8, 32) u8 tensor) pairs, aligned
    row-for-row — the hashes stay on the device, so a following
    group step can match them without re-upload
    (ops.hamming.find_edges_fast_resident).  Cache hits contribute one
    uploaded batch of their host-regenerated dihedral sets."""
    cfg = cfg or ScanConfig()
    device.get()   # the card unless the CPU was pinned: raises before any work
    # Spans (utils/trace): scan.walk, scan.probe, scan.heavy, one
    # scan.device_dispatch, scan.device_drain and scan.cache_submit a
    # device batch, one scan.dihedral_regen a chunk of cache hits, and
    # scan.cache_flush.  They hold host time: device batches run
    # asynchronously beside them.
    with trace.span("scan.walk") as sp:
        files = walker.collect_files(paths, recursive=cfg.recursive)
        stats = ScanStats(total=len(files))
        workers = cfg.workers or _default_workers()

        # hardlink dedup: decode/hash one path per (dev, inode); clones
        # get their results copied afterwards (scanner.rs:1526-1540)
        fid_first: dict[int, Path] = {}
        hardlink_clones: dict[Path, Path] = {}  # clone -> representative
        identities: dict[Path, tuple] = {}      # reused by _probe_one
        scan_files = []
        for p in files:
            try:
                ident = H.file_identity(p)
            except OSError:
                continue
            if ident[0] in fid_first:
                hardlink_clones[p] = fid_first[ident[0]]
            else:
                fid_first[ident[0]] = p
                identities[p] = ident
                scan_files.append(p)
        files = scan_files
        sp.count("files", len(files))

    records: list[engine.FileRecord] = []
    buckets: dict[tuple, list] = {}   # (rows, cols) -> [(rec, luma, feats)]
    done = 0

    def apply_outputs(items, out, host, copied):
        with trace.span("scan.device_drain", files=len(items)):
            if copied is not None:
                copied.synchronize()
            # copies: records keep views of these, and the pinned
            # buffers should not live as long as the records
            dihedral = np.array(host["dihedral"])
            hashes = dihedral[:, 0, :]
            quality = np.array(host["quality"])
            coeffs = np.array(host["coeffs"])
        if device_sink is not None:
            # explicit (batch, row) stamp: the grouping engine's
            # device-resident gather routes on this, not object identity
            b = len(device_sink)
            for k, (rec, _, _) in enumerate(items):
                rec.device_slot = (b, k)
            device_sink.append(([rec for rec, _, _ in items],
                                out["dihedral"]))
        with trace.span("scan.cache_submit", files=len(items)):
            write_items = []
            for k, (rec, _, feats) in enumerate(items):
                rec.pdqhash = bytes(hashes[k])
                rec.pdq_quality = int(round(float(quality[k]) * 100))
                rec.dihedral = dihedral[k]
                stats.hashed += 1
                if store:
                    # coefficients live in the cache, not resident
                    # memory: 1 KB/file is the difference between ~1.5
                    # GiB and the reference's ~2.5 GiB budget at 1M
                    # files (README.md:12); all three puts pack into ONE
                    # writer-queue submit per device batch (per-file
                    # submits each wake the writer thread — measured
                    # ~35% of the cold host loop)
                    write_items.append(store.pdqhash_item(
                        rec.content_hash, rec.pdqhash, rec.pdq_quality))
                    write_items.append(store.coefficients_item(
                        rec.content_hash, coeffs[k]))
                    if feats is not None:
                        feats["pdq_quality"] = rec.pdq_quality
                        write_items.append(store.features_item(
                            rec.content_hash, feats))
                else:
                    rec.coeffs = coeffs[k]
            if write_items:
                store.submit_many(write_items)

    # Batches are launched asynchronously and read back with a bounded
    # window: the host decodes the next batches while the device hashes
    # and copies results back, and only the oldest batch is waited for.
    # A batch in flight holds its outputs (~0.3 MB at 256 images) on the
    # device and in pinned host memory.
    MAX_IN_FLIGHT = 8
    pending: list = []  # (items, device outputs, host outputs, copy event)

    def launch(items, out):
        # device->host copies into pinned buffers, started as soon as the
        # batch is launched and fenced by one CUDA event per batch; on
        # the CPU the outputs already are host tensors
        if out["dihedral"].device.type != "cuda":
            pending.append((items, out, out, None))
            return
        host = {}
        for k in ("dihedral", "quality", "coeffs"):
            host[k] = torch.empty(out[k].shape, dtype=out[k].dtype,
                                  pin_memory=True)
            host[k].copy_(out[k], non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        pending.append((items, out, host, copied))

    def drain(max_pending: int = 0):
        while len(pending) > max_pending:
            apply_outputs(*pending.pop(0))

    def flush_bucket(shape):
        items = buckets.pop(shape, [])
        if not items:
            return
        with trace.span("scan.device_dispatch", files=len(items)):
            lumas = np.stack([l for _, l, _ in items])
            launch(items, pdq_torch.pdq_hash_batch(lumas))
        drain(MAX_IN_FLIGHT)

    def consume(result):
        nonlocal done
        done += 1
        if progress:
            progress(done, len(files))
        if result is None:
            stats.failed += 1
            return
        rec = result["record"]
        if result.get("decode_failed"):
            stats.failed += 1
            if store and result.get("features") is not None:
                store.put_features(rec.content_hash, result["features"])
            return
        records.append(rec)
        if result["cached"]:
            stats.cache_full += 1
            return
        stats.decoded += 1
        luma = result["luma"]
        if luma is None:
            return
        shape = luma.shape
        buckets.setdefault(shape, []).append(
            (rec, luma, result.get("features")))
        if len(buckets[shape]) >= cfg.batch_size:
            flush_bucket(shape)

    # Phase 1 (parent): cheap stat + cache probes; full hits finalize
    # immediately.  Phase 2: misses fan out to worker *processes*
    # (spawned; pipeline/heavy.py imports neither jax nor torch) whose
    # results stream back through consume() so device batching overlaps
    # decode.
    content_key = store.content_key if store else None
    want_px = bool(cfg.pixel_hash)  # works store-less via zero key
    misses: list[tuple] = []
    dihedral_pending: list[tuple] = []  # (record, cached coeffs)
    meta_refresh: list[tuple] = []      # (mkey, content) hit refreshes

    def flush_dihedral():
        # one vectorized pass regenerates this chunk of cache hits'
        # dihedral sets (coefficients stay cache-resident; bounding the
        # chunk keeps peak RAM O(chunk) — 1M pending coeffs would be
        # ~1 GB plus the stacked copy)
        if not dihedral_pending:
            return
        with trace.span("scan.dihedral_regen",
                        files=len(dihedral_pending)):
            packed = pdq_ref.dihedral_hashes_batch(
                np.stack([c for _, c in dihedral_pending]))
            for k, (rec, _) in enumerate(dihedral_pending):
                rec.dihedral = packed[k]
            if device_sink is not None:
                b = len(device_sink)
                for k, (rec, _) in enumerate(dihedral_pending):
                    rec.device_slot = (b, k)
                device_sink.append(([rec for rec, _ in dihedral_pending],
                                    torch.from_numpy(packed).to(
                                        device.get())))
            dihedral_pending.clear()

    # the probe's own time is its span's less the dihedral chunks and
    # device batches inside it
    with trace.span("scan.probe", files=len(files)):
        for p, probe in zip(files, _probe_batch(files, cfg, store,
                                                identities, meta_refresh)):
            if probe is None:
                consume(None)
            elif probe.get("cached"):
                coeffs = probe.pop("coeffs_cached", None)
                if coeffs is not None:
                    dihedral_pending.append((probe["record"], coeffs))
                    if len(dihedral_pending) >= _DIHEDRAL_CHUNK:
                        flush_dihedral()
                consume(probe)
            else:
                misses.append((p, probe))
            if len(meta_refresh) >= 65536 and store:
                store.put_meta_many(meta_refresh)
                meta_refresh.clear()
        if meta_refresh and store:
            store.put_meta_many(meta_refresh)
            meta_refresh.clear()

    flush_dihedral()

    write_buf: list[tuple] = []   # (ns, key, value) from _merge_heavy

    def flush_writes():
        if write_buf and store:
            store.submit_many(write_buf)
            write_buf.clear()

    def decode_misses():
        from . import heavy as heavymod

        # where a preview-less raw is demosaiced: this process's device
        # inline and in threads; "cpu" in spawned workers, so that none
        # of them opens a CUDA context of its own
        here = str(device.get())

        def handle(probe, heavy):
            if heavy is None:
                consume(None)
            else:
                consume(_merge_heavy(probe["record"], heavy,
                                     probe["mkey"], probe["content"],
                                     cfg, store, write_buf))
            if len(write_buf) >= 4096:
                flush_writes()

        if workers <= 1:
            # single worker: a pool of one only adds future/lock churn
            # (~0.6 ms/file of GIL bounces measured on a one-core host); run
            # the heavy half inline — device batches still overlap via
            # the async dispatch window below
            for p, probe in misses:
                try:
                    heavy = heavymod.heavy_prepare(str(p), content_key,
                                                   want_px, here)
                except Exception:
                    heavy = None
                handle(probe, heavy)
        else:
            from concurrent.futures import as_completed
            use_procs = len(misses) >= 64
            if use_procs:
                import multiprocessing
                pool = ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"))
            else:
                pool = ThreadPoolExecutor(max_workers=workers)
            try:
                futs = {pool.submit(heavymod.heavy_prepare, str(p),
                                    content_key, want_px,
                                    "cpu" if use_procs else here): probe
                        for p, probe in misses}
                for fut in as_completed(futs):
                    probe = futs[fut]
                    try:
                        heavy = fut.result()
                    except Exception:
                        heavy = None
                    handle(probe, heavy)
            finally:
                pool.shutdown()
    if misses:
        # the decode of the cache misses: its own time is the span's less
        # the device batches inside it
        with trace.span("scan.heavy", files=len(misses)):
            decode_misses()
    flush_writes()

    # leftovers: full buckets already flushed inline; combine underfull
    # shape buckets into mixed-shape padded batches (one compile per
    # padded bucket instead of one per exact shape)
    leftover = [item for shape in list(buckets)
                for item in buckets.pop(shape)]
    for i in range(0, len(leftover), cfg.batch_size):
        chunk = leftover[i:i + cfg.batch_size]
        if not chunk:
            continue
        with trace.span("scan.device_dispatch", files=len(chunk)):
            if len({it[1].shape for it in chunk}) == 1:
                out = pdq_torch.pdq_hash_batch(
                    np.stack([l for _, l, _ in chunk]))
            else:
                out = pdq_torch.pdq_hash_batch_mixed(
                    [l for _, l, _ in chunk])
            launch(chunk, out)
        drain(MAX_IN_FLIGHT)
    drain(0)

    # materialize hardlink clones with the representative's results
    if hardlink_clones:
        by_path = {r.path: r for r in records}
        # clones were already counted by the walk; only the record list
        # needs the per-path copies
        clone_recs = []
        for clone, rep_path in hardlink_clones.items():
            rep = by_path.get(rep_path)
            if rep is None:
                continue
            crec = dataclasses.replace(rep, path=clone)
            records.append(crec)
            clone_recs.append(crec)
        if device_sink is not None and clone_recs:
            with_d = [r for r in clone_recs if r.dihedral is not None]
            if with_d:
                b = len(device_sink)
                for k, r in enumerate(with_d):
                    r.device_slot = (b, k)
                device_sink.append((with_d, torch.from_numpy(
                    np.stack([r.dihedral for r in with_d])).to(
                        device.get())))

    with trace.span("scan.cache_flush"):
        if store and not store.flush():
            trace.tag("CACHE-WRITE-FAILED",
                      f"cache writes not durable ({store.dropped_updates} "
                      "dropped); next scan will re-hash affected files")
    return records, stats


def scan_and_group(paths, cfg: ScanConfig | None = None, store=None,
                   progress=None):
    """Full pipeline: scan + hash + group.  Returns
    (groups, infos, records, stats) — the analogue of
    scanner::scan_and_group (scanner.rs:1146).  Phase timings go to
    stderr as [TIMING] lines (scanner.rs:1542-1559)."""
    cfg = cfg or ScanConfig()
    # retain the device-side dihedral batches the hashing stage
    # produced: on a CUDA device the group step matches them without
    # re-uploading hashes (find_edges_fast_resident)
    sink: list | None = [] if device.get().type == "cuda" else None
    with trace.Phase("scan+hash") as ph:
        records, stats = scan(paths, cfg, store, progress,
                              device_sink=sink)
        ph.add(stats.total)
    with trace.Phase("group") as pg:
        groups, infos, edges = engine.group_files(
            records, similarity=cfg.similarity, sort_order=cfg.sort,
            device_batches=sink)
        pg.add(len(records))
    if stats.cache_full or stats.decoded:
        trace.tag("CACHE", f"full={stats.cache_full} "
                           f"decoded={stats.decoded} "
                           f"failed={stats.failed}")
    trace.debug("SCAN", f"cache counters: {trace.counters()}")
    trace.debug("KERNELS", kernel_counts())
    return groups, infos, records, stats


def kernel_counts() -> str:
    """The scan route's kernel launch counts, as the [KERNELS] line
    prints them."""
    return " ".join(f"{k}={v}" for k, v in (
        ("pdq_hash_kernel", pdq_cuda.pdq_hash.launches),
        ("hamming_rowcount_kernel", hamming_cuda.scan_row_counts.launches),
        ("hamming_extract_kernel",
         hamming_cuda.extract_rows_packed.launches)))

"""View-mode streaming scan + background enrichment.

Mirrors the reference's viewer data plane (scanner.rs:2291-2748):

  phase 1 (sync):    list the directory (or flatten recursively), build
                     FileRecords with cached features via batched cache
                     lookups, sort, and stream them out in batches so an
                     unbounded directory renders with constant memory
                     (batch channels of 100/500 files,
                     scanner.rs:2349-2421).
  phase 2 (thread):  enrichment — for files without cached features,
                     read + content-hash + EXIF + derived values, stream
                     results back and persist them to the cache
                     (spawn_background_enrichment, scanner.rs:2566-2731).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

from ..grouping import engine
from ..utils import hashes as H
from . import exif, walker

BATCH = 100  # streaming batch size (scanner.rs:2349)


def list_view(paths, recursive: bool = False, sort: str = "name",
              store=None):
    """Phase 1: FileRecords with whatever the cache already knows.
    Returns (records, subdirs)."""
    records: list[engine.FileRecord] = []
    subdirs: list[Path] = []
    for root in paths:
        root = Path(root)
        if root.is_dir() and not recursive:
            for child in sorted(root.iterdir()):
                if child.is_dir():
                    subdirs.append(child)
    files = walker.collect_files(paths, recursive=recursive)
    for p in files:
        try:
            fid, size, mtime_ns = H.file_identity(p)
        except OSError:
            continue
        rec = engine.FileRecord(path=p, size=size, modified=mtime_ns / 1e9,
                                unique_file_id=fid)
        if store is not None:
            mkey = store.compute_meta_key(mtime_ns, size, fid)
            ch = store.get_meta(mkey)
            if ch:
                rec.content_hash = ch
                feats = store.get_features(ch)
                if feats:
                    rec.resolution = (feats.get("width", 0),
                                      feats.get("height", 0))
                    rec.orientation = feats.get("orientation", 1)
                    rec.gps_pos = (tuple(feats["gps"])
                                   if feats.get("gps") else None)
                    rec.exif_timestamp = feats.get("exif_timestamp")
                got = store.get_pdqhash(ch)
                if got:
                    rec.pdqhash, rec.pdq_quality = got
        records.append(rec)
    engine.sort_files(records, sort)
    return records, subdirs


def stream_batches(records, batch: int = BATCH):
    for i in range(0, len(records), batch):
        yield records[i:i + batch]


class Enrichment:
    """Phase 2: background thread filling in missing features.

    Consumers observe the in-place FileRecord mutations (the GUI/TUI
    snapshot path); .results additionally carries (path, features)
    tuples for tests and tooling, BOUNDED so an unconsumed queue never
    holds a large session's worth of feature dicts in memory (entries
    beyond the bound are silently dropped — the records themselves are
    already updated).  Cache writes stream through the store's writer
    thread.
    """

    def __init__(self, records, store=None, workers: int = 4):
        self.records = [r for r in records if r.resolution is None]
        self.store = store
        self.results: queue.Queue = queue.Queue(maxsize=4096)
        self._threads: list[threading.Thread] = []
        self._work: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.workers = workers

    def start(self):
        for r in self.records:
            self._work.put(r)
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"enrich-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            try:
                rec = self._work.get_nowait()
            except queue.Empty:
                return
            try:
                data = rec.path.read_bytes()
            except OSError:
                self._emit(rec.path, None)
                continue
            if self.store is not None and not rec.content_hash:
                rec.content_hash = H.content_hash(self.store.content_key,
                                                  data)
                try:
                    # the file can vanish between read and stat (the
                    # watcher's external-deletion scenario) — an
                    # uncaught OSError here killed the worker thread
                    _, size, mtime_ns = H.file_identity(rec.path)
                except OSError:
                    self._emit(rec.path, None)
                    continue
                mkey = self.store.compute_meta_key(
                    mtime_ns, size, rec.unique_file_id)
                self.store.put_meta(mkey, rec.content_hash)
            feats = exif.extract(rec.path, data=data)
            rec.resolution = (feats.get("width", 0), feats.get("height", 0))
            rec.orientation = feats.get("orientation", 1)
            rec.gps_pos = tuple(feats["gps"]) if feats.get("gps") else None
            rec.exif_timestamp = feats.get("exif_timestamp")
            sun = exif.derive_sun_position(feats)
            if sun:
                feats["sun_azimuth"] = sun["sun_azimuth"]
                feats["sun_altitude"] = sun["sun_altitude"]
            loc = exif.derive_location(feats)
            for k in ("country", "subdivision", "timezone"):
                if loc.get(k):
                    feats[k] = loc[k]
            if self.store is not None and rec.content_hash:
                self.store.put_features(rec.content_hash, feats)
            self._emit(rec.path, feats)

    def _emit(self, path, feats):
        try:
            self.results.put_nowait((path, feats))
        except queue.Full:
            pass  # bounded: record mutations are the primary channel

    def join(self, timeout: float | None = None):
        for t in self._threads:
            t.join(timeout)

    def stop(self):
        self._stop.set()

"""Encrypted incremental scan cache (the checkpoint/resume subsystem).

Re-creates the reference's LMDB cache semantics (src/db.rs) on SQLite
(WAL mode; the C library underneath python's sqlite3).  LMDB itself is
not available in this image; SQLite provides the same crash-safe,
single-file, memory-mapped KV role.  Schema concepts are kept 1:1:

  7 namespaces (db.rs:24-30,587-594):
    hash        content_hash -> version byte + PDQ hash + quality
    meta        blinded meta_key -> content_hash || u64 timestamp
    features    content_hash -> JSON image features
    coeffs      content_hash -> version byte + 256 f32 DCT coefficients
    pixelhash   content_hash -> 32-byte pixel hash
    ignored     content_hash -> IgnoredEntry (pdqhash, group uuid, ts, flag)
    pdqmap      pdqhash -> 16-byte group uuid (stable across runs)

  crypto (db.rs:521-673): blake2b-derived content/meta/encryption keys;
  every value XChaCha20-Poly1305-encrypted with random 24-byte nonce and
  AAD = the cache key, blocking value-swap attacks.

  versioning (db.rs:32-47): PDQ_ALGO_VERSION leading byte invalidates
  stale hash/coeff entries on algorithm change.

  async writer (db.rs:1004-1240): a dedicated thread consumes updates
  from a queue, flushing one transaction per second or per 1000 items,
  dropping (cache is recomputable) beyond a 16000-entry backlog.

  pruning (db.rs:892-1002): drop meta entries older than a cutoff, then
  mark-and-sweep orphaned hash/feature/coeff/pixel entries.
"""

from __future__ import annotations

import json
import os
import queue
import sqlite3
import struct
import threading
import time
import uuid as uuid_mod
from pathlib import Path

import numpy as np

from .. import PDQ_ALGO_VERSION
from ..utils import hashes as H
from . import crypto

NS_HASH = 1
NS_META = 2
NS_FEATURES = 3
NS_COEFFS = 4
NS_PIXELHASH = 5
NS_IGNORED = 6
NS_PDQMAP = 7

FLUSH_INTERVAL_S = 1.0     # db.rs flush cadence
FLUSH_BATCH = 1000
MAX_BACKLOG = 16000        # db.rs:1138 hard cap, then drop


class IgnoredEntry:
    __slots__ = ("pdqhash", "group_uuid", "timestamp", "ignored")

    def __init__(self, pdqhash: bytes | None, group_uuid: bytes,
                 timestamp: int, ignored: bool):
        self.pdqhash = pdqhash
        self.group_uuid = group_uuid
        self.timestamp = timestamp
        self.ignored = ignored

    def to_bytes(self) -> bytes:
        ph = self.pdqhash or b"\x00" * 32
        return (bytes([1 if self.pdqhash else 0]) + ph + self.group_uuid
                + struct.pack("<Q", self.timestamp)
                + bytes([1 if self.ignored else 0]))

    @classmethod
    def from_bytes(cls, b: bytes) -> "IgnoredEntry":
        has_pdq = b[0] == 1
        ph = b[1:33] if has_pdq else None
        gu = b[33:49]
        ts = struct.unpack("<Q", b[49:57])[0]
        return cls(ph, gu, ts, b[57] == 1)


class CacheStore:
    """Thread-safe encrypted KV cache with an async batched writer."""

    def __init__(self, path: str | os.PathLike, master_key: bytes,
                 start_writer: bool = True):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.content_key = H.derive_key(master_key, "phdupes content v1")
        self.meta_key = H.derive_key(master_key, "phdupes meta v1")
        self.enc_key = H.derive_key(master_key, "phdupes encrypt v1")
        self._local = threading.local()
        for attempt in (0, 1):
            try:
                con = self._conn()
                con.execute("CREATE TABLE IF NOT EXISTS kv ("
                            "ns INTEGER NOT NULL, k BLOB NOT NULL, "
                            "v BLOB NOT NULL, "
                            "PRIMARY KEY (ns, k)) WITHOUT ROWID")
                con.commit()
                break
            except sqlite3.DatabaseError as e:
                # Only *corruption* is recoverable by recreating (the
                # cache is recomputable; reference policy db.rs:685-693).
                # Transient OperationalError (locked/disk-full/readonly)
                # must surface, not destroy a healthy shared cache.
                msg = str(e).lower()
                corrupt = ("not a database" in msg
                           or "malformed" in msg
                           or "file is encrypted" in msg)
                if attempt == 1 or not corrupt:
                    raise
                try:
                    con = getattr(self._local, "con", None)
                    if con is not None:
                        con.close()
                except sqlite3.Error:
                    pass
                self._local = threading.local()
                for suffix in ("", "-wal", "-shm"):
                    try:
                        os.unlink(f"{self.path}{suffix}")
                    except OSError:
                        pass
        self._q: queue.Queue | None = None
        self._writer: threading.Thread | None = None
        self._stop = threading.Event()
        self.dropped_updates = 0
        self._dropped_at_last_flush = 0
        self.writer_failed = False
        if start_writer:
            self.start_writer()

    # -- connection handling ------------------------------------------------
    def _conn(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self.path, timeout=30.0)
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            self._local.con = con
        return con

    # -- raw encrypted KV ---------------------------------------------------
    def _put_now(self, ns: int, key: bytes, value: bytes,
                 con: sqlite3.Connection | None = None):
        blob = crypto.encrypt(self.enc_key, value, key)
        c = con or self._conn()
        c.execute("INSERT OR REPLACE INTO kv (ns, k, v) VALUES (?, ?, ?)",
                  (ns, key, blob))
        if con is None:
            c.commit()

    def _get(self, ns: int, key: bytes) -> bytes | None:
        row = self._conn().execute(
            "SELECT v FROM kv WHERE ns = ? AND k = ?", (ns, key)).fetchone()
        if row is None:
            return None
        try:
            return crypto.decrypt(self.enc_key, row[0], key)
        except Exception:
            return None  # corrupt/tampered value == cache miss (db.rs:685)

    def _get_many(self, ns: int, keys) -> dict[bytes, bytes]:
        """Batched point lookups: one IN(...) query per chunk instead of
        one execute per key.  A warm rescan probes 4 namespaces per file;
        per-file executes were ~20% of the probe loop at 1M files.
        Undecryptable values are dropped (== cache miss, db.rs:685)."""
        out: dict[bytes, bytes] = {}
        if not keys:
            return out
        con = self._conn()
        uniq = list(dict.fromkeys(keys))
        CHUNK = 500  # stay clear of SQLITE_MAX_VARIABLE_NUMBER
        for i in range(0, len(uniq), CHUNK):
            chunk = uniq[i:i + CHUNK]
            rows = con.execute(
                "SELECT k, v FROM kv WHERE ns = ? AND k IN (%s)"
                % ",".join("?" * len(chunk)), [ns, *chunk])
            for k, vv in rows:
                kb = bytes(k)
                try:
                    out[kb] = crypto.decrypt(self.enc_key, vv, kb)
                except Exception:
                    continue
        return out

    def _delete(self, ns: int, key: bytes, con=None):
        c = con or self._conn()
        c.execute("DELETE FROM kv WHERE ns = ? AND k = ?", (ns, key))
        if con is None:
            c.commit()

    def _iter_ns(self, ns: int):
        for k, vv in self._conn().execute(
                "SELECT k, v FROM kv WHERE ns = ?", (ns,)):
            try:
                yield bytes(k), crypto.decrypt(self.enc_key, vv, bytes(k))
            except Exception:
                continue

    # -- async writer (db.rs:1004-1240) --------------------------------------
    def start_writer(self):
        if self._writer is not None:
            return
        self._q = queue.Queue()
        self._stop.clear()
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="cache-writer", daemon=True)
        self._writer.start()

    def submit(self, ns: int, key: bytes, value: bytes):
        """Queue an update for the writer thread; drops beyond the backlog
        cap (the cache is recomputable, db.rs:1138-1156)."""
        if self._q is None:
            self._put_now(ns, key, value)
            return
        if self._q.qsize() >= MAX_BACKLOG:
            self.dropped_updates += 1
            return
        self._q.put((ns, key, value))

    def submit_many(self, items: list[tuple[int, bytes, bytes]]):
        """Queue a batch as ONE writer-queue interaction.  A warm rescan
        refreshes one meta timestamp per cache hit; per-item puts wake
        the writer thread per file (on a 1-core host each wake is a GIL
        bounce that dominates the probe loop — measured ~24% of warm
        rescan time), so hot loops batch their refreshes here."""
        if not items:
            return
        if self._q is None:
            con = self._conn()
            for ns, key, value in items:
                self._put_now(ns, key, value, con=con)
            con.commit()
            return
        if self._q.qsize() >= MAX_BACKLOG:
            self.dropped_updates += len(items)
            return
        self._q.put(("MANY", list(items)))

    def _writer_loop(self):
        con = sqlite3.connect(self.path, timeout=30.0)
        con.execute("PRAGMA journal_mode=WAL")
        buf: list[tuple[int, bytes, bytes]] = []
        flush_events: list[threading.Event] = []
        last_flush = time.monotonic()

        def write_out():
            nonlocal last_flush
            try:
                with con:
                    con.executemany(
                        "INSERT OR REPLACE INTO kv (ns, k, v) "
                        "VALUES (?, ?, ?)",
                        [(ns, k, crypto.encrypt(self.enc_key, v, k))
                         for ns, k, v in buf])
                buf.clear()
                self.writer_failed = False
            except sqlite3.Error:
                # transaction failed (disk full, locked, ...): keep the
                # buffer for retry but make the failure OBSERVABLE —
                # flush() waiters must not believe data is durable
                self.writer_failed = True
                if len(buf) > MAX_BACKLOG:
                    self.dropped_updates += len(buf)
                    buf.clear()
            last_flush = time.monotonic()
            for ev in flush_events:
                ev.set()
            flush_events.clear()

        while True:
            timeout = max(0.05, FLUSH_INTERVAL_S - (time.monotonic() - last_flush))
            try:
                item = self._q.get(timeout=timeout)
                if item[0] == "FLUSH":
                    flush_events.append(item[1])
                elif item[0] == "MANY":
                    buf.extend(item[1])
                else:
                    buf.append(item)
            except queue.Empty:
                pass
            now = time.monotonic()
            stopping = self._stop.is_set() and self._q.empty()
            if (buf or flush_events) and (
                    len(buf) >= FLUSH_BATCH or flush_events
                    or now - last_flush >= FLUSH_INTERVAL_S or stopping):
                write_out()
            if stopping and not buf:
                con.close()
                return

    def flush(self) -> bool:
        """Block until all previously queued writes have been attempted;
        returns False when the flush cycle left data undurable (failed
        transaction or dropped backlog) so callers can warn the user
        instead of silently losing a scan's worth of cache entries."""
        if self._q is None:
            return True
        ev = threading.Event()
        self._q.put(("FLUSH", ev))
        completed = ev.wait(timeout=30)
        # Only drops since the previous flush count against this one —
        # dropped_updates is a lifetime counter, and one historic backlog
        # overflow must not mark every later (healthy) flush as failed.
        # Drops happen in submit() during the scan, so the epoch marker is
        # taken at the end of each flush, not at its start.  A wedged
        # writer (ev never set within the timeout) is itself a failure.
        dropped_since = self.dropped_updates - self._dropped_at_last_flush
        self._dropped_at_last_flush = self.dropped_updates
        return completed and not (self.writer_failed or dropped_since)

    def close(self):
        if self._writer is not None:
            self._stop.set()
            self._writer.join(timeout=10)
            self._writer = None
            self._q = None

    # -- typed accessors (db.rs:678-803) --------------------------------------
    def compute_meta_key(self, mtime_ns: int, size: int, file_id: int) -> bytes:
        return H.meta_key(self.meta_key, mtime_ns, size, file_id)

    def put_meta(self, mkey: bytes, content_hash: bytes, now: int | None = None):
        self.submit(*self.meta_item(mkey, content_hash, now))

    def put_meta_many(self, pairs, now: int | None = None):
        """Batched put_meta: [(mkey, content_hash), ...] as one queue
        interaction (see submit_many)."""
        ts = now if now is not None else int(time.time())
        packed = struct.pack("<Q", ts)
        self.submit_many([(NS_META, mkey, ch + packed)
                          for mkey, ch in pairs])

    def get_meta(self, mkey: bytes) -> bytes | None:
        """meta_key -> content_hash (refreshing the timestamp is the
        caller's job via put_meta, scanner.rs:1234-1236)."""
        v = self._get(NS_META, mkey)
        return v[:32] if v and len(v) >= 40 else None

    def get_meta_many(self, mkeys) -> dict[bytes, bytes]:
        """Batched get_meta: {mkey: content_hash} for present keys."""
        return {k: v[:32] for k, v in self._get_many(NS_META, mkeys).items()
                if len(v) >= 40}

    def get_pdqhash_many(self, content_hashes) -> dict:
        """Batched get_pdqhash: {content_hash: (pdq, quality)}."""
        out = {}
        for k, v in self._get_many(NS_HASH, content_hashes).items():
            if v and v[0] == PDQ_ALGO_VERSION and len(v) >= 35:
                out[k] = (v[1:33], struct.unpack("<H", v[33:35])[0])
        return out

    def get_features_many(self, content_hashes) -> dict:
        out = {}
        for k, v in self._get_many(NS_FEATURES, content_hashes).items():
            try:
                out[k] = json.loads(v)
            except ValueError:
                continue
        return out

    def get_coefficients_many(self, content_hashes) -> dict:
        out = {}
        for k, v in self._get_many(NS_COEFFS, content_hashes).items():
            if v and v[0] == PDQ_ALGO_VERSION and len(v) == 1 + 256 * 4:
                out[k] = np.frombuffer(v[1:], dtype=np.float32).copy()
        return out

    def get_pixel_hash_many(self, content_hashes) -> dict:
        return self._get_many(NS_PIXELHASH, content_hashes)

    # -- batched item packers -------------------------------------------------
    # Build (ns, key, value) triples for submit_many: the async writer
    # costs one queue interaction (= one writer-thread wake, a GIL
    # bounce on a 1-core host) per submit, so hot loops pack a batch of
    # typed puts into ONE submit_many call.  Measured on the cold scan:
    # 3 per-file submits (hash+coeffs+features) were ~35% of the host
    # loop; batching them per device batch removed that entirely.
    def meta_item(self, mkey: bytes, content_hash: bytes,
                  now: int | None = None):
        ts = now if now is not None else int(time.time())
        return (NS_META, mkey, content_hash + struct.pack("<Q", ts))

    def pdqhash_item(self, content_hash: bytes, pdq: bytes, quality: int):
        return (NS_HASH, content_hash,
                bytes([PDQ_ALGO_VERSION]) + pdq + struct.pack("<H", quality))

    def coefficients_item(self, content_hash: bytes, coeffs: np.ndarray):
        return (NS_COEFFS, content_hash,
                bytes([PDQ_ALGO_VERSION])
                + np.asarray(coeffs, dtype=np.float32).tobytes())

    def features_item(self, content_hash: bytes, features: dict):
        return (NS_FEATURES, content_hash,
                json.dumps(features, separators=(",", ":")).encode())

    def pixel_hash_item(self, content_hash: bytes, pixel_hash: bytes):
        return (NS_PIXELHASH, content_hash, pixel_hash)

    def put_pdqhash(self, content_hash: bytes, pdq: bytes, quality: int):
        self.submit(*self.pdqhash_item(content_hash, pdq, quality))

    def get_pdqhash(self, content_hash: bytes):
        v = self._get(NS_HASH, content_hash)
        if not v or v[0] != PDQ_ALGO_VERSION or len(v) < 35:
            return None  # version mismatch == miss (db.rs:685-693)
        return v[1:33], struct.unpack("<H", v[33:35])[0]

    def put_coefficients(self, content_hash: bytes, coeffs: np.ndarray):
        self.submit(*self.coefficients_item(content_hash, coeffs))

    def get_coefficients(self, content_hash: bytes) -> np.ndarray | None:
        v = self._get(NS_COEFFS, content_hash)
        if not v or v[0] != PDQ_ALGO_VERSION or len(v) != 1 + 256 * 4:
            return None
        return np.frombuffer(v[1:], dtype=np.float32).copy()

    def put_features(self, content_hash: bytes, features: dict):
        self.submit(*self.features_item(content_hash, features))

    def get_features(self, content_hash: bytes) -> dict | None:
        v = self._get(NS_FEATURES, content_hash)
        if not v:
            return None
        try:
            return json.loads(v)
        except ValueError:
            return None

    def put_pixel_hash(self, content_hash: bytes, pixel_hash: bytes):
        self.submit(*self.pixel_hash_item(content_hash, pixel_hash))

    def get_pixel_hash(self, content_hash: bytes) -> bytes | None:
        return self._get(NS_PIXELHASH, content_hash)

    # -- ignore / registration API (db.rs:1277-1591) ---------------------------
    def register_duplicate_groups(self, groups) -> int:
        """groups: iterable of [(content_hash, pdqhash|None), ...].  Each
        member gets an entry with ignored=False; existing ignored=True
        entries are preserved; the group uuid is reused from the pdqmap
        when any member's pdqhash is known (db.rs:1342-1403)."""
        now = int(time.time())
        total = 0
        con = self._conn()
        for group in groups:
            if not group:
                continue
            pdqs = [p for _, p in group if p]
            guid = None
            for p in pdqs:
                v = self._get(NS_PDQMAP, p)
                if v and len(v) == 16:
                    guid = v
                    break
            if guid is None:
                guid = uuid_mod.uuid4().bytes
            for ch, p in group:
                existing = self._get(NS_IGNORED, ch)
                if existing:
                    e = IgnoredEntry.from_bytes(existing)
                    if e.ignored:
                        continue
                entry = IgnoredEntry(p, guid, now, False)
                self._put_now(NS_IGNORED, ch, entry.to_bytes(), con)
                total += 1
            for p in pdqs:
                self._put_now(NS_PDQMAP, p, guid, con)
        con.commit()
        return total

    def set_files_ignored(self, content_hashes) -> int:
        count = 0
        con = self._conn()
        for ch in content_hashes:
            v = self._get(NS_IGNORED, ch)
            if not v:
                continue
            e = IgnoredEntry.from_bytes(v)
            if not e.ignored:
                e.ignored = True
                self._put_now(NS_IGNORED, ch, e.to_bytes(), con)
                count += 1
        con.commit()
        return count

    def is_ignored(self, content_hash: bytes) -> bool:
        v = self._get(NS_IGNORED, content_hash)
        return bool(v) and IgnoredEntry.from_bytes(v).ignored

    def get_group_uuid(self, content_hash: bytes) -> bytes | None:
        v = self._get(NS_IGNORED, content_hash)
        return IgnoredEntry.from_bytes(v).group_uuid if v else None

    def list_ignored(self):
        """[(content_hash, IgnoredEntry)] for entries with the flag set."""
        out = []
        for k, v in self._iter_ns(NS_IGNORED):
            e = IgnoredEntry.from_bytes(v)
            if e.ignored:
                out.append((k, e))
        return out

    def unignore(self, *, content_hash: bytes | None = None,
                 group_uuid: bytes | None = None,
                 pdqhash: bytes | None = None) -> int:
        """Clear ignore flags by content hash, group uuid, or pdq hash
        (db.rs:1436-1591 / --unignore)."""
        count = 0
        con = self._conn()
        for k, v in list(self._iter_ns(NS_IGNORED)):
            e = IgnoredEntry.from_bytes(v)
            if not e.ignored:
                continue
            match = ((content_hash is not None and k == content_hash)
                     or (group_uuid is not None and e.group_uuid == group_uuid)
                     or (pdqhash is not None and e.pdqhash == pdqhash))
            if match:
                e.ignored = False
                self._put_now(NS_IGNORED, k, e.to_bytes(), con)
                count += 1
        con.commit()
        return count

    # -- pruning (db.rs:892-1002) ----------------------------------------------
    def prune(self, max_age_s: int) -> dict:
        """Drop meta entries older than the cutoff, then sweep orphaned
        hash/feature/coeff/pixel entries no meta record points to."""
        cutoff = int(time.time()) - max_age_s
        con = self._conn()
        live: set[bytes] = set()
        dropped_meta = 0
        for k, v in list(self._iter_ns(NS_META)):
            if len(v) < 40:
                continue
            ts = struct.unpack("<Q", v[32:40])[0]
            if ts < cutoff:
                self._delete(NS_META, k, con)
                dropped_meta += 1
            else:
                live.add(v[:32])
        swept = 0
        for ns in (NS_HASH, NS_FEATURES, NS_COEFFS, NS_PIXELHASH):
            for k, _ in list(self._iter_ns(ns)):
                if k not in live:
                    self._delete(ns, k, con)
                    swept += 1
        con.commit()
        con.execute("VACUUM")
        return {"dropped_meta": dropped_meta, "swept_orphans": swept}

    def stats(self) -> dict:
        rows = self._conn().execute(
            "SELECT ns, COUNT(*) FROM kv GROUP BY ns").fetchall()
        names = {NS_HASH: "hash", NS_META: "meta", NS_FEATURES: "features",
                 NS_COEFFS: "coeffs", NS_PIXELHASH: "pixelhash",
                 NS_IGNORED: "ignored", NS_PDQMAP: "pdqmap"}
        return {names.get(ns, str(ns)): c for ns, c in rows}

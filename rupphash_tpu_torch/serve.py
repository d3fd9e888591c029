"""Near-duplicate lookup service: persistent hash index + device query path.

Counterpart of rupphash_tpu/serve.py.  The corpus's packed hashes stay
resident on the port's device, padded to a capacity; a query batch of
(Q, V, nbytes) dihedral variants is one +/-1 float32 matmul against the
corpus (exact for |dot| <= 256), min over the variants, the quality
gate and a top-k selection on the device, so only O(Q x k) results come
back.  Incoming images are decoded on the host (RAW bodies demosaiced
on the device, pipeline/decode.py) and hashed by K1 (ops/pdq_cuda.py),
one image per request.

Surfaces, as the reference's:
  * library  - HashIndex (build/save/load/add/remove) + NearDupService
  * HTTP     - POST /v1/query (raw image bytes) -> JSON matches,
               POST /v1/add?path=... -> index insert,
               POST /v1/remove?path=... -> index delete,
               GET  /v1/stats
  * CLI      - `python -m rupphash_tpu_torch --serve DIR [--port N]`

Low-quality corpus entries only match at distance 0, the scanner's
gating rule (scanner.rs:1588-1594); removed entries are tombstones
until compaction.  Index files are the reference's `.npz` format, so
either package loads the other's.  With a mesh (parallel/sharded.py)
the corpus is split over its devices, each device answers for its
shard and the first merges their top-k; --serve takes one when more
than one card is visible.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import device
from .ops import hamming, pdq_torch
from .parallel import sharded
from .pipeline import decode
from .pipeline.decode import prepare_luma_fast
from .utils import netguard, trace

PDQ_MIN_QUALITY = 50

# device-resident per-row status codes (int8): OK matches normally, LOW
# only matches at distance 0, DEAD never matches (tombstoned by
# remove(); reclaimed by compaction)
STATUS_OK, STATUS_LOW, STATUS_DEAD = 0, 1, 2

# host->device upload accounting: every host array this module moves to
# the device goes through _upload, so tests can assert that add/remove
# traffic is O(delta), never O(corpus).  Lock-guarded: HashIndex allows
# concurrent mutation threads.
UPLOAD_BYTES = 0
_UPLOAD_LOCK = threading.Lock()


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    global UPLOAD_BYTES
    x = np.ascontiguousarray(x)
    with _UPLOAD_LOCK:
        UPLOAD_BYTES += x.nbytes
    return torch.from_numpy(x).to(dev)


def _query_min_dists(q_packed, base_packed, base_status, nbits):
    """(Q, V, nbytes) u8 query variants vs (N, nbytes) u8 base -> (Q, N)
    int32 min-over-variant Hamming distance; low-quality base rows report
    nbits+1 unless the distance is exactly 0, dead rows always nbits+1."""
    q, v, _ = q_packed.shape
    qv = hamming.unpack_bits_pm1(q_packed).reshape(q * v, nbits).float()
    base = hamming.unpack_bits_pm1(base_packed).float()
    dots = torch.matmul(qv, base.T).reshape(q, v, -1).amax(dim=1)
    dist = (nbits - dots.to(torch.int32)) // 2
    low = base_status[None, :] == STATUS_LOW
    dead = base_status[None, :] >= STATUS_DEAD
    return torch.where(dead | (low & (dist > 0)), nbits + 1, dist)


def _dev_write_rows(base, status, rows, strows, start):
    """A new version with a contiguous row block written at `start`.
    Writes into clones, so a snapshot a running query captured stays
    valid; the clone is a device-to-device copy, and the only upload is
    the new rows themselves."""
    base, status = base.clone(), status.clone()
    base[start:start + len(rows)] = rows
    status[start:start + len(strows)] = strows
    return base, status


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, sharded.Mesh):
        raise TypeError("mesh must be a rupphash_tpu_torch.parallel.sharded."
                        f"Mesh (make_mesh()), got {type(mesh).__name__}")


def _dev_kill_rows(status, idx):
    """A new version of `status` with rows tombstoned by index (idx padded
    with out-of-range values, which are dropped)."""
    status = status.clone()
    status[idx[idx < len(status)].long()] = STATUS_DEAD
    return status


def _query_topk(q_packed, base_packed, base_status, n_total, nbits, k):
    """Device-side selection of the k best (distance, corpus index) pairs
    per query.  Rows past n_total (padding) report nbits+1.  Distance
    ties resolve to the lower corpus index, as lax.top_k does in the
    reference: the selection key distance * cap + index is unique."""
    gated = _query_min_dists(q_packed, base_packed, base_status, nbits)
    cap = gated.shape[1]
    col = torch.arange(cap, device=gated.device)
    gated = torch.where(col[None, :] >= n_total, nbits + 1, gated)
    key = gated.to(torch.int64) * cap + col[None, :]
    best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return best // cap, best % cap


class HashIndex:
    """Persistent (hashes, quality, paths) corpus index.

    Device residency is incremental: the packed corpus is pushed once
    (padded to a capacity), then add() appends rows into the spare
    capacity (uploading only the new rows) and remove() tombstones rows
    via a status write (uploading only the indices).  A full re-push
    happens only on first use, capacity growth (amortized O(1) via
    doubling), compaction (when >50% of slots are dead), or a query on
    another mesh than the last.  Device updates build new tensors, so an
    in-flight query's captured snapshot stays valid while a mutation
    builds the next version.  The one-device residency and the mesh's
    (one shard a device, capacity a multiple of 8 x the device count)
    are kept apart, each with its own incremental state.  Host slots are
    append-only between compactions, so a snapshot's (arrays, paths-list,
    n) triple never tears under concurrent mutation.
    """

    def __init__(self, nbytes: int = 32):
        self.nbytes = nbytes
        self.device = device.get()
        self._hashes = np.zeros((0, nbytes), dtype=np.uint8)
        self._quality = np.zeros(0, dtype=np.int32)
        self._dead = np.zeros(0, dtype=bool)
        self._paths: list[str] = []   # slot-aligned; tombstones keep slot
        self._n = 0                   # slots in use (incl. dead)
        self._n_dead = 0
        # device state, on the index's device or over the mesh it was
        # pushed for (rebuilt when a query names another): {"shards"
        # [(hashes, status) tensors], "mesh" (None: one device), "cap",
        # "applied", "paths" (the slot list object at push time),
        # "pending_dead", "rank", "rank_n"}
        self._dev = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ size
    def __len__(self) -> int:
        return self._n - self._n_dead

    @property
    def _live_mask(self) -> np.ndarray:
        return ~self._dead[:self._n]

    @property
    def hashes(self) -> np.ndarray:
        """Live (non-tombstoned) hashes, compacted."""
        return self._hashes[:self._n][self._live_mask]

    @property
    def quality(self) -> np.ndarray:
        return self._quality[:self._n][self._live_mask]

    @property
    def paths(self) -> list[str]:
        """Live paths, compacted (aligned with .hashes/.quality)."""
        m = self._live_mask
        return [p for i, p in enumerate(self._paths[:self._n]) if m[i]]

    # ----------------------------------------------------------- build
    def add(self, path: str, pdqhash: bytes | np.ndarray,
            quality: int | None = None):
        h = np.frombuffer(bytes(pdqhash), dtype=np.uint8)
        if h.size != self.nbytes:
            raise ValueError(f"hash must be {self.nbytes} bytes")
        with self._lock:
            if self._n == len(self._hashes):
                grow = max(1024, len(self._hashes))
                self._hashes = np.concatenate(
                    [self._hashes, np.zeros((grow, self.nbytes), np.uint8)])
                self._quality = np.concatenate(
                    [self._quality, np.zeros(grow, np.int32)])
                self._dead = np.concatenate([self._dead, np.zeros(grow, bool)])
            self._hashes[self._n] = h
            self._quality[self._n] = 100 if quality is None else quality
            self._dead[self._n] = False
            self._paths.append(str(path))
            self._n += 1
            # device state stays valid: the new row syncs as an O(1)
            # append at the next query (_device_arrays)

    def remove(self, path: str) -> int:
        """Tombstone every entry whose path matches; returns count.
        Slots are reclaimed by compaction once >50% are dead."""
        path = str(path)
        with self._lock:
            removed = 0
            dev = self._dev
            for i in range(self._n):
                if self._paths[i] == path and not self._dead[i]:
                    self._dead[i] = True
                    self._n_dead += 1
                    removed += 1
                    if dev is not None and i < dev["applied"]:
                        dev["pending_dead"].append(i)
            return removed

    def _compact_locked(self):
        """Rebuild host arrays to live rows (lock held).  Builds a NEW
        paths list object so snapshots captured against the old slot
        layout keep indexing the old (immutable-from-now-on) list."""
        keep = np.flatnonzero(self._live_mask)
        self._hashes = self._hashes[:self._n][keep].copy()
        self._quality = self._quality[:self._n][keep].copy()
        self._dead = np.zeros(len(keep), dtype=bool)
        self._paths = [self._paths[i] for i in keep]
        self._n = len(keep)
        self._n_dead = 0
        self._dev = None

    @classmethod
    def from_records(cls, records) -> "HashIndex":
        """Index from scan FileRecords (pipeline/scan.py output)."""
        ix = cls()
        for r in records:
            if r.pdqhash:
                ix.add(str(r.path), r.pdqhash, r.pdq_quality)
        return ix

    # --------------------------------------------------------- persist
    def save(self, path: str | Path):
        """Write the live entries as the reference's .npz: hashes,
        quality, and the paths as JSON bytes (never a pickle).  The
        snapshot is taken under the lock and written tmp + rename."""
        with self._lock:
            hashes = self.hashes.copy()
            quality = self.quality.copy()
            pb = np.frombuffer(json.dumps(self.paths).encode(),
                               dtype=np.uint8)
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, hashes=hashes, quality=quality,
                                paths_json=pb)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | Path) -> "HashIndex":
        with np.load(path, allow_pickle=False) as z:
            if "paths_json" not in z.files:
                raise ValueError(
                    f"{path} was saved by an older version (pickled "
                    "paths); rebuild it")
            ix = cls(nbytes=z["hashes"].shape[1] if z["hashes"].size
                     else 32)
            n = len(z["hashes"])
            ix._hashes = np.ascontiguousarray(z["hashes"], dtype=np.uint8)
            ix._quality = np.ascontiguousarray(z["quality"], dtype=np.int32)
            ix._dead = np.zeros(n, dtype=bool)
            ix._paths = [str(p) for p in
                         json.loads(bytes(z["paths_json"]).decode())]
            ix._n = n
        return ix

    # ----------------------------------------------------------- query
    def _status_rows(self, lo: int, hi: int) -> np.ndarray:
        """(hi-lo,) int8 device status codes for host slots [lo, hi)."""
        st = np.where(self._quality[lo:hi] < PDQ_MIN_QUALITY,
                      STATUS_LOW, STATUS_OK).astype(np.int8)
        st[self._dead[lo:hi]] = STATUS_DEAD
        return st

    def _device_arrays(self, mesh=None):
        """(shards, paths_list, n, live_rank), captured together under the
        lock so concurrent add/remove cannot shift the index<->path
        mapping mid-query.  shards is [(hashes (cap/ndev, nbytes) u8,
        status (cap/ndev,) int8)], one per device of the mesh (q-major),
        or one on the index's device without a mesh.  live_rank maps
        device slots to positions in the live-compacted view
        (.hashes/.paths).  Syncs pending mutations with O(delta) upload
        traffic."""
        devs = [self.device] if mesh is None else mesh.flat
        with self._lock:
            if self._n_dead > max(64, self._n // 2):
                self._compact_locked()
            dev = self._dev
            if dev is not None and dev["mesh"] is not mesh:
                dev = None   # another mesh, or none: rebuild
            if dev is None or self._n > dev["cap"]:
                # full (re-)push: first use, capacity growth, compaction
                unit = 8 * len(devs)
                cap = max(1024,
                          1 << max(0, (max(self._n, 1) - 1).bit_length()))
                cap = -(-cap // unit) * unit
                loc = cap // len(devs)
                hp = np.zeros((cap, self.nbytes), np.uint8)
                hp[:self._n] = self._hashes[:self._n]
                st = np.full(cap, STATUS_DEAD, np.int8)
                st[:self._n] = self._status_rows(0, self._n)
                dev = {"shards": [
                    (_upload(hp[s * loc:(s + 1) * loc], d),
                     _upload(st[s * loc:(s + 1) * loc], d))
                    for s, d in enumerate(devs)],
                    "mesh": mesh, "cap": cap, "applied": self._n,
                    "paths": self._paths, "pending_dead": []}
                self._dev = dev
            else:
                shards = list(dev["shards"])
                loc = dev["cap"] // len(devs)
                if dev["applied"] < self._n:
                    # O(delta): upload only the appended rows, each to the
                    # shard that holds its slot
                    start, n = dev["applied"], self._n
                    for s, d in enumerate(devs):
                        lo, hi = max(start, s * loc), min(n, (s + 1) * loc)
                        if lo < hi:
                            shards[s] = _dev_write_rows(
                                *shards[s], _upload(self._hashes[lo:hi], d),
                                _upload(self._status_rows(lo, hi), d),
                                lo - s * loc)
                    dev["applied"] = n
                if dev["pending_dead"]:
                    # O(delta): upload only the tombstoned indices
                    idx = np.asarray(dev["pending_dead"], np.int64)
                    for s in np.unique(idx // loc):
                        mine = (idx[idx // loc == s] - s * loc).astype(np.int32)
                        h, st = shards[s]
                        shards[s] = (h, _dev_kill_rows(
                            st, _upload(mine, devs[s])))
                    dev["pending_dead"] = []
                dev["shards"] = shards
            if dev.get("rank_n") != (self._n, self._n_dead):
                # slot -> live-compacted position (host-side, rebuilt
                # only when the live set changed)
                dev["rank"] = np.cumsum(self._live_mask) - 1
                dev["rank_n"] = (self._n, self._n_dead)
            return dev["shards"], dev["paths"], self._n, dev["rank"]

    def _matches(self, dists, idx, similarity, max_results, paths, rank):
        out = []
        for drow, irow in zip(dists, idx):
            sel = drow <= similarity    # sentinel rows are never selected
            # report live-compacted positions (same index space as
            # .hashes/.paths and the mesh path), not device slots
            out.append([(int(rank[int(i)]), paths[int(i)], int(d))
                        for d, i in zip(drow[sel][:max_results],
                                        irow[sel][:max_results])])
        return out

    def query_mesh(self, mesh, variants: np.ndarray, similarity: int = 40,
                   max_results: int = 100):
        """Mesh-sharded query against the incremental sharded corpus (the
        same O(delta) mutations as the one-device path): each device
        gates its shard's distances and keeps its k best, the first
        merges them (parallel/sharded.sharded_query_topk_status), so
        readback is O(Q x max_results).  Answers, indices included, are
        the one-device path's."""
        _check_mesh(mesh)
        if len(self) == 0:
            return [[] for _ in range(len(variants))]
        similarity = max(0, min(int(similarity), self.nbytes * 8 - 1))
        shards, paths, n, rank = self._device_arrays(mesh)
        cap = sum(int(h.shape[0]) for h, _ in shards)
        k = min(cap, max(16, 1 << (max(1, max_results) - 1).bit_length()))
        q = _upload(np.ascontiguousarray(variants, dtype=np.uint8),
                    mesh.home)
        dists, idx = (t.cpu().numpy() for t in _mesh_query_fn(mesh)(
            q, shards, n, similarity, k))
        return self._matches(dists, idx, similarity, max_results, paths,
                             rank)

    def query(self, variants: np.ndarray, similarity: int = 40,
              max_results: int = 100, mesh=None):
        """(Q, V, nbytes) query dihedral variants -> per-query matches
        [(index, path, distance), ...] sorted by distance, ties by index.
        With a mesh (parallel/sharded.make_mesh) the corpus is sharded
        over its devices (query_mesh).  A span index.query.

        similarity is clamped to [0, nbits-1]: the sentinels nbits+1
        (device padding rows) and the low-quality gate must never be
        selectable by a client-supplied radius."""
        with trace.span("index.query", queries=len(variants)):
            return self._query(variants, similarity, max_results, mesh)

    def _query(self, variants, similarity, max_results, mesh):
        similarity = max(0, min(int(similarity), self.nbytes * 8 - 1))
        if mesh is not None:
            return self.query_mesh(mesh, variants, similarity, max_results)
        if len(self) == 0:
            return [[] for _ in range(len(variants))]
        [(base_dev, status_dev)], paths, n, rank = self._device_arrays()
        q = np.ascontiguousarray(variants, dtype=np.uint8)
        k = min(int(base_dev.shape[0]),
                max(16, 1 << (max(1, max_results) - 1).bit_length()))
        dists, idx = (t.cpu().numpy() for t in _query_topk(
            _upload(q, self.device), base_dev, status_dev, n,
            self.nbytes * 8, k))
        return self._matches(dists, idx, similarity, max_results, paths,
                             rank)


@functools.lru_cache(maxsize=8)
def _mesh_query_fn(mesh):
    # keyed on the mesh only: the client-supplied radius is an argument
    # of each call, so no per-radius state builds up
    return sharded.sharded_query_topk_status(mesh)


class NearDupService:
    """Decode -> hash (K1) -> index query, plus the HTTP surface; the
    reference's NearDupService (rupphash_tpu/serve.py:444-658) with the
    same endpoints, status codes, JSON keys and gates."""

    # /v1/query accepts raw image bytes; cap at a realistic image size
    MAX_BODY = 64_000_000

    def __init__(self, index: HashIndex, similarity: int | None = 40,
                 roots=None, mesh=None, allow_hosts=()):
        _check_mesh(mesh)
        self.index = index
        self.device = device.get()
        # the corpus sharded over a mesh's devices; None: on self.device
        self.mesh = mesh
        # the CLI leaves --similarity None; the service uses the
        # reference default 40 (phdupes.rs:195-282)
        self.similarity = 40 if similarity is None else int(similarity)
        self.queries = 0
        self._lock = threading.Lock()
        # /v1/add and /v1/remove only touch files under these roots
        self.roots = [Path(r).resolve() for r in (roots or [])]
        # Host names accepted beyond IP literals and localhost
        # (utils/netguard DNS-rebinding gate; --allow-host)
        self.allow_hosts = tuple(allow_hosts or ())

    def path_allowed(self, path: str) -> bool:
        if not self.roots:
            return False
        try:
            p = Path(path).resolve()
        except (OSError, ValueError):
            # ValueError: embedded NUL byte, answered 403
            return False
        return any(p == r or r in p.parents for r in self.roots)

    def _hash_image(self, img):
        """Decoded image -> ((8, nbytes) u8 variants, quality 0-100) or
        None; one K1 launch on a CUDA device."""
        luma = prepare_luma_fast(img)
        if luma is None:
            return None
        out = pdq_torch.pdq_hash_batch(np.asarray(luma)[None])
        # device quality is [0, 1]; records and the index use the
        # reference's 0-100 scale (scanner.rs quality < 50 gate)
        return (out["dihedral"][0].cpu().numpy(),
                float(out["quality"][0]) * 100.0)

    def hash_bytes(self, data: bytes):
        """Image bytes -> (variants (8, 32) u8, quality) or None; a span
        request.hash."""
        with trace.span("request.hash", bytes=len(data)):
            img = decode.sniff_decode_bytes(data, device=self.device)
            return None if img is None else self._hash_image(img)

    def query_bytes(self, data: bytes, similarity: int | None = None,
                    max_results: int = 100):
        hashed = self.hash_bytes(data)
        if hashed is None:
            return None
        variants, quality = hashed
        sim = self.similarity if similarity is None else similarity
        if quality < PDQ_MIN_QUALITY:
            sim = 0  # low-quality query: exact only (scanner gate)
        matches = self.index.query(variants[None], sim, max_results,
                                   mesh=self.mesh)[0]
        with self._lock:
            self.queries += 1
        return {"quality": quality,
                "hash": bytes(variants[0]).hex(),
                "matches": [{"path": p, "distance": d, "index": i}
                            for i, p, d in matches]}

    def add_path(self, path: str):
        img, _ = decode.load_image(path, device=self.device)
        hashed = None if img is None else self._hash_image(img)
        if hashed is None:
            return None
        variants, q = hashed
        h = bytes(variants[0])
        self.index.add(path, h, int(round(q)))
        return {"path": path, "hash": h.hex(), "quality": q,
                "size": len(self.index)}

    # ------------------------------------------------------------ http
    def make_handler(service):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _traced(self, route):
                """One request under a root span http.request, whose id
                is the request's: counts the body's bytes, the
                response's status and wait_us, from the connection's
                accept to here; a child http.respond holds the JSON
                encoding and the write."""
                start = time.time_ns()
                with trace.span("http.request") as self._req:
                    accepted = getattr(self.server, "accepted_ns", {}).pop(
                        self.connection, None)
                    if accepted is not None:
                        self._req.count("wait_us",
                                        (start - accepted) // 1000)
                    route()

            def _send(self, code, body, ctype: str):
                """body: bytes, or an object sent as JSON."""
                self._req.count("status", code)
                with trace.span("http.respond"):
                    if not isinstance(body, bytes):
                        body = json.dumps(body).encode()
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, obj, "application/json")

            def _gate(self, mutating: bool) -> bool:
                """Reject DNS-rebound Hosts everywhere, and Origin-
                bearing (browser cross-origin) mutation requests."""
                if not netguard.host_allowed(self.headers.get("Host", ""),
                                             service.allow_hosts):
                    self._json({"error": "forbidden host (use an IP "
                                "literal, localhost, or start with "
                                "--allow-host NAME)"}, 403)
                    return False
                if mutating and self.headers.get("Origin"):
                    self._json({"error": "browser cross-origin "
                                "mutation blocked"}, 403)
                    return False
                return True

            def do_GET(self):
                self._traced(self._get)

            def do_POST(self):
                self._traced(self._post)

            def _get(self):
                u = urlparse(self.path)
                if not self._gate(mutating=False):
                    return
                if u.path == "/":
                    self._send(200, _INDEX_PAGE, "text/html; charset=utf-8")
                elif u.path == "/v1/stats":
                    self._json({"indexed": len(service.index),
                                "queries": service.queries,
                                "similarity": service.similarity})
                else:
                    self._json({"error": "not found"}, 404)

            def _post(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if not self._gate(
                        mutating=u.path in ("/v1/add", "/v1/remove")):
                    return
                if u.path == "/v1/query":
                    try:
                        n = int(self.headers.get("Content-Length", "0"))
                    except ValueError:
                        n = -1
                    if n <= 0 or n > service.MAX_BODY:
                        self._json({"error": "bad length"}, 400)
                        return
                    data = self.rfile.read(n)
                    self._req.count("bytes", len(data))
                    try:
                        sim = int(q.get("similarity",
                                        [service.similarity])[0])
                    except (ValueError, TypeError):
                        sim = service.similarity
                    out = service.query_bytes(data, sim)
                    if out is None:
                        self._json({"error": "undecodable image"}, 415)
                    else:
                        self._json(out)
                elif u.path == "/v1/remove":
                    path = q.get("path", [""])[0]
                    if path and not service.path_allowed(path):
                        self._json({"error": "path outside indexed "
                                    "roots"}, 403)
                        return
                    n = service.index.remove(path) if path else 0
                    self._json({"removed": n,
                                "size": len(service.index)})
                elif u.path == "/v1/add":
                    path = q.get("path", [""])[0]
                    if not service.path_allowed(path):
                        self._json({"error": "path outside indexed "
                                    "roots"}, 403)
                        return
                    if not path or not Path(path).is_file():
                        self._json({"error": "no such file"}, 404)
                        return
                    out = service.add_path(path)
                    if out is None:
                        self._json({"error": "undecodable image"}, 415)
                    else:
                        self._json(out)
                else:
                    self._json({"error": "not found"}, 404)

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        httpd = _Server((host, port), self.make_handler())
        return httpd, httpd.server_address[1]


class _Server(ThreadingHTTPServer):
    """The HTTP server of --serve: stamps each connection's accept time
    (time.time_ns()) for the handler's wait_us."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.accepted_ns = weakref.WeakKeyDictionary()

    def process_request(self, request, client_address):
        self.accepted_ns[request] = time.time_ns()
        super().process_request(request, client_address)


_INDEX_PAGE = (
    "<!DOCTYPE html><title>rupphash near-duplicate service</title><pre>"
    "rupphash near-duplicate lookup service\n\n"
    "POST /v1/query[?similarity=D]  raw image bytes -> JSON matches\n"
    "POST /v1/add?path=P            hash + index a local file\n"
    "POST /v1/remove?path=P         drop a path from the index\n"
    "GET  /v1/stats                 index size / query count\n\n"
    "curl -s --data-binary @photo.jpg http://HOST:PORT/v1/query | jq .</pre>"
).encode()


def run_serve(args) -> int:
    """CLI entry for `--serve`: scan the given paths into an index (or
    load --index-file) and answer queries until interrupted; the index
    is saved to --index-file on the way out, /v1/add mutations
    included."""
    from .pipeline import scan as scanmod

    index_file = getattr(args, "index_file", None)
    if index_file and Path(index_file).exists():
        index = HashIndex.load(index_file)
        print(f"loaded index: {len(index)} hashes from {index_file}",
              file=sys.stderr)
    else:
        records, stats = scanmod.scan(args.paths, scanmod.ScanConfig(), None)
        index = HashIndex.from_records(records)
        print(f"indexed {len(index)} images ({stats.failed} failures)",
              file=sys.stderr)
        if index_file:
            index.save(index_file)
            print(f"saved index to {index_file}", file=sys.stderr)
    mesh = None
    devices = sharded.local_devices()
    if len(devices) > 1:
        # no fallback to one card: a mesh that cannot be built is an error
        mesh = sharded.make_mesh(devices=devices)
        print(f"corpus sharded over {mesh.size} devices (mesh "
              f"{mesh.shape})", file=sys.stderr)
    svc = NearDupService(index, similarity=args.similarity,
                         roots=list(getattr(args, "paths", []) or []),
                         mesh=mesh,
                         allow_hosts=tuple(
                             getattr(args, "allow_host", None) or ()))
    host = getattr(args, "host", "127.0.0.1")
    httpd, port = svc.serve(host=host, port=getattr(args, "port", 0) or 0)
    print(f"near-duplicate service at http://{host}:{port}/v1/  "
          f"(POST /v1/query with image bytes)", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if index_file:
            index.save(index_file)
            print(f"saved index ({len(index)} hashes) to {index_file}",
                  file=sys.stderr)
        trace.debug("KERNELS", scanmod.kernel_counts())
    return 0

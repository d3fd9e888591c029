"""Duplicate-group construction with the reference's production semantics.

Port of rupphash_tpu/grouping/engine.py, whose module imports jax through
its edge search.  Host-side clustering layered on the device edge search
(ops/hamming.py), mirroring src/scanner.rs:

  union-find with path compression          scanner.rs:1780-1823
  merge groups sharing dir + file stem      scanner.rs:1905-1983
  per-group analysis & ordering             scanner.rs:1834-2022, 2183-2254
  low-quality exact-match-only gating       scanner.rs:1588-1594
  sort orders incl. natural sort            scanner.rs:2040-2110

The pivot-vs-dihedral max-distance and the bit/pixel-identical partition
reproduce analyze_group_with_features (scanner.rs:2183-2254).
"""

from __future__ import annotations

import dataclasses
import random
import re
from pathlib import Path

import numpy as np
import torch

from .. import device
from ..ops import hamming
from ..parallel import sharded
from ..utils import trace

PDQ_MIN_QUALITY = 50  # scanner.rs:1589
DEFAULT_SIMILARITY = 40  # phdupes.rs:351

RAW_EXTS = {"nef", "dng", "cr2", "cr3", "arw", "orf", "rw2", "raf",
            "kdc", "dcr", "pef", "x3f", "srf", "3fr"}  # scanner.rs:43-46


@dataclasses.dataclass(slots=True)
class FileRecord:
    """The cross-layer value type, mirrors FileMetadata (phdupes.rs:52-65).

    slots=True drops the per-instance __dict__ (~230 B each): at the
    reference's advertised 1M-file scale that is ~220 MiB of resident
    memory (README.md:12 budget is 2.5 GiB total)."""
    path: Path
    size: int = 0
    modified: float = 0.0
    pdqhash: bytes | None = None            # 32 bytes
    pdq_quality: int | None = None          # 0-100
    resolution: tuple[int, int] | None = None
    content_hash: bytes = b""               # keyed blake2b of file bytes
    pixel_hash: bytes | None = None
    orientation: int = 1
    gps_pos: tuple[float, float] | None = None
    unique_file_id: int = 0                 # (dev << 64) | inode
    exif_timestamp: int | None = None
    dihedral: np.ndarray | None = None      # (8, 32) uint8 variants
    coeffs: np.ndarray | None = None        # (256,) float32
    # (batch, row) into the scan's device_sink list: the explicit
    # contract for the zero-re-upload grouping path.  Stamped by
    # pipeline.scan; survives dataclasses.replace copies (unlike the
    # old id(rec) map, which silently dropped copied records to the
    # host path).  Validated against the batch's own record before use.
    device_slot: tuple[int, int] | None = None

    @property
    def is_low_quality(self) -> bool:
        """Unknown quality counts as good (scanner.rs:1591-1594)."""
        return self.pdq_quality is not None and self.pdq_quality < PDQ_MIN_QUALITY


@dataclasses.dataclass(slots=True)
class GroupInfo:
    max_dist: int = 0
    status: str = "none"  # "all-identical" | "some-identical" | "none"


class UnionFind:
    """Path-compressing union-find (scanner.rs:1780-1807)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while root != p[root]:
            root = p[root]
        while i != root:
            # order matters: p[i] must be written before i advances
            # (the swapped form re-parented the *next* node and left
            # the visited one uncompressed, degrading toward O(n))
            p[i], i = root, p[i]
        return root

    def union(self, i: int, j: int):
        ri, rj = self.find(i), self.find(j)
        if ri != rj:
            # union by size: adversarial edge orders otherwise build O(n)
            # parent chains (scanner.rs:1780-1807 uses rank for the same
            # reason); with compression this is O(alpha) amortized
            if self.size[ri] > self.size[rj]:
                ri, rj = rj, ri
            self.parent[ri] = rj
            self.size[rj] += self.size[ri]

    def union_edges(self, ei: np.ndarray, ej: np.ndarray):
        for a, b in zip(ei.tolist(), ej.tolist()):
            self.union(a, b)

    def components(self, min_size: int = 2) -> list[list[int]]:
        n = len(self.parent)
        roots = np.fromiter((self.find(i) for i in range(n)),
                            dtype=np.int64, count=n)
        return _components_from_roots(roots, min_size)


def _components_from_roots(roots: np.ndarray,
                           min_size: int = 2) -> list[list[int]]:
    order = np.argsort(roots, kind="stable")
    sr = roots[order]
    groups = []
    start = 0
    n = len(roots)
    for k in range(1, n + 1):
        if k == n or sr[k] != sr[start]:
            if k - start >= min_size:
                groups.append(order[start:k].tolist())
            start = k
    return groups


# --------------------------------------------------------------------------
# Natural sort (natord-compatible: digit runs compare numerically)
# --------------------------------------------------------------------------

_NAT_SPLIT = re.compile(r"(\d+)")


def natural_key(s: str):
    # homogeneous (kind, str, int) tokens: a bare int/str mix makes
    # sorted() raise TypeError the moment one name leads with digits
    # and another with letters ('1.jpg' vs 'a.jpg')
    return tuple((0, "", int(t)) if t.isdigit() else (1, t, 0)
                 for t in _NAT_SPLIT.split(s) if t != "")


def sort_files(files: list[FileRecord], sort_order: str):
    """In-place sort mirroring sort_files (scanner.rs:2040-2110)."""
    order = sort_order.lower()
    name = lambda f: f.path.name
    if order == "name":
        files.sort(key=name)
    elif order == "name-desc":
        files.sort(key=name)
        files.reverse()
    elif order == "name-natural":
        files.sort(key=lambda f: natural_key(f.path.name))
    elif order == "name-natural-desc":
        files.sort(key=lambda f: natural_key(f.path.name))
        files.reverse()
    elif order == "date":
        files.sort(key=lambda f: f.modified)
    elif order == "date-desc":
        files.sort(key=lambda f: f.modified, reverse=True)
    elif order == "size":
        files.sort(key=lambda f: f.size)
    elif order == "size-desc":
        files.sort(key=lambda f: f.size, reverse=True)
    elif order in ("exif-date", "exif-date-desc"):
        desc = order.endswith("desc")

        def key(f):
            has = f.exif_timestamp is not None
            ts = f.exif_timestamp if has else f.modified
            primary = -ts if desc else ts
            return (0 if has else 1, primary)
        files.sort(key=key)
    elif order == "random":
        random.shuffle(files)
    elif order == "location":
        # the location order is GLOBAL (the GPS map's optimized path
        # over every marker, gui/app.rs:242-271) and cannot be derived
        # from one group's files; callers apply apply_location_sort
        # over the full group list after assembly
        pass
    else:
        files.sort(key=lambda f: natural_key(f.path.name))


def apply_location_sort(groups: list[list[FileRecord]]):
    """Reorder every group's files by their position along the GPS
    map's optimized marker path, files without GPS last — the
    reference's apply_location_sort (gui/app.rs:242-271): it rebuilds
    the spatially-optimized path (gps_map.optimize_path) and sorts
    each group by path_to_marker index with usize::MAX for unmapped
    paths.  Python's sort is stable, so GPS-less files keep their
    previous relative order, matching sort_by_key."""
    from ..utils import geo

    seen: dict = {}
    for g in groups:
        for f in g:
            if f.gps_pos is not None and f.path not in seen:
                seen[f.path] = f.gps_pos
    if not seen:
        return
    paths = list(seen.keys())
    order = geo.order_markers([seen[p] for p in paths])
    rank = {paths[i]: pos for pos, i in enumerate(order)}
    big = len(paths)
    for g in groups:
        g.sort(key=lambda f: rank.get(f.path, big))


def _sort_by_stem_then_ext(files: list[FileRecord]):
    """scanner.rs:2256-2263: group stem-mates, RAW after processed."""
    files.sort(key=lambda f: (f.path.stem,
                              f.path.suffix.lower().lstrip(".") in RAW_EXTS))


# --------------------------------------------------------------------------
# Group construction
# --------------------------------------------------------------------------

def merge_groups_by_stem(groups: list[list[int]],
                         files: list[FileRecord]) -> list[list[int]]:
    """Merge groups that share a (parent dir, file stem) pair
    (scanner.rs:1905-1983) so e.g. IMG_1.jpg + IMG_1.nef travel together."""
    if len(groups) < 2:
        return groups
    key_to_group: dict[tuple, int] = {}
    uf = UnionFind(len(groups))
    for g_idx, group in enumerate(groups):
        for f_idx in group:
            p = files[f_idx].path
            key = (str(p.parent), p.stem)
            if key in key_to_group:
                uf.union(key_to_group[key], g_idx)
            else:
                key_to_group[key] = g_idx
    merged: dict[int, list[int]] = {}
    for g_idx, group in enumerate(groups):
        merged.setdefault(uf.find(g_idx), []).extend(group)
    return [sorted(set(g)) for g in merged.values()]


def _min_dihedral_distance(variants: np.ndarray, h: bytes) -> int:
    hb = np.frombuffer(h, dtype=np.uint8)
    x = np.bitwise_xor(variants, hb[None, :])
    return int(np.unpackbits(x, axis=-1).sum(axis=-1).min())


def analyze_group(group: list[FileRecord], sort_order: str) -> GroupInfo:
    """Order a group in place and compute its info, mirroring
    analyze_group_with_features (scanner.rs:2183-2254): bit-identical
    duplicates first (sorted by pixel/content hash then name), the rest in
    user order, then stem-mates adjacent; max_dist is pivot-vs-dihedral."""
    if not group:
        return GroupInfo()
    # empty content_hash means "not hashed", never "identical" — the
    # reference always has a blake3, so its counts can't alias this way
    counts: dict[bytes, int] = {}
    for f in group:
        if f.content_hash:
            counts[f.content_hash] = counts.get(f.content_hash, 0) + 1

    dupes = [f for f in group if counts.get(f.content_hash, 0) > 1]
    unique = [f for f in group if counts.get(f.content_hash, 0) <= 1]
    dupes.sort(key=lambda f: (f.pixel_hash or b"", f.content_hash, f.path.name))
    sort_files(unique, sort_order)
    group[:] = dupes + unique
    _sort_by_stem_then_ext(group)

    pivot = next((f for f in group if f.dihedral is not None), None)
    if pivot is not None:
        max_d = max((_min_dihedral_distance(pivot.dihedral, f.pdqhash)
                     for f in group if f.pdqhash is not None), default=0)
    else:
        ph = next((f.pdqhash for f in group if f.pdqhash is not None), None)
        if ph is not None:
            max_d = max((_hamming_bytes(ph, f.pdqhash)
                         for f in group if f.pdqhash is not None), default=0)
        else:
            max_d = 0

    has_dupes = any(c > 1 for c in counts.values())
    all_identical = (len(counts) == 1
                     and next(iter(counts.values())) == len(group))
    status = ("all-identical" if all_identical
              else "some-identical" if has_dupes else "none")
    return GroupInfo(max_dist=int(max_d), status=status)


def _hamming_bytes(a: bytes, b: bytes) -> int:
    return bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1")


def group_files(files: list[FileRecord],
                similarity: int = DEFAULT_SIMILARITY,
                sort_order: str = "name",
                use_device: bool | None = None,
                device_batches: list | None = None):
    """Full grouping pipeline (scanner.rs:1640-1830 semantics).

    Returns (groups: list[list[FileRecord]], infos: list[GroupInfo],
    edge_count: int).  Groups are ordered identical-first, then by max
    distance, then by descending size (scanner.rs:1561-1576).

    device_batches: optional ([FileRecord,...], (B, 8, 32) u8 tensor)
    pairs from scan(..., device_sink=...) — when every hashed record
    has a device row, the edge search consumes the device-resident
    dihedral sets directly (find_edges_fast_resident: no hash re-upload).
    """
    assert similarity <= hamming.MAX_SIMILARITY_256
    # the span closes after the body's frame: freeing its lists of a
    # row per file (~12 ms at 1M files) is the grouping's own time
    with trace.span("group", files=len(files)) as sp:
        return _group_files(files, similarity, sort_order, use_device,
                            device_batches, sp)


def _group_files(files, similarity, sort_order, use_device, device_batches,
                 sp):
    with trace.span("group.select"):
        idx_with_hash = [i for i, f in enumerate(files)
                         if f.pdqhash is not None]
        low = np.array([files[i].is_low_quality for i in idx_with_hash])
        dense_to_sparse = np.asarray(idx_with_hash, dtype=np.int64)
    sp.count("rows", len(idx_with_hash))
    if not idx_with_hash:
        return [], [], 0
    if use_device is None:
        # the same size thresholds as the JAX package: below them the
        # numpy brute force avoids the sweep's padding to 1024-row tiles
        accel = device.get().type == "cuda"
        use_device = len(idx_with_hash) > (256 if accel else 2048)
    var_sel = (_resident_rows(files, idx_with_hash, device_batches)
               if use_device else None)
    with trace.span("edges") as se:
        ei, ej = _edges(files, idx_with_hash, low, similarity, use_device,
                        var_sel)
        se.count("edges", len(ei))
    return finalize_edges(files, dense_to_sparse[ei], dense_to_sparse[ej],
                          sort_order)


def _edges(files, idx_with_hash, low, similarity, use_device, var_sel):
    """group_files' edge search over the hashed records, (i, j) indices
    into idx_with_hash: the numpy brute force, or on the device the
    mesh, the resident rows `var_sel` or uploaded host arrays."""

    def host_arrays():
        # built lazily: the device-resident branch needs neither, and at
        # 1M files the variants stack is ~244 MiB built by a Python loop
        base = np.stack([np.frombuffer(files[i].pdqhash, dtype=np.uint8)
                         for i in idx_with_hash])
        variants = np.stack([
            files[i].dihedral if files[i].dihedral is not None
            else np.repeat(base[k][None], 8, axis=0)
            for k, i in enumerate(idx_with_hash)])
        return base, variants

    if not use_device:
        return hamming.brute_force_edges(*host_arrays(), low, similarity)
    if var_sel is not None:
        trace.debug("GROUP", "device-resident edge search "
                    f"({len(idx_with_hash)} rows, no re-upload)")
    if len(sharded.local_devices()) > 1:
        # several devices: the ('q', 'b')-mesh count-then-extract
        # (parallel/sharded.py), the same edges with the triangle tiled
        # over every device; resident rows are copied device to device
        base, variants = ((None, var_sel) if var_sel is not None
                          else host_arrays())
        return sharded.sharded_find_edges(sharded.make_mesh(), base,
                                          variants, low, similarity)
    if var_sel is not None:
        return hamming.find_edges_fast_resident(var_sel, low, similarity)
    return hamming.find_edges_fast(*host_arrays(), low, similarity)


def _resident_rows(files, idx_with_hash, device_batches):
    """(len(idx_with_hash), 8, 32) u8 tensor gathered on the device from
    the scan's retained batches, or None when any hashed record lacks a
    valid device row (then the caller uploads host arrays — LOUDLY, via a
    [GROUP] trace tag + GROUP-RESIDENT-FALLBACK counter, so a caller
    that reconstructs records and loses the resident path sees why).

    Routing uses the explicit FileRecord.device_slot = (batch, row)
    stamp written by pipeline.scan, cross-checked against the batch's
    own record at that row by pdqhash (a stale stamp from an earlier
    scan against a different sink is rejected, a dataclasses.replace
    copy of a stamped record still qualifies).  The gather itself has
    no fallback: an error there propagates."""

    if not device_batches:
        return None
    with trace.span("group.resident_rows") as sp:
        order, reason = _resident_order(files, idx_with_hash, device_batches)
        if reason is not None:
            sp.count("fallback")
            trace.count("GROUP-RESIDENT-FALLBACK")
            trace.tag("GROUP", "device-resident path unavailable "
                      f"({reason}); falling back to host-array upload")
            return None
        sp.count("rows", len(order))
        var_all = torch.cat([a for _, a in device_batches], dim=0)
        return var_all.index_select(
            0, torch.from_numpy(order).to(var_all.device))


def _resident_order(files, idx_with_hash, device_batches):
    """(rows of the concatenated batches in idx_with_hash's order, None),
    or (None, why) when a batch or a stamp does not line up."""
    for recs, arr in device_batches:
        if int(arr.shape[0]) != len(recs):
            return None, "misaligned device batch"
    offsets = np.cumsum([0] + [len(recs)
                               for recs, _ in device_batches])
    order = np.empty(len(idx_with_hash), dtype=np.int64)
    missing = 0
    for k, i in enumerate(idx_with_hash):
        loc = files[i].device_slot
        if (loc is None or loc[0] >= len(device_batches)
                or loc[1] >= len(device_batches[loc[0]][0])
                or device_batches[loc[0]][0][loc[1]].pdqhash
                != files[i].pdqhash):
            missing += 1
            continue
        order[k] = offsets[loc[0]] + loc[1]
    if missing:
        return None, (f"{missing}/{len(idx_with_hash)} records lack a "
                      "matching device_slot stamp")
    return order, None


def finalize_edges(files, gi: np.ndarray, gj: np.ndarray,
                   sort_order: str = "name"):
    """Global-index edges -> (groups, infos, edge_count): the
    union-find / stem-merge / analyze / ordering tail
    (scanner.rs:1780-1830 + :1561-1576), shared by the single-chip and
    mesh-sharded edge searches so the production semantics exist once."""
    n_all = len(files)
    with trace.span("cluster") as sp:
        with trace.span("cluster.components"):
            # always prefer the native path-halving union-find when the
            # library is present — the old >10k-edge threshold left
            # mid-size edge sets on the slower Python loop for no benefit
            if len(gi) > 0:
                from .. import native
                roots = native.union_find_roots(n_all, gi, gj)
            else:
                roots = None
            if roots is not None:
                raw = _components_from_roots(roots)
            else:
                uf = UnionFind(n_all)
                uf.union_edges(gi, gj)
                raw = uf.components(min_size=2)
        with trace.span("cluster.stem_merge") as sm:
            merged = merge_groups_by_stem(raw, files)
            sm.count("merged", len(raw) - len(merged))

        with trace.span("cluster.analyze"):
            groups: list[list[FileRecord]] = []
            infos: list[GroupInfo] = []
            for g in merged:
                members = [files[i] for i in g]
                infos.append(analyze_group(members, sort_order))
                groups.append(members)

            if sort_order.lower() == "location":
                apply_location_sort(groups)

            order = sorted(range(len(groups)),
                           key=lambda k: (0 if infos[k].status
                                          == "all-identical" else 1,
                                          infos[k].max_dist,
                                          -len(groups[k])))
            groups = [groups[k] for k in order]
            infos = [infos[k] for k in order]
        sp.count("groups", len(groups))
        sp.count("members", sum(map(len, groups)))
        return groups, infos, int(len(gi))

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
from operator import attrgetter
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


def _component_runs(roots: np.ndarray, min_size: int = 2):
    """(members, offsets): the runs of equal roots with at least min_size
    members as a CSR (run k is members[offsets[k]:offsets[k + 1]]), runs
    in ascending root order, each run's members in ascending index order
    (the stable argsort of the roots)."""
    n = len(roots)
    if n == 0:
        return np.empty(0, np.int64), np.zeros(1, np.int64)
    order = np.argsort(roots, kind="stable")
    bounds = np.concatenate(
        ([0], np.flatnonzero(np.diff(roots[order])) + 1, [n]))
    sizes = np.diff(bounds)
    keep = sizes >= min_size
    members = order[np.repeat(keep, sizes)]
    return members, np.concatenate(([0], np.cumsum(sizes[keep])))


def _components_from_roots(roots: np.ndarray,
                           min_size: int = 2) -> list[list[int]]:
    members, offsets = _component_runs(np.asarray(roots), min_size)
    return [members[a:b].tolist()
            for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


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


def _exif_key(desc: bool):
    def key(name, f):
        has = f.exif_timestamp is not None
        ts = f.exif_timestamp if has else f.modified
        return (0 if has else 1, -ts if desc else ts)
    return key


def _by_name(name, f):
    return name


def _by_natural_name(name, f):
    return natural_key(name)


# sort_files' orders (scanner.rs:2040-2110): the key of a record, given
# its file name, and how the order turns: "" ascending, "desc" a stable
# descending sort, "reverse" an ascending sort reversed whole (equal keys
# end in reverse order).  "random" and "location" are not keyed.
_ORDERS = {
    "name": (_by_name, ""),
    "name-desc": (_by_name, "reverse"),
    "name-natural": (_by_natural_name, ""),
    "name-natural-desc": (_by_natural_name, "reverse"),
    "date": (lambda name, f: f.modified, ""),
    "date-desc": (lambda name, f: f.modified, "desc"),
    "size": (lambda name, f: f.size, ""),
    "size-desc": (lambda name, f: f.size, "desc"),
    "exif-date": (_exif_key(False), ""),
    "exif-date-desc": (_exif_key(True), ""),
}


def sort_files(files: list[FileRecord], sort_order: str):
    """In-place sort mirroring sort_files (scanner.rs:2040-2110)."""
    order = sort_order.lower()
    if order == "random":
        random.shuffle(files)
    elif order != "location":
        # the location order is GLOBAL (the GPS map's optimized path
        # over every marker, gui/app.rs:242-271) and cannot be derived
        # from one group's files; callers apply apply_location_sort
        # over the full group list after assembly
        key, turn = _ORDERS.get(order, _ORDERS["name-natural"])
        files.sort(key=lambda f: key(f.path.name, f),
                   reverse=turn == "desc")
        if turn == "reverse":
            files.reverse()


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


def _path_columns(paths: list[str]):
    """(names, stems, extensions, RAW flags, (parent dir, stem) ids) of
    the paths, as pathlib has them (Python 3.12, POSIX): p.name, p.stem,
    p.suffix without its dot, and an id a (str(p.parent), p.stem) pair.
    Each column is one pass over the str() of the paths, which pathlib
    normalises: no empty or "." parts, no trailing slash, a root of "/"
    or "//", "." for the empty path (whose name is "")."""
    cut = [s.rfind("/") for s in paths]
    names = [s[i + 1:] if s != "." else "" for s, i in zip(paths, cut)]
    dots = [n.rfind(".") for n in names]
    # a suffix needs something before its dot and after it
    stems = [n[:d] if 0 < d < len(n) - 1 else n
             for n, d in zip(names, dots)]
    exts = [n[d + 1:] if 0 < d < len(n) - 1 else ""
            for n, d in zip(names, dots)]
    raw_of = {e: e.lower() in RAW_EXTS for e in dict.fromkeys(exts)}
    raw = np.fromiter(map(raw_of.__getitem__, exts), bool, len(exts))
    # the path up to the end of its stem: the root or parent with its
    # separator, which gives the parent back, then the stem, which has
    # no "/": equal exactly where (str(p.parent), p.stem) is equal
    keys = [s[:i + 1 + len(st)] for s, i, st in zip(paths, cut, stems)]
    return names, stems, exts, raw, _ids(keys)


def _ids(values: list) -> np.ndarray:
    """Each value's id, in order of first appearance."""
    at = dict.fromkeys(values)
    at = dict(zip(at, range(len(at))))
    return np.fromiter(map(at.__getitem__, values), np.int64, len(values))


class _Members:
    """The grouped rows' columns, one entry a member in group order: the
    records and, from one str(path) a member, their names, stems,
    extensions, RAW flags and (parent dir, stem) ids."""

    __slots__ = ("recs", "names", "stems", "exts", "raw", "dir_stem")

    def __init__(self, recs: list[FileRecord], cols=None):
        self.recs = recs
        if cols is None:
            cols = _path_columns(list(map(str, map(_PATH, recs))))
        self.names, self.stems, self.exts, self.raw, self.dir_stem = cols

    def take(self, sel: np.ndarray) -> "_Members":
        idx = sel.tolist()
        return _Members([self.recs[k] for k in idx],
                        ([self.names[k] for k in idx],
                         [self.stems[k] for k in idx],
                         [self.exts[k] for k in idx],
                         self.raw[sel], self.dir_stem[sel]))


def _union_roots(n: int, ei: np.ndarray, ej: np.ndarray) -> np.ndarray:
    """Union-find roots of n nodes under the edges: the native
    path-halving union-find where the library is present."""
    from .. import native
    roots = native.union_find_roots(n, ei, ej)
    if roots is None:
        uf = UnionFind(n)
        uf.union_edges(ei, ej)
        roots = np.fromiter((uf.find(i) for i in range(n)),
                            dtype=np.int64, count=n)
    return roots


def _merge_runs(order_key: np.ndarray, offsets: np.ndarray,
                keys: np.ndarray):
    """Merge the CSR's groups that share a key (scanner.rs:1905-1983):
    (sel, offsets) of the merged groups, sel the members' old positions.
    A merged group stands where its first group stood, its members in
    ascending order_key; None when no two groups share a key."""
    n_groups = len(offsets) - 1
    gid = np.repeat(np.arange(n_groups), np.diff(offsets))
    # each key's first member (np.unique keeps first occurrences) lies in
    # the first group that holds the key: link every holder to it
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    owner = gid[first][inv]
    link = owner != gid
    if not link.any():
        return None
    roots = _union_roots(n_groups, owner[link], gid[link])
    _, lead, comp = np.unique(roots, return_index=True, return_inverse=True)
    rank = np.empty_like(lead)
    rank[np.argsort(lead)] = np.arange(len(lead))
    merged = rank[comp][gid]
    sel = np.lexsort((order_key, merged))
    return sel, np.concatenate(
        ([0], np.cumsum(np.bincount(merged, minlength=len(lead)))))


def merge_groups_by_stem(groups: list[list[int]],
                         files: list[FileRecord]) -> list[list[int]]:
    """Merge groups that share a (parent dir, file stem) pair
    (scanner.rs:1905-1983) so e.g. IMG_1.jpg + IMG_1.nef travel together."""
    if len(groups) < 2:
        return groups
    members = np.fromiter((i for g in groups for i in g), np.int64)
    offsets = np.concatenate(([0], np.cumsum([len(g) for g in groups],
                                             dtype=np.int64)))
    keys = _Members([files[i] for i in members.tolist()]).dir_stem
    got = _merge_runs(members, offsets, keys)
    if got is not None:
        sel, offsets = got
        members = members[sel]
    return [sorted(set(members[a:b].tolist()))
            for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def _rank(values: list) -> np.ndarray:
    """Dense ranks under Python's ordering: equal values share a rank."""
    at = sorted(dict.fromkeys(values))
    at = dict(zip(at, range(len(at))))
    return np.fromiter(map(at.__getitem__, values), np.int64, len(values))


_PATH = attrgetter("path")
_CONTENT = attrgetter("content_hash")
_HASH = attrgetter("pdqhash")
_DIHEDRAL = attrgetter("dihedral")
_STATUS = ("all-identical", "some-identical", "none")
_NO_HASH = bytes(32)
_CHUNK = 1 << 12
_EMPTY = (hash(b""), hash(None))


def _min_variant_distance(hashes: np.ndarray, pivots: np.ndarray,
                          gid: np.ndarray) -> np.ndarray:
    """(M,) the least Hamming distance from each member's hash (M, 32) to
    the 8 variants of its group's pivot (G, 8, 32)."""
    out = np.empty(len(hashes), np.int64)
    h64, p64 = hashes.view(np.uint64), pivots.view(np.uint64)
    for a in range(0, len(hashes), _CHUNK):
        bits = np.bitwise_count(h64[a:a + _CHUNK, None, :]
                                ^ p64[gid[a:a + _CHUNK]])
        out[a:a + _CHUNK] = (bits[..., 0] + bits[..., 1] + bits[..., 2]
                             + bits[..., 3]).min(axis=-1)
    return out


def _content_counts(contents: list, gid: np.ndarray):
    """(counts, hashed): how often each member's content hash occurs in
    its group, and whether it has one.  Only members whose hash() value
    repeats in their group are compared by value."""
    n = len(contents)
    hv = np.fromiter(map(hash, contents), np.int64, n)
    order = np.lexsort((hv, gid))
    gs, vs = gid[order], hv[order]
    same = (gs[1:] == gs[:-1]) & (vs[1:] == vs[:-1])
    cand = order[np.concatenate(([False], same))
                 | np.concatenate((same, [False]))]
    ids = _ids([(g, contents[m])
                for g, m in zip(gid[cand].tolist(), cand.tolist())])
    counts = np.ones(n, np.int64)
    counts[cand] = np.bincount(ids)[ids]
    # empty content_hash means "not hashed", never "identical" — the
    # reference always has a blake3, so its counts can't alias this way
    hashed = np.ones(n, bool)
    for m in np.flatnonzero((hv == _EMPTY[0])
                            | (hv == _EMPTY[1])).tolist():
        hashed[m] = bool(contents[m])
    return counts, hashed


def _analyze(t: _Members, offsets: np.ndarray, sort_order: str, sp=None):
    """Order every group of the CSR t[offsets[g]:offsets[g + 1]] (none
    empty) and compute its info, as analyze_group_with_features
    (scanner.rs:2183-2254) does one group: (groups, max_dist, status),
    each group's records in their final order, status an index into
    _STATUS.

    A group's members whose content hash occurs more than once in it
    come first (by pixel hash, content hash, name), the rest in the
    user's order, then a stable sort by (stem, RAW after processed): one
    lexsort over every member.  max_dist is the largest, over the
    group's hashed members, of the least distance from the member's
    hash to the pivot's 8 variants, the pivot the first member in that
    order with a dihedral set, else the first hash repeated 8 times
    (plain Hamming): one pass over every member."""
    recs = t.recs
    n, n_groups = len(recs), len(offsets) - 1
    if n == 0:
        return [], np.empty(0, np.int64), np.empty(0, np.int64)
    sizes = offsets[1:] - offsets[:-1]
    lead = offsets[:-1]
    gid = np.repeat(np.arange(n_groups), sizes)
    pos = np.arange(n) - lead[gid]
    contents = list(map(_CONTENT, recs))
    cnt, has_content = _content_counts(contents, gid)
    dupe = has_content & (cnt > 1)
    status = np.where(has_content[lead] & (cnt[lead] == sizes), 0,
                      np.where(np.bincount(gid[dupe], minlength=n_groups),
                               1, 2))

    # names are compared only between members of one stem, where they
    # differ in their suffixes alone: the extension's rank orders them
    ext_rank = _rank(t.exts)
    key = np.zeros(n, np.int64)
    tie = pos
    order = sort_order.lower()
    if order == "random":
        # sort_files shuffles each group's unique members
        uniq = np.flatnonzero(~dupe)
        cut = np.searchsorted(gid[uniq], np.arange(n_groups + 1))
        for a, b in zip(cut[:-1].tolist(), cut[1:].tolist()):
            members = uniq[a:b].tolist()
            random.shuffle(members)
            key[members] = np.arange(len(members))
    elif order != "location":
        by, turn = _ORDERS.get(order, _ORDERS["name-natural"])
        key = (ext_rank if by is _by_name
               else _rank(list(map(by, t.names, recs))))
        if turn:
            key = -key
        if turn == "reverse":
            tie = np.where(dupe, pos, -pos)
    d = np.flatnonzero(dupe)
    if len(d):
        key = np.where(dupe, 0, key)
        key[d] = _rank([(recs[m].pixel_hash or b"", contents[m], e)
                        for m, e in zip(d.tolist(), ext_rank[d].tolist())])
    # one lexsort of two keys: (group, stem, RAW, unique) and (key, tie),
    # each packed in an int64 (every part is below n in size)
    perm = np.lexsort(((key + n) * (2 * n + 1) + tie + n,
                       ((gid * n + _rank(t.stems)) * 2 + t.raw) * 2 + ~dupe))
    members = [recs[k] for k in perm.tolist()]

    # member m is the m-th in final order from here on (gid[perm] == gid)
    hashes = list(map(_HASH, members))
    hashed = np.ones(n, bool)
    if None in hashes:
        hashed = np.array([h is not None for h in hashes])
        hashes = [_NO_HASH if h is None else h for h in hashes]
    h = np.frombuffer(b"".join(hashes), np.uint8).reshape(n, 32)
    dih = list(map(_DIHEDRAL, members))
    pivots, plain = [], 0
    bounds = offsets.tolist()
    for a, b in zip(bounds[:-1], bounds[1:]):
        for m in range(a, b):
            if dih[m] is not None:
                pivots.append(dih[m])
                break
        else:
            plain += 1
            first = a + np.flatnonzero(hashed[a:b])[:1]
            pivots.append(np.repeat(h[first if len(first) else [a]], 8,
                                    axis=0))
    dist = np.where(hashed, _min_variant_distance(
        h, np.stack(pivots).astype(np.uint8, copy=False), gid), 0)
    if sp is not None:
        sp.count("rows", n)
        sp.count("plain_pivot", plain)
    return ([members[a:b] for a, b in zip(bounds[:-1], bounds[1:])],
            np.maximum.reduceat(dist, lead), status)


def analyze_group(group: list[FileRecord], sort_order: str) -> GroupInfo:
    """Order a group in place and compute its info, mirroring
    analyze_group_with_features (scanner.rs:2183-2254): bit-identical
    duplicates first (sorted by pixel/content hash then name), the rest in
    user order, then stem-mates adjacent; max_dist is pivot-vs-dihedral.
    The one-group call of _analyze."""
    if not group:
        return GroupInfo()
    (members,), max_dist, status = _analyze(
        _Members(group), np.array([0, len(group)]), sort_order)
    group[:] = members
    return GroupInfo(max_dist=int(max_dist[0]), status=_STATUS[status[0]])


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
    with trace.span("cluster") as sp:
        with trace.span("cluster.components"):
            members, offsets = _component_runs(
                _union_roots(len(files), gi, gj))
        with trace.span("cluster.stem_merge") as sm:
            t = _Members([files[i] for i in members.tolist()])
            got = _merge_runs(members, offsets, t.dir_stem)
            sm.count("merged", 0 if got is None else len(offsets)
                     - len(got[1]))
            if got is not None:
                t, offsets = t.take(got[0]), got[1]

        with trace.span("cluster.analyze") as sa:
            groups, max_dist, status = _analyze(t, offsets, sort_order, sa)
            if sort_order.lower() == "location":
                apply_location_sort(groups)
            # identical first, then max distance, then descending size;
            # lexsort is stable, so ties keep the merged order
            order = np.lexsort((-np.diff(offsets), max_dist, status != 0))
            groups = [groups[k] for k in order.tolist()]
            infos = [GroupInfo(max_dist=d, status=_STATUS[s]) for d, s
                     in zip(max_dist[order].tolist(), status[order].tolist())]
        sp.count("groups", len(groups))
        sp.count("members", len(t.recs))
        return groups, infos, int(len(gi))

"""Plain reference of the library cells: the exact edge set and the
groups, their members' order and their infos, as the tool prints them.

Semantics (scanner.rs, as documented in the program's README and its
grouping module): files i < j pair when the smallest Hamming distance
between any of i's 8 variants and j's hash is at most the similarity,
and exactly 0 when either file is low quality (quality < 50).  Groups
are the connected components of the pairs with two or more members;
groups that share a (directory, file stem) merge.  Within a group, files
whose content hash occurs more than once come first (by pixel hash,
content hash, name), the rest by name, then a stable sort by (stem, is
raw).  A group's max distance is the largest, over its files, of the
smallest distance between the first file's variants and that file's
hash; its status is all-identical (one content hash for all), some-
identical (a content hash shared) or none.  Groups are ordered all-
identical first, then by max distance, then by size, largest first; the
order of groups equal in all three is not specified.

Plain PyTorch (the edges, as +/-1 dot products: float16 on the card,
whose integers up to 2048 are exact, float32 elsewhere) and Python.  It
imports nothing of the program.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

RAW_EXTS = {"nef", "dng", "cr2", "cr3", "arw", "orf", "rw2", "raf",
            "kdc", "dcr", "pef", "x3f", "srf", "3fr"}
MIN_QUALITY = 50


def pm1(var_u8: torch.Tensor, dtype) -> torch.Tensor:
    """(..., nbytes) u8 -> (..., nbytes * 8) +/-1 in dtype."""
    shifts = torch.arange(8, dtype=torch.uint8, device=var_u8.device)
    bits = (var_u8[..., None] >> shifts) & 1
    bits = bits.reshape(var_u8.shape[:-1] + (var_u8.shape[-1] * 8,))
    return bits.to(dtype) * 2 - 1


def edges(var: np.ndarray, low: np.ndarray, sim: int, device,
          identity_only: bool = False, tq: int = 2048, tb: int = 65536):
    """(ei, ej) int64 arrays, i < j, sorted, of every pair within `sim`
    (identity_only: the control, which matches the identity variants
    alone)."""
    if identity_only:
        var = var[:, :1]
    n, v, nbytes = var.shape
    nbits = nbytes * 8
    dt = torch.float16 if device.type == "cuda" else torch.float32
    x = pm1(torch.from_numpy(np.ascontiguousarray(var)).to(device), dt)
    base = x[:, 0].contiguous()                      # (n, nbits)
    low_d = torch.from_numpy(np.asarray(low, bool)).to(device)
    need_good = nbits - 2 * sim
    out_i, out_j = [], []
    for q0 in range(0, n, tq):
        q1 = min(n, q0 + tq)
        q = x[q0:q1].reshape(-1, nbits)               # ((q1-q0) * v, nbits)
        for b0 in range(q0, n, tb):
            b1 = min(n, b0 + tb)
            dots = (q @ base[b0:b1].T).view(q1 - q0, v, b1 - b0)
            best = dots.amax(dim=1)
            lowpair = low_d[q0:q1, None] | low_d[None, b0:b1]
            m = best >= torch.where(lowpair, nbits, need_good).to(best.dtype)
            ii = torch.arange(q0, q1, device=device)[:, None]
            jj = torch.arange(b0, b1, device=device)[None, :]
            m &= jj > ii
            qi, bj = torch.nonzero(m, as_tuple=True)
            if qi.numel():
                out_i.append((qi + q0).cpu())
                out_j.append((bj + b0).cpu())
    del x, base
    if not out_i:
        e = np.empty(0, np.int64)
        return e, e.copy()
    ei = torch.cat(out_i).numpy().astype(np.int64)
    ej = torch.cat(out_j).numpy().astype(np.int64)
    order = np.lexsort((ej, ei))
    return ei[order], ej[order]


def _components(ei, ej):
    parent: dict[int, int] = {}

    def find(a):
        root = a
        while parent.get(root, root) != root:
            root = parent[root]
        while a != root:
            parent[a], a = root, parent.get(a, a)
        return root

    for a, b in zip(ei.tolist(), ej.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps: dict[int, list[int]] = {}
    for a in sorted(set(ei.tolist()) | set(ej.tolist())):
        comps.setdefault(find(a), []).append(a)
    return list(comps.values())


def _split(path: str):
    d, name = path.rsplit("/", 1)
    stem, dot, ext = name.rpartition(".")
    if not dot:
        stem, ext = name, ""
    return d, name, stem, ext.lower()


def _popcount_min(pivot_var: np.ndarray, h: np.ndarray) -> int:
    x = np.bitwise_xor(pivot_var, h[None, :])
    return int(np.unpackbits(x, axis=-1).sum(axis=-1).min())


def groups(ei, ej, paths: list[str], content: list[bytes],
           var: np.ndarray) -> list[tuple]:
    """[(member paths in order, max distance, status), ...] in the tool's
    order (groups equal in the sort key by their smallest file index)."""
    comps = _components(ei, ej)
    # merge groups that share (directory, stem)
    owner: dict[tuple, int] = {}
    gparent = list(range(len(comps)))

    def gfind(a):
        while gparent[a] != a:
            gparent[a] = gparent[gparent[a]]
            a = gparent[a]
        return a

    for g, members in enumerate(comps):
        for i in members:
            d, _, stem, _ = _split(paths[i])
            key = (d, stem)
            if key in owner:
                ra, rb = gfind(owner[key]), gfind(g)
                if ra != rb:
                    gparent[max(ra, rb)] = min(ra, rb)
            else:
                owner[key] = g
    merged: dict[int, set] = {}
    for g, members in enumerate(comps):
        merged.setdefault(gfind(g), set()).update(members)

    out = []
    for members in merged.values():
        members = sorted(members)
        counts = Counter(content[i] for i in members)
        name = lambda i: _split(paths[i])[1]
        dupes = sorted((i for i in members if counts[content[i]] > 1),
                       key=lambda i: (b"", content[i], name(i)))
        unique = sorted((i for i in members if counts[content[i]] <= 1),
                        key=name)
        order = dupes + unique
        order.sort(key=lambda i: (_split(paths[i])[2],
                                  _split(paths[i])[3] in RAW_EXTS))
        pivot = var[order[0]]
        max_d = max(_popcount_min(pivot, var[i, 0]) for i in order)
        if len(counts) == 1:
            status = "all-identical"
        elif any(c > 1 for c in counts.values()):
            status = "some-identical"
        else:
            status = "none"
        out.append((tuple(paths[i] for i in order), max_d, status,
                    members[0]))
    out.sort(key=lambda g: (sort_key(g), g[3]))
    return [g[:3] for g in out]


def sort_key(g) -> tuple:
    """The tool's group order: all-identical first, max distance, size."""
    paths_, max_d, status = g[:3]
    return (0 if status == "all-identical" else 1, max_d, -len(paths_))


def compare(prog: list[tuple], prog_edges: int, ref: list[tuple],
            ref_edges: int) -> dict:
    """The numbers compared: groups that differ (members, their order or
    info; counted on both sides), adjacent groups out of the tool's
    order, and the gap between the edge counts."""
    cp, cr = Counter(prog), Counter(ref)
    off = sum((cp - cr).values()) + sum((cr - cp).values())
    breaks = sum(1 for a, b in zip(prog, prog[1:])
                 if sort_key(a) > sort_key(b))
    return {"groups_off": off, "order_breaks": breaks,
            "edge_count_gap": abs(int(prog_edges) - int(ref_edges))}

"""Directory walking and file identity.

Mirrors scan_and_group's collection phase (scanner.rs:1158-1176):
recursive walk, canonicalize + dedup (the same file reached through two
CLI paths or symlinks is scanned once), image-extension gate, and
hardlink identity via (dev, inode) (scanner.rs:1526-1540).
"""

from __future__ import annotations

import os
from pathlib import Path

from . import decode


def collect_files(paths, recursive: bool = True):
    """Walk the given files/directories; returns a sorted list of unique
    canonical Paths that look like images.

    Canonicalization is done per *directory* (one realpath per dirpath,
    not per file): a regular directory entry's canonical path is the
    canonical dirpath joined with its name, so only symlinked entries
    pay a full per-file realpath.  At 1M files the per-file realpath
    was ~28% of a warm rescan (each call re-resolves every path
    component through syscalls)."""
    seen: set[str] = set()
    out: list[str] = []

    def add_canon(canon: str):
        if canon in seen or not decode.is_image_ext(canon):
            return
        seen.add(canon)
        out.append(canon)

    def add_entry(dir_canon: str, name: str, is_symlink: bool):
        if not is_symlink:
            # regular entry: canonical path == canonical dir + name, and
            # the extension gate can run on the name directly
            add_canon(os.path.join(dir_canon, name))
            return
        try:
            add_canon(os.path.realpath(os.path.join(dir_canon, name)))
        except OSError:
            pass

    def scan_dir(root: str):
        # explicit stack, not recursion: os.walk handled arbitrarily
        # deep trees and so must this
        stack = [root]
        while stack:
            dirpath = stack.pop()
            try:
                dir_canon = os.path.realpath(dirpath)
                with os.scandir(dirpath) as it:
                    entries = sorted(it, key=lambda e: e.name)
            except OSError:
                continue
            subdirs = []
            for e in entries:
                try:
                    if e.is_dir(follow_symlinks=False):
                        # directory symlinks are not followed (os.walk
                        # semantics; loop-safe)
                        subdirs.append(e.path)
                    elif e.is_file(follow_symlinks=True):
                        add_entry(dir_canon, e.name, e.is_symlink())
                except OSError:
                    continue
            if recursive:
                stack.extend(reversed(subdirs))

    for root in paths:
        root = Path(root)
        if root.is_file():
            try:
                add_canon(os.path.realpath(root))
            except OSError:
                pass
        elif root.is_dir():
            scan_dir(str(root))
    out.sort()
    return [Path(c) for c in out]


def dedup_hardlinks(records):
    """Given FileRecords with unique_file_id set, return the hardlink
    groups as {unique_file_id: [records]} for every id with more than
    one path (scanner.rs:1526-1540).  The scan's actual dedup happens
    in pipeline/scan.py's prepass; this is the reporting helper."""
    by_id: dict[int, list] = {}
    for r in records:
        by_id.setdefault(r.unique_file_id, []).append(r)
    groups = {fid: rs for fid, rs in by_id.items() if len(rs) > 1}
    return groups

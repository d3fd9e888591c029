"""Filesystem watcher for the viewer session.

The reference watches scanned directories with the `notify` crate and
debounces events into state refreshes (gui/app.rs:994-1443): externally
deleted files drop out of the list, other changes surface to the user.
No inotify binding ships in this image, so this is a polling watcher —
a snapshot diff of (path -> mtime_ns, size) taken every `interval`
seconds, which is the same debounced-batch shape the reference ends up
with after coalescing events.

On each tick:
  * files in the session that vanished -> dropped from AppState (the
    reference's remove handling), status message
  * new/modified files under the watched roots -> status nudge to
    rescan (the reference re-triggers check_reload; a web session
    refreshes on the next scan)
"""

from __future__ import annotations

import os
import threading
from pathlib import Path


def _snapshot(roots, recursive=True):
    from ..pipeline import decode

    snap = {}

    def _add(path, st):
        # session records hold realpath'd absolute paths (walker),
        # so the snapshot must canonicalize too or external deletions
        # of files under relative/symlinked roots never match; only
        # image types count — churning logs/downloads in a watched
        # tree would otherwise nudge "rescan" forever
        if decode.is_image_ext(path):
            snap[os.path.realpath(path)] = (st.st_mtime_ns, st.st_size)

    def _scan_dir(d):
        try:
            it = os.scandir(d)
        except OSError:
            return
        with it:
            for e in it:
                try:
                    if e.is_file(follow_symlinks=False):
                        _add(e.path, e.stat(follow_symlinks=False))
                    elif recursive and e.is_dir(follow_symlinks=False):
                        _scan_dir(e.path)
                except OSError:
                    continue

    for root in roots:
        try:
            if os.path.isfile(root):  # a root may be a plain file
                _add(root, os.stat(root))
                continue
        except OSError:
            continue
        _scan_dir(root)
    return snap


class Watcher:
    def __init__(self, server, roots, interval: float = 2.0,
                 recursive: bool = True):
        self.server = server
        self.roots = [os.path.realpath(str(Path(r))) for r in roots]
        self.interval = interval
        self.recursive = recursive
        self._mutex = threading.Lock()   # tick vs retarget
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._snap = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def retarget(self, roots):
        """Atomically watch a different set of roots."""
        with self._mutex:
            self.roots = [os.path.realpath(str(r)) for r in roots]
            self._snap = None

    def tick(self):
        """One diff pass (exposed for tests)."""
        with self._mutex:
            roots = list(self.roots)
        snap = _snapshot(roots, self.recursive)
        with self._mutex:
            if roots != self.roots:
                return  # retargeted mid-scan: discard stale snapshot
            if self._snap is None:
                self._snap = snap
                return
            old, self._snap = self._snap, snap
        gone = old.keys() - snap.keys()
        changed = {p for p in (snap.keys() & old.keys())
                   if snap[p] != old[p]}
        new = snap.keys() - old.keys()
        if gone:
            self._drop(gone)
        if new or changed:
            with self.server.lock:
                self.server.state.status = (
                    f"directory changed ({len(new)} new, "
                    f"{len(changed)} modified) — rescan to refresh")
                self.server.rev += 1
                self.server.data_rev += 1

    def _drop(self, gone: set[str]):
        srv = self.server
        with srv.lock:
            st = srv.state
            gone_paths = {Path(p) for p in gone}
            # external deletion: the session-state cleanup path
            # (cursor preservation, singleton-group removal)
            st._drop_paths(gone_paths)
            st.status = f"{len(gone_paths)} file(s) removed externally"
            srv.rev += 1
            srv.data_rev += 1

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                pass

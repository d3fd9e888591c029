"""Shared session state and input intents (L6 of the layer map).

Frontends translate keystrokes into InputIntent values; AppState applies
them.  This mirrors src/state.rs (AppState + InputIntent + mutation
methods): navigation (including flattened-row paging), marking,
delete/trash with confirm, TOCTOU-safe move, rename, re-sort preserving
selection, filename search with wraparound, per-file transforms, and
ignore intents that feed the cache's ignore API.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from pathlib import Path

from .grouping import engine
from .utils import fileops


class Intent(enum.Enum):
    NEXT_ITEM = "next_item"
    PREV_ITEM = "prev_item"
    NEXT_GROUP = "next_group"
    PREV_GROUP = "prev_group"
    PAGE_DOWN = "page_down"
    PAGE_UP = "page_up"
    HOME = "home"
    END = "end"
    TOGGLE_MARK = "toggle_mark"
    MARK_GROUP = "mark_group"
    UNMARK_ALL = "unmark_all"
    CONFIRM_DELETE = "confirm_delete"
    EXECUTE_DELETE = "execute_delete"
    DELETE_IMMEDIATE = "delete_immediate"
    MOVE_MARKED = "move_marked"
    CANCEL = "cancel"
    QUIT = "quit"
    TOGGLE_RELATIVE_TIME = "toggle_relative_time"
    START_RENAME = "start_rename"
    SUBMIT_RENAME = "submit_rename"
    CHANGE_SORT = "change_sort"
    NEXT_GROUP_BY_DIST = "next_group_by_dist"
    PREV_GROUP_BY_DIST = "prev_group_by_dist"
    START_SEARCH = "start_search"
    SUBMIT_SEARCH = "submit_search"
    NEXT_SEARCH = "next_search"
    PREV_SEARCH = "prev_search"
    IGNORE_CURRENT = "ignore_current"
    IGNORE_GROUP = "ignore_group"
    SET_MOVE_TARGET = "set_move_target"
    SELECT = "select"
    ROTATE_CW = "rotate_cw"
    FLIP_H = "flip_h"
    FLIP_V = "flip_v"
    RESET_TRANSFORM = "reset_transform"
    TOGGLE_USE_TRASH = "toggle_use_trash"


@dataclasses.dataclass
class FileTransform:
    """Per-file manual view transform (state.rs FileTransform)."""
    quarter_turns: int = 0
    flip_h: bool = False
    flip_v: bool = False


class AppState:
    """Groups + cursor + marks + modal flags; mutation methods mirror
    state.rs:246-1179.  Frontends render from this, never mutate it
    directly."""

    PAGE = 20

    def __init__(self, groups, infos, use_trash=False, move_target=None,
                 sort_order="name", relative_times=False, store=None,
                 keep_singletons=False):
        self.groups: list[list[engine.FileRecord]] = groups
        self.infos: list[engine.GroupInfo] = infos
        self.cursor_group = 0
        self.cursor_file = 0
        self.marked: set[Path] = set()
        self.use_trash = use_trash
        self.move_target = move_target
        self.sort_order = sort_order
        self.relative_times = relative_times
        self.store = store
        # view mode keeps one flat listing alive down to its last file;
        # dupe mode prunes groups that fall to a single member
        self.keep_singletons = keep_singletons
        self.status = ""
        self.quit = False
        # "delete" | "delete-one" | "move" | "ignore-group"
        self.pending_confirm: str | None = None
        self.search_pattern: str | None = None
        self.transforms: dict[int, FileTransform] = {}  # by unique_file_id
        self._rows: list[tuple[int, int]] = []
        self._offsets: list[int] = [0]
        self._rebuild()

    # -- internal ------------------------------------------------------------
    def _rebuild(self):
        self._rows = [(gi, fi) for gi, g in enumerate(self.groups)
                      for fi in range(len(g))]
        # prefix sums of group sizes so flat_cursor is O(1) per keystroke
        # (the reference virtualizes with the same cached per-group
        # offsets, gui/app.rs:3080-3260)
        self._offsets = [0] * (len(self.groups) + 1)
        for gi, g in enumerate(self.groups):
            self._offsets[gi + 1] = self._offsets[gi] + len(g)
        if not self._rows:
            self.cursor_group = self.cursor_file = 0
            return
        if self.cursor_group >= len(self.groups):
            self.cursor_group = len(self.groups) - 1
            self.cursor_file = 0
        self.cursor_file = min(self.cursor_file,
                               len(self.groups[self.cursor_group]) - 1)

    @property
    def rows(self):
        return self._rows

    @property
    def flat_cursor(self) -> int:
        if not self._rows:
            return 0
        return self._offsets[self.cursor_group] + self.cursor_file

    def current(self):
        if not self.groups:
            return None
        return self.groups[self.cursor_group][self.cursor_file]

    def _move_flat(self, delta: int):
        if not self._rows:
            return
        k = max(0, min(len(self._rows) - 1, self.flat_cursor + delta))
        self.cursor_group, self.cursor_file = self._rows[k]

    def _move_group(self, delta: int):
        if not self.groups:
            return
        self.cursor_group = max(0, min(len(self.groups) - 1,
                                       self.cursor_group + delta))
        self.cursor_file = 0

    # -- mutations -----------------------------------------------------------
    def _toggle_mark(self):
        f = self.current()
        if f is None:
            return
        if f.path in self.marked:
            self.marked.discard(f.path)
        else:
            self.marked.add(f.path)
        self._move_flat(1)

    def _delete_marked(self):
        deleted = set()
        failed = 0
        for path in sorted(self.marked):
            try:
                fileops.delete_file(path, self.use_trash)
                deleted.add(path)
            except OSError:
                failed += 1
        # only successful deletions leave the view: a file that failed
        # to delete still exists on disk and must stay visible (and
        # marked) so the user can see it and retry (state.rs parity)
        self._drop_paths(deleted)
        verb = "trashed" if self.use_trash else "deleted"
        self.status = f"{verb} {len(deleted)} files" + (
            f" ({failed} failed)" if failed else "")

    def _delete_current(self):
        f = self.current()
        if f is None:
            return
        try:
            fileops.delete_file(f.path, self.use_trash)
            self._drop_paths({f.path})
            self.status = "removed 1 file"
        except OSError as e:
            self.status = f"delete failed: {e}"

    def _move_marked(self):
        if not self.move_target:
            self.status = "no move target configured"
            return
        moved = set()
        for path in sorted(self.marked):
            try:
                fileops.safe_move(path, self.move_target)
                moved.add(path)
            except OSError:
                pass
        self._drop_paths(moved)
        self.marked -= moved
        self.status = f"moved {len(moved)} files to {self.move_target}"

    def _drop_paths(self, paths: set[Path]):
        # whatever leaves the view must leave the mark set too — a
        # stale marked path would be invisibly deleted by a later
        # delete-marked (ignore/delete/rename all route through here)
        self.marked -= paths
        cur = self.current()
        new_groups, new_infos = [], []
        min_keep = 0 if self.keep_singletons else 1
        for g, inf in zip(self.groups, self.infos):
            g2 = [f for f in g if f.path not in paths]
            if len(g2) > min_keep:
                new_groups.append(g2)
                new_infos.append(inf)
        self.groups, self.infos = new_groups, new_infos
        self._rebuild()
        if cur is not None:  # try to keep selection on the same file
            for gi, g in enumerate(self.groups):
                for fi, f in enumerate(g):
                    if f.path == cur.path:
                        self.cursor_group, self.cursor_file = gi, fi
                        return

    def _rename_current(self, new_name: str):
        f = self.current()
        if f is None or not new_name or "/" in new_name:
            self.status = "invalid name"
            return
        dst = f.path.parent / new_name
        if dst.exists():
            self.status = "target exists"
            return
        try:
            old = f.path
            old.rename(dst)
            f.path = dst
            if old in self.marked:  # the mark follows the file
                self.marked.discard(old)
                self.marked.add(dst)
            self.status = f"renamed to {new_name}"
        except OSError as e:
            self.status = f"rename failed: {e}"

    def _resort(self, order: str):
        """Re-sort groups preserving selection (state.rs:683-707)."""
        cur = self.current()
        self.sort_order = order
        for i, g in enumerate(self.groups):
            self.infos[i] = engine.analyze_group(g, order)
        if order.lower() == "location":
            # global GPS-path order across all markers (gui/app.rs:242)
            engine.apply_location_sort(self.groups)
        self._rebuild()
        if cur is not None:
            self._select_path(cur.path)

    def _select_path(self, path: Path) -> bool:
        for gi, g in enumerate(self.groups):
            for fi, f in enumerate(g):
                if f.path == path:
                    self.cursor_group, self.cursor_file = gi, fi
                    return True
        return False

    def _search(self, pattern: str | None, direction: int = 1):
        """Filename regex search with substring fallback
        (state.rs:957-1031)."""
        if pattern is not None:
            self.search_pattern = pattern
        if not self.search_pattern or not self._rows:
            return
        pat = self.search_pattern
        try:
            rx = re.compile(pat, re.IGNORECASE)
            match = lambda name: rx.search(name) is not None
        except re.error:
            low = pat.lower()
            match = lambda name: low in name.lower()
        n = len(self._rows)
        start = self.flat_cursor
        for step in range(1, n + 1):
            k = (start + direction * step) % n
            gi, fi = self._rows[k]
            if match(self.groups[gi][fi].path.name):
                self.cursor_group, self.cursor_file = gi, fi
                self.status = ""
                return
        self.status = f"no match for {pat!r}"

    def _group_by_dist(self, direction: int):
        """Jump to the next/prev group with a different max distance
        (state.rs NextGroupByDist)."""
        if not self.groups:
            return
        cur_d = self.infos[self.cursor_group].max_dist
        gi = self.cursor_group
        while 0 <= gi + direction < len(self.groups):
            gi += direction
            if self.infos[gi].max_dist != cur_d:
                break
        self.cursor_group, self.cursor_file = gi, 0

    def _ignore(self, whole_group: bool):
        """Persist ignore flags through the cache store
        (dialogs.rs:1611 perform_ignore_group)."""
        if self.store is None:
            self.status = "no cache store; cannot ignore"
            return
        if whole_group:
            if not self.groups:
                return
            targets = list(self.groups[min(self.cursor_group,
                                           len(self.groups) - 1)])
        elif self.marked:
            targets = [f for g in self.groups for f in g
                       if f.path in self.marked]
        else:
            targets = [self.current()] if self.current() else []
        hashes = [f.content_hash for f in targets if f.content_hash]
        n = self.store.set_files_ignored(hashes)
        self._drop_paths({f.path for f in targets})
        self.status = f"ignored {n} files"

    def _transform(self, fn):
        f = self.current()
        if f is None:
            return
        t = self.transforms.setdefault(f.unique_file_id, FileTransform())
        fn(t)

    # -- intent dispatch -------------------------------------------------------
    def handle_input(self, intent: Intent, arg=None):
        """Apply one intent (state.rs:246 handle_input)."""
        if self.pending_confirm:
            pc, self.pending_confirm = self.pending_confirm, None
            if intent == Intent.EXECUTE_DELETE and pc == "delete":
                self._delete_marked()
            elif intent in (Intent.EXECUTE_DELETE, Intent.DELETE_IMMEDIATE) \
                    and pc == "delete-one":
                self._delete_current()
            elif intent == Intent.MOVE_MARKED and pc == "move":
                self._move_marked()
            elif intent == Intent.IGNORE_GROUP and pc == "ignore-group":
                self._ignore(whole_group=True)
            else:
                self.status = "cancelled"
            return

        match intent:
            case Intent.NEXT_ITEM:
                self._move_flat(1)
            case Intent.PREV_ITEM:
                self._move_flat(-1)
            case Intent.NEXT_GROUP:
                self._move_group(1)
            case Intent.PREV_GROUP:
                self._move_group(-1)
            case Intent.PAGE_DOWN:
                self._move_flat(self.PAGE)
            case Intent.PAGE_UP:
                self._move_flat(-self.PAGE)
            case Intent.HOME:
                self._move_flat(-10**9)
            case Intent.END:
                self._move_flat(10**9)
            case Intent.TOGGLE_MARK:
                self._toggle_mark()
            case Intent.MARK_GROUP:
                if self.groups:  # scan may still be streaming in
                    gi = min(self.cursor_group, len(self.groups) - 1)
                    for f in self.groups[gi]:
                        self.marked.add(f.path)
            case Intent.UNMARK_ALL:
                self.marked.clear()
            case Intent.CONFIRM_DELETE:
                if self.marked:
                    self.pending_confirm = "delete"
            # Destructive intents only ARM the confirm gate here; the
            # action runs solely from inside it (state.rs:374-389 opens a
            # confirm modal, deletion happens only within).  This also
            # stops a blind unconfirmed intent sequence over the GUI's
            # HTTP API from deleting files.
            case Intent.EXECUTE_DELETE:
                if self.marked:
                    self.pending_confirm = "delete"
            case Intent.DELETE_IMMEDIATE:
                if self.current() is not None:
                    self.pending_confirm = "delete-one"
            case Intent.MOVE_MARKED:
                if not self.move_target:
                    self.status = "no move target configured"
                elif self.marked:
                    self.pending_confirm = "move"
            case Intent.SELECT:
                # direct cursor placement (GUI row click)
                try:
                    gi, fi = int(arg[0]), int(arg[1])
                except (TypeError, ValueError, IndexError):
                    return
                if 0 <= gi < len(self.groups) and \
                        0 <= fi < len(self.groups[gi]):
                    self.cursor_group, self.cursor_file = gi, fi
            case Intent.SET_MOVE_TARGET:
                # the GUI/TUI move-dir dialog (gui/dialogs.rs dir picker)
                p = Path(arg).expanduser() if arg else None
                if p is not None and p.is_dir():
                    self.move_target = p
                    self.status = f"move target: {p}"
                else:
                    self.status = f"not a directory: {arg}"
            case Intent.QUIT:
                self.quit = True
            case Intent.CANCEL:
                self.pending_confirm = None
            case Intent.TOGGLE_RELATIVE_TIME:
                self.relative_times = not self.relative_times
            case Intent.TOGGLE_USE_TRASH:
                self.use_trash = not self.use_trash
            case Intent.SUBMIT_RENAME:
                self._rename_current(arg or "")
            case Intent.CHANGE_SORT:
                self._resort(arg or "name")
            case Intent.SUBMIT_SEARCH:
                self._search(arg, 1)
            case Intent.NEXT_SEARCH:
                self._search(None, 1)
            case Intent.PREV_SEARCH:
                self._search(None, -1)
            case Intent.NEXT_GROUP_BY_DIST:
                self._group_by_dist(1)
            case Intent.PREV_GROUP_BY_DIST:
                self._group_by_dist(-1)
            case Intent.IGNORE_CURRENT:
                self._ignore(whole_group=False)
            case Intent.IGNORE_GROUP:
                self.pending_confirm = "ignore-group"
            case Intent.ROTATE_CW:
                self._transform(lambda t: setattr(
                    t, "quarter_turns", (t.quarter_turns + 1) % 4))
            case Intent.FLIP_H:
                self._transform(lambda t: setattr(t, "flip_h", not t.flip_h))
            case Intent.FLIP_V:
                self._transform(lambda t: setattr(t, "flip_v", not t.flip_v))
            case Intent.RESET_TRANSFORM:
                f = self.current()
                if f is not None:
                    self.transforms.pop(f.unique_file_id, None)
            case _:
                pass

"""Terminal UI: grouped duplicate browser on the shared AppState.

A curses re-creation of the reference TUI (src/ui.rs): grouped list with
color coding (marked=magenta, bit-identical=green), mark/unmark,
delete/trash with confirm modal, move-marked with a directory dialog,
rename — both with Tab path completion cycling candidates exactly like
ui.rs:102-432 — a numbered sort-selection menu, filename regex search,
relative/absolute time toggle, and ignore management.  All mutations go
through state.AppState.handle_input — the TUI only renders and maps
keys to intents (L7 -> L6).  Keymap documented in docs/KEYS.md.
"""

from __future__ import annotations

import curses
import os
import time
from pathlib import Path

from .state import AppState, Intent

# ui.rs:305-335 sort-selection menu entries, same digits
SORT_MENU = ["name", "name-desc", "name-natural", "name-natural-desc",
             "date", "date-desc", "size", "size-desc", "random"]


def _fmt_time(mtime: float, relative: bool) -> str:
    if not mtime:
        return "?"
    if not relative:
        return time.strftime("%Y-%m-%d %H:%M", time.localtime(mtime))
    dt = max(0.0, time.time() - mtime)
    for unit, secs in (("y", 31557600), ("mo", 2629800), ("d", 86400),
                       ("h", 3600), ("m", 60)):
        if dt >= secs:
            return f"{dt / secs:.0f}{unit} ago"
    return "just now"


def _draw(stdscr, st: AppState, offset: int) -> int:
    from .cli import format_size

    h, w = stdscr.getmaxyx()
    stdscr.erase()
    visible = h - 2
    cur = st.flat_cursor
    if cur < offset:
        offset = cur
    else:
        # the draw loop emits one header line per group whose first
        # row is inside the window, so 'cur - offset < visible' is not
        # enough — find the furthest-back start whose draw lines
        # (files + headers) still fit the cursor on screen
        lines = 0
        s = cur
        k = cur
        while k >= 0:
            add = 2 if (k < len(st.rows) and st.rows[k][1] == 0) else 1
            if lines + add > visible:
                break
            lines += add
            s = k
            k -= 1
        if offset < s:
            offset = s

    row = 0
    last_group = -1
    k = offset
    # per-viewport duplicate/hardlink detection (ui.rs:463-556 colors:
    # marked=magenta, hardlink=cyan, bit-identical=green)
    group_stats: dict[int, tuple[dict, dict]] = {}

    def stats_for(gi: int):
        if gi not in group_stats:
            idc: dict[bytes, int] = {}
            lnk: dict[int, int] = {}
            for m in st.groups[gi]:
                if m.content_hash:
                    idc[m.content_hash] = idc.get(m.content_hash, 0) + 1
                lnk[m.unique_file_id] = lnk.get(m.unique_file_id, 0) + 1
            group_stats[gi] = (idc, lnk)
        return group_stats[gi]

    while row < visible and k < len(st.rows):
        gi, fi = st.rows[k]
        g = st.groups[gi]
        if gi != last_group and fi == 0:
            info = st.infos[gi]
            hdr = (f"-- Group {gi + 1} (max dist {info.max_dist}, "
                   f"{info.status}) --")
            stdscr.addnstr(row, 0, hdr, w - 1, curses.A_BOLD)
            row += 1
            last_group = gi
            if row >= visible:
                break
        f = g[fi]
        sel = (gi, fi) == (st.cursor_group, st.cursor_file)
        attrs = curses.A_REVERSE if sel else curses.A_NORMAL
        idc, lnk = stats_for(gi)
        if f.path in st.marked:
            attrs |= curses.color_pair(1)
        elif lnk.get(f.unique_file_id, 0) > 1:
            attrs |= curses.color_pair(3)        # hardlink
        elif f.content_hash and idc.get(f.content_hash, 0) > 1:
            attrs |= curses.color_pair(2)        # bit-identical
        marker = ("M" if f.path in st.marked
                  else "L" if lnk.get(f.unique_file_id, 0) > 1 else " ")
        res = f"{f.resolution[0]}x{f.resolution[1]}" if f.resolution else "?"
        when = _fmt_time(f.modified, st.relative_times)
        line = (f" [{marker}] {when:>16} {format_size(f.size):>10} "
                f"{res:>10}  {f.path}")
        stdscr.addnstr(row, 0, line, w - 1, attrs)
        row += 1
        k += 1

    mode = "trash" if st.use_trash else "delete"
    if st.pending_confirm == "delete":
        bar = (f" {mode.upper()} {len(st.marked)} marked files? "
               f"y=yes  any other key=no")
    elif st.pending_confirm == "delete-one":
        bar = f" {mode.upper()} current file? y=yes  any other key=no"
    elif st.pending_confirm == "move":
        bar = (f" Move {len(st.marked)} marked to {st.move_target}? "
               f"y=yes  any other key=no")
    elif st.pending_confirm == "ignore-group":
        bar = " Ignore whole group? y=yes  any other key=no"
    else:
        bar = (f" {len(st.groups)} groups | {len(st.marked)} marked | "
               f"sort:{st.sort_order} | mode:{mode} | "
               f"m mark  d {mode}  q ignore  / search  ? keys  z quit")
    stdscr.addnstr(h - 2, 0, bar[:w - 1], w - 1, curses.A_REVERSE)
    stdscr.addnstr(h - 1, 0, st.status[:w - 1], w - 1)
    stdscr.refresh()
    return offset


class _Completer:
    """Tab completion cycling sorted candidates, re-scanning only when
    the buffer no longer equals the candidate just applied — the exact
    ui.rs:110-255 behavior for both the rename and move dialogs."""

    def __init__(self, scan):
        self.scan = scan          # buffer -> sorted candidate list
        self.candidates: list[str] = []
        self.index = 0

    def next(self, buffer: str) -> str:
        prev = ((self.index + len(self.candidates) - 1)
                % len(self.candidates)) if self.candidates else 0
        fresh = not self.candidates or self.candidates[prev] != buffer
        if fresh:
            self.candidates = self.scan(buffer)
            self.index = 0
        if not self.candidates:
            return buffer
        out = self.candidates[self.index]
        self.index = (self.index + 1) % len(self.candidates)
        return out


def complete_rename(parent: Path):
    """Candidates = names in the file's directory with the buffer as
    prefix (ui.rs:210-255)."""
    def scan(buffer: str) -> list[str]:
        try:
            return sorted(e.name for e in os.scandir(parent)
                          if e.name.startswith(buffer))
        except OSError:
            return []
    return scan


def complete_move(buffer_ignored=None):
    """Directory-only completion over full paths (ui.rs:131-186)."""
    def scan(buffer: str) -> list[str]:
        p = Path(buffer) if buffer else Path(".")
        if buffer.endswith(os.sep):
            parent, prefix = p, ""
        else:
            parent, prefix = (p.parent if str(p.parent) else Path(".")),\
                p.name
        try:
            return sorted(str(e.path) for e in os.scandir(parent)
                          if e.is_dir(follow_symlinks=False)
                          and (e.name.startswith(prefix)
                               or str(e.path).startswith(buffer)))
        except OSError:
            return []
    return scan


def _prompt(stdscr, text: str, initial: str = "",
            completer: _Completer | None = None) -> str | None:
    """Modal line editor: chars/backspace/Enter; Esc cancels (None);
    Tab cycles completions when a completer is given."""
    h, w = stdscr.getmaxyx()
    buf = initial
    curses.curs_set(1)
    try:
        while True:
            line = (text + buf)[: w - 1]
            stdscr.addnstr(h - 1, 0, line + " " * (w - 1 - len(line)),
                           w - 1, curses.A_REVERSE)
            stdscr.move(h - 1, min(len(text) + len(buf), w - 2))
            stdscr.refresh()
            # get_wch: multi-byte UTF-8 arrives as a complete str
            # (plain getch() returns the raw bytes one at a time, so
            # typing 'é' in a rename dialog produced mojibake); curses
            # keycodes for arrows/F-keys arrive as ints and are ignored
            try:
                ch = stdscr.get_wch()
            except curses.error:
                continue
            if isinstance(ch, int):
                if ch == curses.KEY_ENTER:
                    return buf
                if ch == curses.KEY_BACKSPACE:
                    buf = buf[:-1]
                continue
            if ch == "\x1b":                     # Esc
                return None
            if ch in ("\n", "\r"):
                return buf
            if ch in ("\x7f", "\b"):
                buf = buf[:-1]
            elif ch == "\t" and completer is not None:
                buf = completer.next(buf)
            elif ch >= " " and ch != "\t":
                buf += ch
    finally:
        curses.curs_set(0)


def _sort_menu(stdscr) -> str | None:
    """Numbered sort-selection modal (ui.rs:303-336)."""
    h, w = stdscr.getmaxyx()
    lines = [f"  {i + 1}  {name}" for i, name in enumerate(SORT_MENU)]
    top = max(0, h - len(lines) - 3)
    stdscr.addnstr(top, 0, " Sort order:".ljust(w - 1), w - 1,
                   curses.A_REVERSE)
    for i, ln in enumerate(lines):
        if top + 1 + i < h - 1:
            stdscr.addnstr(top + 1 + i, 0, ln, w - 1)
    stdscr.refresh()
    while True:
        ch = stdscr.getch()
        if ch in (27, ord("n")):
            return None
        if ord("1") <= ch <= ord("9"):
            return SORT_MENU[ch - ord("1")]


_KEYMAP = {
    curses.KEY_DOWN: Intent.NEXT_ITEM, ord("j"): Intent.NEXT_ITEM,
    curses.KEY_UP: Intent.PREV_ITEM, ord("k"): Intent.PREV_ITEM,
    curses.KEY_RIGHT: Intent.NEXT_GROUP, ord("l"): Intent.NEXT_GROUP,
    curses.KEY_LEFT: Intent.PREV_GROUP, ord("h"): Intent.PREV_GROUP,
    curses.KEY_NPAGE: Intent.PAGE_DOWN, curses.KEY_PPAGE: Intent.PAGE_UP,
    ord("\t"): Intent.NEXT_GROUP, curses.KEY_BTAB: Intent.PREV_GROUP,
    curses.KEY_HOME: Intent.HOME, curses.KEY_END: Intent.END,
    ord("g"): Intent.HOME, ord("G"): Intent.END,
    ord("m"): Intent.TOGGLE_MARK, ord(" "): Intent.TOGGLE_MARK,
    ord("a"): Intent.MARK_GROUP, ord("u"): Intent.UNMARK_ALL,
    ord("t"): Intent.TOGGLE_USE_TRASH,
    ord("x"): Intent.DELETE_IMMEDIATE,
    ord("R"): Intent.TOGGLE_RELATIVE_TIME,
    ord("n"): Intent.NEXT_SEARCH, ord("N"): Intent.PREV_SEARCH,
    ord("]"): Intent.NEXT_GROUP_BY_DIST, ord("["): Intent.PREV_GROUP_BY_DIST,
    ord("q"): Intent.IGNORE_CURRENT,
}

_HELP = """rupphash_tpu TUI keys (docs/KEYS.md)
j/k or arrows  next/prev file     h/l or Tab/S-Tab  prev/next group
PgUp/PgDn      page               g/G Home/End      first/last
m or Space     mark               a  mark group     u  unmark all
d  delete marked (y/n confirm)    x  delete current (confirm)
v  move marked (dir dialog, Tab completes; y/n confirm)
c  set move target (Tab)          r  rename (Tab completes)
s  sort menu (1-9)                R  relative/absolute times
/  regex search                   n/N next/prev match
[ ]  prev/next distance band      t  trash mode
q  ignore file   Q  ignore group (confirm)   ?  this help   z/Esc quit
press any key..."""


def _show_help(stdscr):
    stdscr.erase()
    for i, ln in enumerate(_HELP.splitlines()):
        try:
            stdscr.addnstr(i, 0, ln, curses.COLS - 1)
        except curses.error:
            break
    stdscr.refresh()
    stdscr.getch()


def _loop(stdscr, st: AppState):
    curses.curs_set(0)
    curses.start_color()
    curses.use_default_colors()
    curses.init_pair(1, curses.COLOR_MAGENTA, -1)   # marked
    curses.init_pair(2, curses.COLOR_GREEN, -1)     # bit-identical
    curses.init_pair(3, curses.COLOR_CYAN, -1)      # hardlink
    offset = 0
    while not st.quit and st.groups:
        offset = _draw(stdscr, st, offset)
        ch = stdscr.getch()
        if st.pending_confirm:
            if ch in (ord("y"), ord("Y")):
                yes = {"delete": Intent.EXECUTE_DELETE,
                       "delete-one": Intent.EXECUTE_DELETE,
                       "move": Intent.MOVE_MARKED,
                       "ignore-group": Intent.IGNORE_GROUP}
                st.handle_input(yes.get(st.pending_confirm, Intent.CANCEL))
            else:
                st.handle_input(Intent.CANCEL)
            continue
        if ch in (27, ord("z")):
            return
        if ch == ord("?"):
            _show_help(stdscr)
        elif ch == ord("d"):
            st.handle_input(Intent.CONFIRM_DELETE)
        elif ch == ord("Q"):
            st.handle_input(Intent.IGNORE_GROUP)
        elif ch == ord("s"):
            order = _sort_menu(stdscr)
            if order is not None:
                st.handle_input(Intent.CHANGE_SORT, order)
        elif ch == ord("r"):
            f = st.current()
            if f is not None:
                # pre-filled with the current name (ui.rs:396-405)
                out = _prompt(stdscr, "rename: ", initial=f.path.name,
                              completer=_Completer(
                                  complete_rename(f.path.parent)))
                if out is not None:
                    st.handle_input(Intent.SUBMIT_RENAME, out)
        elif ch == ord("v"):
            # move marked: dialog when no target is set (ui.rs:386-393)
            if st.move_target is None:
                out = _prompt(stdscr, "move to dir: ",
                              completer=_Completer(complete_move()))
                if out:
                    st.handle_input(Intent.SET_MOVE_TARGET, out)
            if st.move_target is not None:
                st.handle_input(Intent.MOVE_MARKED)
        elif ch == ord("c"):
            out = _prompt(stdscr, "move target dir: ",
                          completer=_Completer(complete_move()))
            if out is not None:
                st.handle_input(Intent.SET_MOVE_TARGET, out)
        elif ch == ord("/"):
            out = _prompt(stdscr, "search: ")
            if out is not None:
                st.handle_input(Intent.SUBMIT_SEARCH, out)
        elif ch in _KEYMAP:
            st.handle_input(_KEYMAP[ch])


def run(groups, infos, args, store=None) -> int:
    if not groups:
        print("No duplicate groups to browse.")
        return 0
    view_mode = bool(getattr(args, "view", False)
                     or getattr(args, "view_flatten", False)
                     or getattr(args, "shuffle", False)
                     or getattr(args, "slideshow", None) is not None)
    st = AppState(groups, infos, use_trash=args.use_trash,
                  move_target=args.move_marked, sort_order=args.sort,
                  relative_times=args.relative_times, store=store,
                  keep_singletons=view_mode)
    curses.wrapper(_loop, st)
    return 0

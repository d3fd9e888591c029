"""Command-line frontend of the port: scan, group, print, browse; serve.

The flags (plus `--device`), the parser and the output formats are the
JAX package's (rupphash_tpu/cli.py:28-268, copied here with
`build_parser`, `print_groups`, `run_interactive_delete`,
`show_exif_tags` and `_open_store`).  Every route of the JAX package
runs here: scan + group + print (or --rehash-only, or the interactive
--delete prompt), the curses browser after the scan (--use-tui), the
web GUI that serves while the scan streams in (--use-gui), view mode
without similarity checking (--view, --view-flatten, --shuffle,
--slideshow; in the TUI, or in the web viewer with --use-gui), the
near-duplicate service (--serve, serve.py) and the cache management
flags (--prune, --show-ignored, --unignore).  Every route but the
cache flags and --show-exif-tags runs on the card and exits 3 without
one, unless `--device cpu` asks for the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time
from pathlib import Path

GREEN = "\x1b[32m"
RESET = "\x1b[0m"

SORT_ORDERS = ["name", "name-desc", "name-natural", "name-natural-desc",
               "date", "date-desc", "size", "size-desc", "random",
               "exif-date", "exif-date-desc", "location"]


def build_parser() -> argparse.ArgumentParser:
    from . import __version__
    p = argparse.ArgumentParser(
        prog="rupphash_tpu_torch",
        description="Finds visually similar images (PyTorch/CUDA port).")
    p.add_argument("--version", action="version",
                   version=f"rupphash_tpu_torch {__version__}")
    p.add_argument("paths", nargs="*", help="files or directories to scan")
    p.add_argument("--rehash", action="store_true",
                   help="recompute hashes even when cached")
    p.add_argument("--rehash-only", action="store_true",
                   help="recompute hashes and exit without grouping")
    p.add_argument("--similarity", type=int, default=None,
                   help="similarity threshold (default: 40, max 63)")
    p.add_argument("--pixel-hash", action="store_true",
                   help="hash decoded pixels to find content-identical "
                        "files (e.g. PNG vs JPG)")
    p.add_argument("--sort", default="name", choices=SORT_ORDERS)
    p.add_argument("--use-tui", action="store_true")
    p.add_argument("--use-gui", action="store_true",
                   help="web GUI viewer (serves a local single-page app "
                        "on 127.0.0.1; the reference's egui/wgpu desktop "
                        "shell redesigned for headless TPU hosts)")
    p.add_argument("--delete", action="store_true",
                   help="interactive delete prompt per group")
    p.add_argument("--relative-times", action="store_true")
    p.add_argument("--use-trash", action="store_true")
    p.add_argument("--view", action="store_true",
                   help="browse without similarity checking "
                        "(TUI, or web viewer with --use-gui)")
    p.add_argument("--view-flatten", action="store_true")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--slideshow", metavar="SECONDS", type=float,
                   default=None,
                   help="slideshow interval (implies --view; with "
                        "--use-gui the web viewer advances, T toggles)")
    p.add_argument("--3dlut", dest="luts3d", metavar="FILE", nargs="+",
                   default=None,
                   help="3D LUT .cube files, cycled with L in the GUI "
                        "(tetrahedral interpolation)")
    p.add_argument("--move-marked", metavar="DIR", type=Path, default=None)
    p.add_argument("--raw-thumbnails", action="store_true",
                   help="use embedded thumbnails from RAW files")
    p.add_argument("--show-exif-tags", action="store_true")
    p.add_argument("--prune", metavar="SECONDS", type=int, default=None)
    p.add_argument("--show-build-info", action="store_true")
    p.add_argument("--show-ignored", action="store_true")
    p.add_argument("--unignore", metavar="VALUE", nargs="+", default=None)
    p.add_argument("--no-cache", action="store_true",
                   help="skip the encrypted cache entirely")
    p.add_argument("--serve", action="store_true",
                   help="near-duplicate lookup service: index the given "
                        "paths, answer POST /v1/query with image bytes")
    p.add_argument("--port", type=int, default=0,
                   help="port for --serve / --use-gui (0 = ephemeral)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --serve / --use-gui "
                        "(default loopback; 0.0.0.0 exposes the "
                        "delete/move API to the network — be sure)")
    p.add_argument("--allow-host", metavar="NAME", action="append",
                   default=None,
                   help="accept this Host header name on the --serve "
                        "API (repeatable; IP literals and localhost "
                        "are always accepted — other names are "
                        "rejected as DNS-rebinding)")
    p.add_argument("--index-file", metavar="FILE", default=None,
                   help="load/save the --serve hash index (.npz)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) runs the kernels on the card and "
                        "fails without one; cpu runs their plain versions")
    return p


def format_size(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def relative_time(ts: float) -> str:
    delta = time.time() - ts
    for div, name in ((60, "second"), (60, "minute"), (24, "hour"),
                      (30.44, "day"), (12, "month"), (float("inf"), "year")):
        if delta < div:
            v = int(delta)
            return f"{v} {name}{'s' if v != 1 else ''} ago"
        delta /= div
    return "long ago"


def _time_str(rec, relative: bool) -> str:
    if relative:
        return relative_time(rec.modified)
    return datetime.datetime.fromtimestamp(rec.modified).strftime(
        "%Y-%m-%d %H:%M:%S")


def _bit_identical_counts(group):
    counts = {}
    for f in group:
        counts[f.content_hash] = counts.get(f.content_hash, 0) + 1
    return counts


def _print_group_header(i, info, n_groups=None):
    if info.status == "all-identical":
        print(f"\n--- Group {i + 1} - {GREEN}Bit-identical{RESET} ---")
    elif info.status == "some-identical":
        print(f"\n--- Group {i + 1} - {GREEN}Some files Bit-identical{RESET} ---")
    else:
        print(f"\n--- Group {i + 1} (Max Dist: {info.max_dist}) ---")


def print_groups(groups, infos, relative_times=False):
    for i, group in enumerate(groups):
        _print_group_header(i, infos[i])
        counts = _bit_identical_counts(group)
        for f in group:
            res = (f"{f.resolution[0]}x{f.resolution[1]}"
                   if f.resolution else "?")
            ident = counts.get(f.content_hash, 0) > 1
            cs, ce, marker = (GREEN, RESET, "*") if ident else ("", "", " ")
            print(f"  {cs}[{marker}] {_time_str(f, relative_times)} | "
                  f"{format_size(f.size)} | {res} | {f.path}{ce}")


def run_interactive_delete(groups, infos, relative_times, use_trash):
    from .utils import fileops

    for g_idx, group in enumerate(groups):
        if len(group) < 2:
            continue
        info = infos[g_idx]
        print("\n" + "=" * 56)
        if info.status == "all-identical":
            print(f"Group {g_idx + 1} - {GREEN}Bit-identical{RESET}")
        elif info.status == "some-identical":
            print(f"Group {g_idx + 1} - {GREEN}Some files Bit-identical{RESET}")
        else:
            print(f"Group {g_idx + 1}/{len(groups)} "
                  f"(Max Dist: {info.max_dist})")
        print("=" * 56)
        counts = _bit_identical_counts(group)
        for i, f in enumerate(group):
            res = (f"{f.resolution[0]}x{f.resolution[1]}"
                   if f.resolution else "???x???")
            ident = counts.get(f.content_hash, 0) > 1
            cs, ce, marker = (GREEN, RESET, "*") if ident else ("", "", " ")
            print(f"{cs}[{i + 1}] {marker} {_time_str(f, relative_times)} | "
                  f"{format_size(f.size)} | {res} | {f.path}{ce}")
        verb = "TRASH" if use_trash else "PERMANENTLY delete"
        try:
            line = input(f"\nEnter numbers to {verb} (e.g. '1 3'), "
                         f"or ENTER to skip: ").strip()
        except EOFError:
            return
        if not line:
            continue
        for tok in line.split():
            try:
                idx = int(tok) - 1
            except ValueError:
                continue
            if 0 <= idx < len(group):
                try:
                    fileops.delete_file(group[idx].path, use_trash)
                    print(f"  removed {group[idx].path}")
                except OSError as e:
                    print(f"  FAILED {group[idx].path}: {e}")


def show_exif_tags():
    from PIL import ExifTags

    names = sorted(set(ExifTags.TAGS.values()))
    derived = ["Country", "Subdivision", "SunAzimuth", "SunAltitude",
               "Timezone", "Timestamp", "PdqQuality"]
    print("Supported EXIF tag names (for exif_tags configuration):")
    for n in names:
        print(f"  {n}")
    print("Derived tags:")
    for n in derived:
        print(f"  {n}")


def _open_store(args):
    if args.no_cache:
        return None
    from .cache import config as cfgmod
    from .cache.store import CacheStore
    cfg = cfgmod.load_config()
    return CacheStore(cfgmod.cache_dir() / "cache.db",
                      cfg["_master_key_bytes"])


def show_build_info():
    import json
    import platform

    import numpy
    import torch

    from . import __version__, device
    from .ops import _build

    dev = device.get()
    info = {
        "rupphash_tpu_torch": __version__,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
        "precision": device.precision_flags(),
        "kernel_library": (str(_build.load().path)
                           if dev.type == "cuda" else None),
    }
    try:
        import PIL
        info["pillow"] = PIL.__version__
    except ImportError:
        info["pillow"] = None
    print(json.dumps(info, indent=2))


def pin_device(args) -> bool:
    """Fix the process's device from --device; False (after naming the
    missing card on stderr) when the card was asked for and none is
    visible."""
    from . import device

    try:
        device.pin(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return False
    return True


def cache_command(args) -> int | None:
    """--prune, --show-ignored and --unignore: the reference's cache
    management routes (rupphash_tpu/cli.py:296-342), which touch only
    the cache.  None when none of them was asked for."""
    if args.prune is None and not args.show_ignored and not args.unignore:
        return None
    store = _open_store(args)
    if store is None:
        if args.prune is not None:
            print("--prune requires the cache", file=sys.stderr)
        return 2
    try:
        if args.prune is not None:
            res = store.prune(args.prune)
            print(f"Pruned {res['dropped_meta']} stale entries, "
                  f"swept {res['swept_orphans']} orphans.")
        elif args.show_ignored:
            for ch, e in store.list_ignored():
                ph = e.pdqhash.hex() if e.pdqhash else "-"
                ts = datetime.datetime.fromtimestamp(e.timestamp).isoformat()
                print(f"{ch.hex()}  uuid={e.group_uuid.hex()}  {ts}  "
                      f"pdq={ph}")
        else:
            total = 0
            for val in args.unignore:
                # a group UUID (hex), a PDQ hash (hex), else a file path
                try:
                    raw = bytes.fromhex(val)
                except ValueError:
                    raw = None
                if raw is not None and len(raw) == 16:
                    total += store.unignore(group_uuid=raw)
                elif raw is not None and len(raw) == 32:
                    total += store.unignore(pdqhash=raw)
                elif Path(val).exists():
                    from .utils import hashes as H
                    ch = H.content_hash(store.content_key,
                                        Path(val).read_bytes())
                    total += store.unignore(content_hash=ch)
            print(f"Cleared ignore flag on {total} entries.")
    finally:
        store.close()
    return 0


def run_view(args, store) -> int:
    """View mode: browse the listed files without similarity checking,
    in the TUI or, with --use-gui, in the web viewer (the reference's
    route, rupphash_tpu/cli.py:368-402)."""
    from .grouping.engine import GroupInfo
    from .pipeline import view as viewmod

    enrichment = [None]  # previous pool, stopped on relist

    def relist(paths):
        """List + enrich; one definition serves the initial listing and
        the GUI directory picker."""
        if enrichment[0] is not None:
            enrichment[0].stop()
        # plain --view lists one directory level; only --view-flatten
        # descends
        recs, _ = viewmod.list_view(
            paths, recursive=bool(args.view_flatten),
            sort="random" if args.shuffle else args.sort, store=store)
        enr = viewmod.Enrichment(recs, store=store)
        enr.start()
        enrichment[0] = enr
        return ([recs] if recs else []), ([GroupInfo()] if recs else [])

    groups, infos = relist(args.paths)
    if args.use_gui:
        from .gui import server as guiserver
        return guiserver.run_gui(groups, infos, args, store=store,
                                 luts=args.luts3d,
                                 relist_fn=lambda p: relist([p]))
    from . import tui
    return tui.run(groups, infos, args, store=store)


def register_and_filter(store, groups, infos):
    """Assign stable group UUIDs and drop ignored members, as the GUI's
    reload does (rupphash_tpu/cli.py:410-423)."""
    if store is None or not groups:
        return groups, infos
    store.register_duplicate_groups(
        [[(f.content_hash, f.pdqhash) for f in g] for g in groups])
    kept_groups, kept_infos = [], []
    for g, inf in zip(groups, infos):
        g2 = [f for f in g if not store.is_ignored(f.content_hash)]
        if len(g2) > 1:
            kept_groups.append(g2)
            kept_infos.append(inf)
    return kept_groups, kept_infos


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.show_build_info:
        if not pin_device(args):
            return 3
        show_build_info()
        return 0
    if args.show_exif_tags:
        show_exif_tags()
        return 0
    similarity = args.similarity if args.similarity is not None else 40
    if not 0 <= similarity <= 63:
        print("Similarity must be 0-63 for PDQ hash.", file=sys.stderr)
        return 2
    code = cache_command(args)
    if code is not None:
        return code
    if not args.paths:
        print("error: paths required", file=sys.stderr)
        return 2
    if not pin_device(args):
        return 3
    if args.serve:
        from . import serve
        return serve.run_serve(args)

    from .pipeline import scan as scanmod

    cfg = scanmod.ScanConfig(similarity=similarity,
                             pixel_hash=args.pixel_hash,
                             rehash=args.rehash or args.rehash_only,
                             sort=args.sort)
    store = _open_store(args)

    def progress(done, total):
        if done % 100 == 0 or done == total:
            print(f"\rScanning... {done}/{total}", end="",
                  file=sys.stderr, flush=True)

    try:
        if args.slideshow is not None and args.slideshow <= 0:
            print("Slideshow interval must be positive.", file=sys.stderr)
            return 2
        if (args.view or args.view_flatten or args.shuffle
                or args.slideshow is not None):
            return run_view(args, store)

        if args.rehash_only:
            _, stats = scanmod.scan(args.paths, cfg, store, progress)
            print(f"\nRehashed {stats.hashed} files "
                  f"({stats.failed} failures).", file=sys.stderr)
            return 0

        if args.use_gui:
            # serve at once; the scan streams in from a worker thread
            from .gui import server as guiserver

            def scan_fn(progress_cb):
                groups, infos, records, stats = scanmod.scan_and_group(
                    args.paths, cfg, store, progress_cb)
                return register_and_filter(store, groups, infos)

            return guiserver.run_gui_scanning(args, store, scan_fn,
                                              luts=args.luts3d)

        groups, infos, records, stats = scanmod.scan_and_group(
            args.paths, cfg, store, progress)
        print(file=sys.stderr)
        print(f"Found {len(groups)} duplicate groups using PDQ hash.")

        # reference parity: non-GUI surfaces show ignored groups too;
        # still register for stable group UUIDs
        if store is not None and groups:
            store.register_duplicate_groups(
                [[(f.content_hash, f.pdqhash) for f in g]
                 for g in groups])

        if args.use_tui:
            from . import tui
            return tui.run(groups, infos, args, store=store)
        if args.delete:
            run_interactive_delete(groups, infos, args.relative_times,
                                   args.use_trash)
        elif args.move_marked:
            print("--move-marked applies to files marked in the TUI; "
                  "use --use-tui or --use-gui.", file=sys.stderr)
        else:
            print_groups(groups, infos, args.relative_times)
        return 0
    finally:
        if store is not None:
            store.close()


if __name__ == "__main__":
    sys.exit(main())

"""Command-line frontend of the port: scan, group and print; serve.

The flags, the parser and the output formats are rupphash_tpu's own
(rupphash_tpu/cli.py imports no jax, so its parser and printers are
reused).  The port runs the duplicate-scan route: scan + group + print
(or --rehash-only, or the interactive --delete prompt), the
near-duplicate service (--serve, serve.py) and the cache management
flags (--prune, --show-ignored, --unignore).  The view, TUI and GUI
routes are not ported yet and exit with status 2 and a message naming
the flag.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

from rupphash_tpu import cli as ref_cli

_NOT_PORTED = (("view", "--view"), ("view_flatten", "--view-flatten"),
               ("shuffle", "--shuffle"), ("slideshow", "--slideshow"),
               ("use_gui", "--use-gui"), ("use_tui", "--use-tui"))


def build_parser():
    p = ref_cli.build_parser()
    p.prog = "rupphash_tpu_torch"
    p.description = "Finds visually similar images (PyTorch/CUDA port)."
    return p


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


def cache_command(args) -> int | None:
    """--prune, --show-ignored and --unignore: the reference's cache
    management routes (rupphash_tpu/cli.py:296-342), which touch only
    the cache.  None when none of them was asked for."""
    if args.prune is None and not args.show_ignored and not args.unignore:
        return None
    store = ref_cli._open_store(args)
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
                    from rupphash_tpu.utils import hashes as H
                    ch = H.content_hash(store.content_key,
                                        Path(val).read_bytes())
                    total += store.unignore(content_hash=ch)
            print(f"Cleared ignore flag on {total} entries.")
    finally:
        store.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.show_build_info:
        show_build_info()
        return 0
    if args.show_exif_tags:
        ref_cli.show_exif_tags()
        return 0
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr) not in (None, False):
            print(f"{flag} is not ported to rupphash_tpu_torch yet; "
                  "use python -m rupphash_tpu", file=sys.stderr)
            return 2

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
    if args.serve:
        from . import serve
        return serve.run_serve(args)

    from .pipeline import scan as scanmod

    cfg = scanmod.ScanConfig(similarity=similarity,
                             pixel_hash=args.pixel_hash,
                             rehash=args.rehash or args.rehash_only,
                             sort=args.sort)
    store = ref_cli._open_store(args)

    def progress(done, total):
        if done % 100 == 0 or done == total:
            print(f"\rScanning... {done}/{total}", end="",
                  file=sys.stderr, flush=True)

    try:
        if args.rehash_only:
            _, stats = scanmod.scan(args.paths, cfg, store, progress)
            print(f"\nRehashed {stats.hashed} files "
                  f"({stats.failed} failures).", file=sys.stderr)
            return 0

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

        if args.delete:
            ref_cli.run_interactive_delete(groups, infos, args.relative_times,
                                           args.use_trash)
        elif args.move_marked:
            print("--move-marked applies to files marked in the TUI; "
                  "use --use-tui or --use-gui.", file=sys.stderr)
        else:
            ref_cli.print_groups(groups, infos, args.relative_times)
        return 0
    finally:
        if store is not None:
            store.close()


if __name__ == "__main__":
    sys.exit(main())

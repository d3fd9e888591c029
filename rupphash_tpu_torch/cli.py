"""Command-line frontend of the port: scan, group and print.

The flags, the parser and the output formats are rupphash_tpu's own
(rupphash_tpu/cli.py imports no jax, so its parser and printers are
reused).  The port runs the duplicate-scan route: scan + group + print
(or --rehash-only, or the interactive --delete prompt).  The other
routes (serve, view, TUI, GUI and the cache management flags) are not
ported yet and exit with status 2 and a message naming the flag.
"""

from __future__ import annotations

import sys

from rupphash_tpu import cli as ref_cli

_NOT_PORTED = (("serve", "--serve"), ("view", "--view"),
               ("view_flatten", "--view-flatten"), ("shuffle", "--shuffle"),
               ("slideshow", "--slideshow"), ("use_gui", "--use-gui"),
               ("use_tui", "--use-tui"), ("prune", "--prune"),
               ("show_ignored", "--show-ignored"), ("unignore", "--unignore"))


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
    if not args.paths:
        print("error: paths required", file=sys.stderr)
        return 2

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

"""Hash one image with classic pHash; print hex/bin + rotation-invariant
hash.  Equivalent of the reference's `phash_test` binary
(src/phash_test.rs).
Usage: python -m rupphash_tpu_torch.tools.phash_test IMG [--pdq]"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("Usage: python -m rupphash_tpu_torch.tools.phash_test "
              "<image_file_path> [--pdq]", file=sys.stderr)
        return 1
    path = argv[0]
    show_pdq = "--pdq" in argv

    from PIL import Image

    from ..ops import phash_ref

    try:
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    except Exception as e:
        print(f"Error opening file '{path}': {e}", file=sys.stderr)
        return 1

    h = phash_ref.hash_image(img)
    print(f"File: {path}")
    print(f"Standard pHash (Hex): {h:016x}")
    print(f"Standard pHash (Bin): {h:064b}")
    inv = phash_ref.rotation_invariant_hash(h)
    print(f"Rot-Invariant Hash  : {inv:016x}")

    if show_pdq:
        from ..ops import pdq_ref
        out = pdq_ref.generate_pdq(img)
        if out is not None:
            pdq, quality = out
            print(f"PDQ (Hex)           : {pdq.hex()}")
            print(f"PDQ quality         : {quality * 100:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The service cells' inputs: the sources, the pool of request bodies and
the 1M-row index, from a configuration, a traffic mix and a seed.

Sources are textured images (a random 24 x 32 RGB seed upscaled), each
rendered at whatever size a body or the index needs.  The index holds
random rows (a share of them low quality) and, for each source, near
copies of its golden PDQ hash at planted distances, as chip_smoke.py's
build_corpus_index has it.  The body pool mixes kinds in fixed counts:

  jpeg       a source re-rendered with its longest side in [lo, hi] px,
             JPEG at a quality in [lo, hi]
  png_turn   a source with its longest side in [lo, hi] px, turned or
             mirrored (one of the 7 non-identity dihedral transforms), PNG
  unrelated  a texture that is no source, JPEG, sized as `jpeg`
  flat       a nearly flat image (one grey level, noise of +-1), PNG: its
             quality is low, so it matches exactly only

Sizes, qualities and kinds are the same multiset for every seed; the
seed draws the textures, which source a body shows and the order.  The
heavy work runs in a pool of spawned processes (`make_pool`).
"""

from __future__ import annotations

import io
import json

import numpy as np

TRANSPOSES = ("FLIP_LEFT_RIGHT", "FLIP_TOP_BOTTOM", "ROTATE_90",
              "ROTATE_180", "ROTATE_270", "TRANSPOSE", "TRANSVERSE")


def make_pool(workers: int):
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(workers)


def render(seed_rgb: np.ndarray, w: int, h: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(seed_rgb).resize((w, h),
                                                       Image.BILINEAR))


def _encode(img: np.ndarray, fmt: str, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


def make_body(spec: dict) -> bytes:
    """One request body from its spec (picklable, for the pool)."""
    from PIL import Image

    kind = spec["kind"]
    seed_rgb = np.frombuffer(spec["texture"], np.uint8).reshape(24, 32, 3)
    w, h = spec["size"]
    if kind == "flat":
        rng = np.random.default_rng(spec["noise_seed"])
        img = np.full((h, w, 3), spec["level"], np.int16)
        img = img + rng.integers(-1, 2, (h, w, 1), dtype=np.int16)
        return _encode(img.clip(0, 255).astype(np.uint8), "PNG")
    img = render(seed_rgb, w, h)
    if kind == "png_turn":
        op = getattr(Image.Transpose, spec["transpose"])
        img = np.asarray(Image.fromarray(img).transpose(op))
        return _encode(img, "PNG")
    return _encode(img, "JPEG", quality=int(spec["quality"]))


def hashed_shape(spec: dict) -> tuple[int, int]:
    """(width, height) of the luma plane the service hashes for a body:
    the image as decoded (turned PNGs swap their sides), box-downsampled
    to 512 px when larger (PDQ's pre-downsample)."""
    from phbench.reference import pdq_golden

    w, h = spec["size"]
    if spec.get("transpose") in ("ROTATE_90", "ROTATE_270", "TRANSPOSE",
                                 "TRANSVERSE"):
        w, h = h, w
    cap = pdq_golden.DOWNSAMPLE_DIMS
    if w > cap or h > cap:
        w, h = pdq_golden.calculate_target_dimensions(w, h, cap)
    return w, h


def _cycle(lo: int, hi: int, k: int, count: int) -> int:
    """The k-th of `count` values spread evenly over [lo, hi]."""
    return lo + (hi - lo) * k // max(count - 1, 1)


def body_specs(config: dict, traffic: dict, seed: int, textures) -> list:
    """Specs of the pool's bodies in a seeded order, [(kind, source or
    None, spec), ...] as dicts."""
    rng = np.random.default_rng([seed, 2])
    pool = traffic["pool"]
    n_src = len(textures)
    specs = []
    src_order = rng.permutation(n_src).tolist()
    nxt = 0
    for kind, p in pool["kinds"].items():
        count = int(p["count"])
        for k in range(count):
            spec = {"kind": kind}
            if kind in ("jpeg", "png_turn"):
                src = src_order[nxt % n_src]
                nxt += 1
                spec["source"] = src
                spec["texture"] = textures[src].tobytes()
            else:
                spec["source"] = None
                spec["texture"] = rng.integers(
                    0, 256, (24, 32, 3), dtype=np.uint8).tobytes()
            if kind == "jpeg":
                side = _cycle(*p["side"], k, count)
                spec["quality"] = _cycle(*p["quality"], k, count)
            elif kind == "png_turn":
                side = _cycle(*p["side"], k, count)
                spec["transpose"] = TRANSPOSES[k % len(TRANSPOSES)]
            elif kind == "unrelated":
                side = _cycle(*p["side"], k, count)
                spec["quality"] = _cycle(*p["quality"], k, count)
            else:
                side = _cycle(*p["side"], k, count)
                spec["level"] = int(rng.integers(40, 216))
                spec["noise_seed"] = int(rng.integers(0, 2**62))
            # 4:3 landscape, or portrait for one source or body in three
            short = side * 3 // 4
            turn = (spec["source"] if spec["source"] is not None else k) % 3
            spec["size"] = (short, side) if turn == 0 else (side, short)
            specs.append(spec)
    order = rng.permutation(len(specs)).tolist()
    return [specs[i] for i in order]


def source_size(k: int, side: int = 512) -> tuple[int, int]:
    """(width, height) of source k rendered with longest side `side`: the
    orientation make_body gives its bodies."""
    short = side * 3 // 4
    return (short, side) if k % 3 == 0 else (side, short)


def textures(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng([seed, 3])
    return [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
            for _ in range(n)]


def build_index(config: dict, source_hashes: np.ndarray, seed: int):
    """(hashes (N, 32) u8, quality (N,) int32, paths) of the index:
    random rows, `low_share` of them low quality, and for source k
    1 + k % 4 near copies of its hash at distances cycling over
    [0, max_flips], 1 in `planted_low_every` of them low quality."""
    rng = np.random.default_rng([seed, 4])
    n = int(config["rows"])
    nbytes = int(config["hash_bits"]) // 8
    hashes = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    quality = rng.integers(50, 101, n).astype(np.int32)
    quality[rng.random(n) < float(config["low_share"])] = 20
    paths = [f"/corpus/{i:07d}.jpg" for i in range(n)]
    slots = iter(rng.permutation(n).tolist())
    lo, hi = config["planted_flips"]
    low_every = int(config["planted_low_every"])
    j_all = 0
    for k, h0 in enumerate(source_hashes):
        for j in range(1 + k % 4):
            dist = lo + j_all % (hi - lo + 1)
            h = h0.copy()
            for bit in rng.choice(nbytes * 8, dist, replace=False):
                h[bit // 8] ^= np.uint8(1 << (bit % 8))
            i = next(slots)
            hashes[i] = h
            quality[i] = 20 if j_all % low_every == low_every - 1 else 90
            paths[i] = f"/planted/{k}/{j}_d{dist}.jpg"
            j_all += 1
    return hashes, quality, paths


def index_file_bytes(hashes, quality, paths) -> bytes:
    """The index as the service's .npz format, in memory."""
    buf = io.BytesIO()
    np.savez(buf, hashes=hashes, quality=quality,
             paths_json=np.frombuffer(json.dumps(paths).encode(), np.uint8))
    return buf.getvalue()

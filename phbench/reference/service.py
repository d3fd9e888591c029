"""Plain reference of the service cells: what /v1/query must answer.

A body's hash is the golden PDQ's (pdq_golden, a frozen copy) of the
image PIL decodes from it: Rec.601 luma, the box downsample to 512 px,
the 8 dihedral variants and the quality.  The answer is every index row
whose smallest distance to one of the 8 variants is within the radius
(40; 0 for a query of quality under 50), low-quality rows only at
distance 0, sorted by distance and then row, at most `max_results` of
them, each with its path, its distance and its row (no row is removed in
these cells, so the row is its live position).

The control computes the same in bfloat16, the precision below the
float32 that PDQ states: the luma plane, the blurred and decimated
buffer, the DCT basis and the coefficients are rounded to bfloat16, the
products accumulated in float32, as a bfloat16 tensor-core path would.

Plain NumPy and PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from phbench.reference import pdq_golden as g

MIN_QUALITY = 50


def decode(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im.load()
        if im.mode not in ("RGB", "L", "RGBA"):
            im = im.convert("RGB")
        return np.asarray(im)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, ties to even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _pdq_bf16(luma: np.ndarray):
    rows, cols = luma.shape
    buf = _bf16(luma.astype(np.float32))
    blurred = _bf16(g.jarosz_filter(buf, -(-cols // g.JAROSZ_WINDOW_DIVISOR),
                                    -(-rows // g.JAROSZ_WINDOW_DIVISOR)))
    buf64 = _bf16(g.decimate(blurred))
    quality = g.quality_metric(buf64)
    d = _bf16(g.dct_matrix())
    coeffs = _bf16(_bf16(d @ buf64) @ d.T).reshape(-1)
    return coeffs, quality


def golden(data: bytes, bf16: bool = False):
    """(variants (8, 32) u8 bytes, quality 0-100) of a body, or None when
    it is too small to hash (picklable, for a process pool)."""
    luma = g.prepare_luma(decode(data))
    if luma is None:
        return None
    if bf16:
        coeffs, quality = _pdq_bf16(luma)
    else:
        coeffs, _, quality = g.pdq_from_luma(luma)
    variants = g.dihedral_hashes_batch(coeffs[None])[0]
    return variants.tobytes(), float(np.float32(quality)) * 100.0


def golden_bf16(data: bytes):
    return golden(data, bf16=True)


def golden_of_render(args):
    """Golden variants of a texture rendered at (w, h): the index's planted
    rows start from these (picklable, for a process pool)."""
    from phbench import servegen

    texture, w, h = args
    img = servegen.render(np.frombuffer(texture, np.uint8).reshape(24, 32, 3),
                          w, h)
    coeffs, _, quality = g.pdq_from_luma(g.prepare_luma(img))
    return g.dihedral_hashes_batch(coeffs[None])[0].tobytes()


def pm1(x_u8: torch.Tensor, dtype) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=x_u8.device)
    bits = (x_u8[..., None] >> shifts) & 1
    return bits.reshape(x_u8.shape[:-1] + (x_u8.shape[-1] * 8,)).to(
        dtype) * 2 - 1


def answers(hashed: list, hashes: np.ndarray, quality: np.ndarray,
            paths: list[str], similarity: int, max_results: int, device,
            chunk: int = 64) -> list:
    """The reference answer for each (variants bytes, quality) in `hashed`
    (None: no answer), [[(path, distance, row), ...], ...]."""
    dt = torch.float16 if device.type == "cuda" else torch.float32
    nbits = hashes.shape[1] * 8
    base = pm1(torch.from_numpy(np.ascontiguousarray(hashes)).to(device), dt)
    low = torch.from_numpy(np.asarray(quality) < MIN_QUALITY).to(device)
    out = [None] * len(hashed)
    todo = [k for k, h in enumerate(hashed) if h is not None]
    for c0 in range(0, len(todo), chunk):
        ks = todo[c0:c0 + chunk]
        q = np.stack([np.frombuffer(hashed[k][0], np.uint8).reshape(8, -1)
                      for k in ks])
        qd = pm1(torch.from_numpy(q).to(device), dt).reshape(-1, nbits)
        dots = (qd @ base.T).view(len(ks), 8, -1).amax(dim=1)
        dist = ((nbits - dots.float()) / 2).round().to(torch.int32)
        for r, k in enumerate(ks):
            radius = similarity if hashed[k][1] >= MIN_QUALITY else 0
            d = dist[r]
            sel = torch.nonzero((d <= radius) & (~low | (d == 0)),
                                as_tuple=True)[0]
            dd = d[sel]
            order = torch.argsort(dd.to(torch.int64) * len(d) + sel)
            rows = sel[order][:max_results].tolist()
            out[k] = [(paths[i], int(d[i]), int(i)) for i in rows]
    return out


def served(answer: dict) -> list:
    """A /v1/query answer as [(path, distance, row), ...]."""
    return [(m["path"], int(m["distance"]), int(m["index"]))
            for m in answer["matches"]]

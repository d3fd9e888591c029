"""RAW demosaic and colour pipeline in plain PyTorch.

Counterpart of rupphash_tpu/ops/demosaic.py (Malvar-He-Cutler for 2x2
Bayer patterns, per-channel normalized convolution with a 5x5 tent for
n x n patterns such as Fuji X-Trans; white balance, the DNG colour
matrix and the sRGB transfer).  The reference computes it in XLA,
outside any Pallas kernel, so the port has no kernel of its own here.

The 5x5 stencils are written as shifted multiply-adds in a fixed tap
order (row-major over the window, one IEEE multiply and one IEEE add
per tap), not as `conv2d`: cuDNN picks its convolution algorithm per
card and shape, so a convolution's summation order on the card could
differ from the CPU's, while separate elementwise multiplies and adds
give the same float32 results on both.  XLA's own summation order
cannot be reproduced, so against the JAX package the port agrees to
within one u8 level on a few pixels, not bit for bit
(tests/test_torch_demosaic.py states the tolerance).

`process_raw(raw, device)` takes its device explicitly: the caller
decides where the work runs (decode worker processes pass "cpu" so that
none of them opens a CUDA context).  Float32 throughout, TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as devmod

# Malvar-He-Cutler filters (x 1/8), copied from the reference
# (rupphash_tpu/ops/demosaic.py:32-47): G at R/B sites, R/B at G sites
# with same-row neighbours (H) or same-column neighbours (V), R at B and
# B at R (D)
_KG = np.array([[0, 0, -1, 0, 0],
                [0, 0, 2, 0, 0],
                [-1, 2, 4, 2, -1],
                [0, 0, 2, 0, 0],
                [0, 0, -1, 0, 0]], dtype=np.float32) / 8.0
_KH = np.array([[0, 0, 0.5, 0, 0],
                [0, -1, 0, -1, 0],
                [-1, 4, 5, 4, -1],
                [0, -1, 0, -1, 0],
                [0, 0, 0.5, 0, 0]], dtype=np.float32) / 8.0
_KV = _KH.T.copy()
_KD = np.array([[0, 0, -1.5, 0, 0],
                [0, 2, 0, 2, 0],
                [-1.5, 0, 6, 0, -1.5],
                [0, 2, 0, 2, 0],
                [0, 0, -1.5, 0, 0]], dtype=np.float32) / 8.0
_TENT = np.outer([1, 2, 3, 2, 1], [1, 2, 3, 2, 1]).astype(np.float32)

# XYZ (D65) -> linear sRGB, IEC 61966-2-1
_XYZ2SRGB = np.array([[3.2406, -1.5372, -0.4986],
                      [-0.9689, 1.8758, 0.0415],
                      [0.0557, -0.2040, 1.0570]], dtype=np.float32)


def _stencils(x: torch.Tensor, kernels) -> list[torch.Tensor]:
    """(H, W) float32 -> one (H, W) cross-correlation per 5x5 kernel
    over the reflect-padded plane (lax.conv "VALID" after a reflect pad
    of 2).  Taps are visited row-major and zero weights skipped."""
    h, w = x.shape
    xp = torch.nn.functional.pad(x[None, None], (2, 2, 2, 2),
                                 mode="reflect")[0, 0]
    outs: list = [None] * len(kernels)
    for dy in range(5):
        for dx in range(5):
            tap = xp[dy:dy + h, dx:dx + w]
            for i, k in enumerate(kernels):
                weight = float(k[dy, dx])
                if weight == 0.0:
                    continue
                term = tap * weight
                if outs[i] is None:
                    outs[i] = term
                else:
                    outs[i] += term
    return outs


def _normalize(mosaic: torch.Tensor, black: float, white: float,
               gains: torch.Tensor) -> torch.Tensor:
    """Raw counts -> [0, 1], then white balance per CFA site."""
    scale = np.float32(max(np.float32(white) - np.float32(black), 1.0))
    x = torch.clamp((mosaic - float(np.float32(black))) / float(scale),
                    0.0, 1.0)
    return torch.clamp(x * gains, 0.0, 1.0)


def _bayer(x: torch.Tensor, cfa: np.ndarray) -> list[torch.Tensor]:
    """Malvar-He-Cutler on a 2x2 CFA (reference _demosaic_jax :56):
    [R, G, B] planes, each (H, W)."""
    h, w = x.shape
    dev = x.device
    fg, fh, fv, fd = _stencils(x, (_KG, _KH, _KV, _KD))
    # at a G site, are the R neighbours horizontal?  true when the same
    # row of the 2x2 tile holds an R
    r_row = np.array([0 in cfa[0], 0 in cfa[1]])
    g_r_horiz_small = r_row[:, None] & (cfa == 1)

    def tile(small):
        return torch.from_numpy(np.ascontiguousarray(small)).to(dev).repeat(
            h // 2, w // 2)

    is_r, is_g, is_b = (tile(cfa == c) for c in range(3))
    g_r_horiz = tile(g_r_horiz_small)
    red = torch.where(is_r, x, torch.where(
        is_g, torch.where(g_r_horiz, fh, fv), fd))
    green = torch.where(is_g, x, fg)
    blue = torch.where(is_b, x, torch.where(
        is_g, torch.where(g_r_horiz, fv, fh), fd))
    return [red, green, blue]


def _generic(x: torch.Tensor, cfa: np.ndarray) -> list[torch.Tensor]:
    """n x n CFA (reference _process_generic_jax :128): per channel, the
    tent-weighted mean of that channel's sites, the sample itself at its
    own sites and where no site of the colour lies in the window."""
    h, w = x.shape
    n = cfa.shape[0]
    planes = []
    for c in range(3):
        site = torch.from_numpy(np.ascontiguousarray(cfa == c)).to(
            x.device).repeat(h // n, w // n)
        mask = site.to(torch.float32)
        num, = _stencils(x * mask, (_TENT,))
        den, = _stencils(mask, (_TENT,))
        interp = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), x)
        planes.append(torch.where(site, x, interp))
    return planes


def _to_srgb_u8(planes: list[torch.Tensor], matrix) -> torch.Tensor:
    """Linear [R, G, B] planes -> (H, W, 3) u8 sRGB: optional 3x3 mix
    (each output a fixed-order sum of three products), clip, sRGB
    transfer, round half to even."""
    if matrix is not None:
        planes = [planes[0] * float(matrix[d, 0]) + planes[1] * float(
            matrix[d, 1]) + planes[2] * float(matrix[d, 2])
            for d in range(3)]
    out = []
    for p in planes:
        p = torch.clamp(p, 0.0, 1.0)
        srgb = torch.where(p <= 0.0031308, p * 12.92,
                           torch.pow(torch.clamp(p, min=1e-8), 1 / 2.4)
                           * 1.055 - 0.055)
        out.append(torch.round(torch.clamp(srgb, 0.0, 1.0) * 255.0).to(
            torch.uint8))
    return torch.stack(out, dim=-1)


def _linear_gray(raw) -> np.ndarray:
    """LinearRaw: already demosaiced single plane -> grayscale.  Host
    numpy, as in the reference (process_raw :193-202)."""
    x = (raw.mosaic.astype(np.float32) - raw.black) / max(
        raw.white - raw.black, 1.0)
    g = np.clip(x, 0.0, 1.0)
    srgb = np.where(g <= 0.0031308, g * 12.92,
                    1.055 * np.power(np.maximum(g, 1e-8), 1 / 2.4) - 0.055)
    u8 = np.round(np.clip(srgb, 0, 1) * 255).astype(np.uint8)
    return np.stack([u8] * 3, axis=-1)


def _white_balance(asn) -> np.ndarray:
    """Per-channel gains, G-normalized (AsShotNeutral is the camera's
    response to a neutral: gain = asn[G] / asn[c]); neutral gains when
    AsShotNeutral is missing or malformed."""
    if asn is not None and np.all(np.isfinite(np.asarray(asn[:3],
                                                         np.float64))) \
            and asn[0] > 0 and asn[2] > 0:
        return np.array([asn[1] / asn[0], 1.0, asn[1] / asn[2]],
                        dtype=np.float32)
    return np.ones(3, dtype=np.float32)


def _camera_to_srgb(color_matrix) -> np.ndarray | None:
    """XYZ->camera matrix -> row-normalized camera->sRGB, or None when
    absent, singular or of the wrong shape."""
    if color_matrix is None:
        return None
    try:
        cam2xyz = np.linalg.inv(np.asarray(color_matrix, np.float64))
        m = (_XYZ2SRGB @ cam2xyz).astype(np.float32)
    except (np.linalg.LinAlgError, ValueError):
        return None
    # row-normalize so a white-balanced camera white stays white
    return m / np.maximum(m.sum(axis=1, keepdims=True), 1e-6)


def process_raw(raw, device) -> np.ndarray | None:
    """RawImage (rupphash_tpu/pipeline/dng.py) -> (H, W, 3) u8 sRGB,
    computed on `device`; None for patterns the reference rejects
    (non-RGB such as CYGM, a colour missing from an n x n pattern, a
    mosaic smaller than its CFA)."""
    mosaic = raw.mosaic
    if mosaic.ndim != 2 or min(mosaic.shape) < 4:
        return None
    if raw.linear:
        return _linear_gray(raw)

    cfa = np.asarray(raw.cfa)
    n = int(cfa.shape[0])
    if cfa.ndim != 2 or cfa.shape[1] != n:
        return None
    # n-align so every CFA phase is whole
    h2 = (mosaic.shape[0] // n) * n
    w2 = (mosaic.shape[1] // n) * n
    if h2 < n or w2 < n:
        return None
    cfa_flat = [int(v) for v in cfa.flatten()]
    if any(c not in (0, 1, 2) for c in cfa_flat):
        return None  # non-RGB CFA (e.g. CYGM) unsupported
    if n > 2 and not all(c in cfa_flat for c in (0, 1, 2)):
        return None  # degenerate pattern missing a colour
    cfa = np.asarray(cfa_flat, dtype=np.int64).reshape(n, n)
    wb = _white_balance(raw.as_shot_neutral)
    matrix = _camera_to_srgb(raw.color_matrix)

    devmod.set_precision_flags()
    dev = torch.device(device)
    m = torch.from_numpy(np.ascontiguousarray(mosaic[:h2, :w2],
                                              dtype=np.float32)).to(dev)
    gains = torch.from_numpy(wb[cfa]).to(dev).repeat(h2 // n, w2 // n)
    x = _normalize(m, raw.black, raw.white, gains)
    planes = _bayer(x, cfa) if n == 2 else _generic(x, cfa)
    return _to_srgb_u8(planes, matrix).cpu().numpy()

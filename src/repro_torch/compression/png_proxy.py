"""PNG-size proxy: PNG is (per-scanline predictor) + DEFLATE.  We apply the
same pipeline (Paeth-class "up"/"sub"/"average" filters chosen per row by
minimum-sum-of-absolute heuristic, then zlib) to get representative lossless
image sizes without writing actual PNG containers."""

from __future__ import annotations

import zlib

import numpy as np


def _filters(img: np.ndarray) -> np.ndarray:
    """Per-row best-of {none, sub, up, avg} filter, PNG heuristic."""
    h, w, c = img.shape
    x = img.astype(np.int16)
    prev = np.vstack([np.zeros((1, w, c), np.int16), x[:-1]])
    left = np.concatenate([np.zeros((h, 1, c), np.int16), x[:, :-1]], axis=1)
    cands = {
        0: x,
        1: (x - left) & 0xFF,
        2: (x - prev) & 0xFF,
        3: (x - ((left + prev) // 2)) & 0xFF,
    }
    scores = {fid: np.abs(v.astype(np.int8)).sum(axis=(1, 2))
              for fid, v in cands.items()}
    best = np.argmin(np.stack([scores[i] for i in range(4)]), axis=0)
    out = np.empty((h, w * c + 1), np.uint8)
    for fid in range(4):
        rows = best == fid
        if rows.any():
            out[rows, 0] = fid
            out[rows, 1:] = cands[fid][rows].reshape(rows.sum(), -1).astype(np.uint8)
    return out


def png_like_bytes(img_u8: np.ndarray, level: int = 6) -> bytes:
    """img: [H, W, C] uint8 -> filtered + deflated byte stream."""
    if img_u8.dtype != np.uint8:
        raise TypeError("expected uint8 image")
    if img_u8.ndim == 2:
        img_u8 = img_u8[..., None]
    return zlib.compress(_filters(img_u8).tobytes(), level)


def png_like_size(img_u8: np.ndarray, level: int = 6) -> int:
    return len(png_like_bytes(img_u8, level)) + 57   # + PNG container overhead

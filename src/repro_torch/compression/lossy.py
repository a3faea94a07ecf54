"""JPEG-class lossy codec (8x8 DCT + quantization + entropy stage), used as
the lossy-compression comparison point of paper §6.6 / Fig. 12.  This is a
faithful JPEG skeleton (YCbCr, standard luma/chroma tables, quality
scaling) with a zlib entropy stage instead of Huffman — sizes track real
JPEG within ~10-20 %, which is all the comparison needs."""

from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)

_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float64)


def _qscale(q: int) -> float:
    q = max(1, min(100, q))
    return 5000.0 / q / 100.0 if q < 50 else (200.0 - 2 * q) / 100.0


def _dct_mat() -> np.ndarray:
    n = 8
    k = np.arange(n)
    M = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    M[0] /= np.sqrt(2.0)
    return M

_DCT = _dct_mat()


def _rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    m = np.array([[0.299, 0.587, 0.114],
                  [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]])
    y = img @ m.T
    y[..., 1:] += 128.0
    return y


def _ycbcr_to_rgb(y: np.ndarray) -> np.ndarray:
    y = y.copy()
    y[..., 1:] -= 128.0
    m = np.array([[1.0, 0.0, 1.402],
                  [1.0, -0.344136, -0.714136],
                  [1.0, 1.772, 0.0]])
    return y @ m.T


def _blockify(ch: np.ndarray) -> np.ndarray:
    h, w = ch.shape
    return ch.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblockify(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return blocks.transpose(0, 2, 1, 3).reshape(h, w)


def _encode_channel(ch: np.ndarray, qt: np.ndarray) -> Tuple[bytes, np.ndarray]:
    h, w = ch.shape
    blocks = _blockify(ch - 128.0)
    coef = np.einsum("ij,bcjk,lk->bcil", _DCT, blocks, _DCT)
    q = np.round(coef / qt).astype(np.int16)
    deq = q.astype(np.float64) * qt
    rec = np.einsum("ji,bcjk,kl->bcil", _DCT, deq, _DCT) + 128.0
    return q.tobytes(), _unblockify(rec, h, w)


def jpeg_like(img_u8: np.ndarray, quality: int = 95,
              level: int = 6) -> Tuple[int, np.ndarray]:
    """Returns (compressed_size_bytes, reconstructed uint8 image).

    Arbitrary H x W: edges are replicate-padded up to multiples of the
    8x8 block size before the transform and the reconstruction is
    cropped back, as a real JPEG encoder does (replication, not zeros,
    so the pad rows cost almost nothing and don't ring into the edge)."""
    h, w, _ = img_u8.shape
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        img_u8 = np.pad(img_u8, ((0, ph), (0, pw), (0, 0)), mode="edge")
    s = _qscale(quality)
    ycc = _rgb_to_ycbcr(img_u8.astype(np.float64))
    payloads = []
    rec = np.empty_like(ycc)
    for c in range(3):
        qt = np.maximum(1.0, np.floor((_Q_LUMA if c == 0 else _Q_CHROMA) * s + 0.5))
        raw, rc = _encode_channel(ycc[..., c], qt)
        payloads.append(raw)
        rec[..., c] = rc
    size = len(zlib.compress(b"".join(payloads), level)) + 600  # hdr+tables
    out = np.clip(_ycbcr_to_rgb(rec), 0, 255).astype(np.uint8)
    return size, out[:h, :w]

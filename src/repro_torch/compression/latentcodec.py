"""Lossless numeric codec for latent tensors (the pcodec role, paper §5).

Diffusion latents are float tensors with spatial smoothness and
inter-channel correlation that byte-oriented compressors can't exploit.
The pipeline here mirrors pcodec's structure with numpy primitives:

  1. *total-order map*: reinterpret floats as unsigned ints ordered like the
     float values (sign-magnitude -> offset-binary), so numeric closeness
     becomes integer closeness;
  2. *spatial delta* along the innermost spatial axis (per channel), turning
     smoothness into small signed residuals;
  3. *zigzag* map to unsigned;
  4. *byte-plane split* (shuffle), grouping the near-constant high bytes;
  5. DEFLATE entropy stage per the shuffled buffer.

Bit-exact roundtrip for fp16/fp32/(u)intN; property-tested in
``tests/test_compression.py``.  On SD3.5-like latents this reaches the
paper's ~1.8x regime (512 KB raw fp16 -> ~280 KB), see bench_storage.

The lossy variant (``LBQ1``, :func:`compress_latent_lossy`) feeds the
rate-distortion ladder in :mod:`repro.compression.ladder`: uniform
quantization of the float tensor to ``bits`` levels over its observed
range, then the same delta/zigzag/byte-plane/DEFLATE stack.  The blob
carries its ladder rung (:func:`blob_rung`), and
:func:`decompress_latent` dispatches on magic so every read path decodes
both formats transparently.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

MAGIC = b"LBC1"
MAGIC_LOSSY = b"LBQ1"

_UINT_OF = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _float_to_ordered_uint(u: np.ndarray) -> np.ndarray:
    """Map float bit patterns to order-preserving unsigned ints."""
    bits = 8 * u.itemsize
    sign = np.uint64(1) << np.uint64(bits - 1)
    sign = u.dtype.type(sign)
    return np.where(u & sign != 0, ~u, u | sign)


def _ordered_uint_to_float_bits(u: np.ndarray) -> np.ndarray:
    bits = 8 * u.itemsize
    sign = u.dtype.type(np.uint64(1) << np.uint64(bits - 1))
    return np.where(u & sign != 0, u & ~sign, ~u)


def _zigzag(d: np.ndarray) -> np.ndarray:
    """Signed (as two's-complement unsigned) -> small unsigned."""
    bits = 8 * d.itemsize
    s = d.astype(_UINT_OF[d.itemsize])
    sd = d.view(np.dtype(f"int{bits}"))
    return ((sd << 1) ^ (sd >> (bits - 1))).view(s.dtype)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    half = z >> 1                      # unsigned shift
    return np.where(z & 1, ~half, half)


def compress_latent(arr: np.ndarray, level: int = 6) -> bytes:
    """Compress a numeric ndarray losslessly.  Layout-aware: delta runs
    along the last axis (innermost spatial dim for HWC/CHW latents)."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype
    if dt.kind == "f":
        u = arr.view(_UINT_OF[dt.itemsize])
        u = _float_to_ordered_uint(u)
    elif dt.kind in "ui":
        u = arr.view(_UINT_OF[dt.itemsize]) if dt.kind == "i" else arr
    else:
        raise TypeError(f"unsupported dtype {dt}")

    flat = u.reshape(-1, arr.shape[-1]) if arr.ndim > 1 else u.reshape(1, -1)
    delta = flat.copy()
    delta[:, 1:] = flat[:, 1:] - flat[:, :-1]       # wrap-around uint delta
    zz = _zigzag(delta)

    # byte-plane shuffle: [n_elems, itemsize] -> itemsize planes
    raw = zz.reshape(-1).view(np.uint8).reshape(-1, dt.itemsize)
    shuffled = np.ascontiguousarray(raw.T).tobytes()
    payload = zlib.compress(shuffled, level)

    dstr = dt.str.encode()                          # e.g. b'<f2'
    header = MAGIC + struct.pack(
        "<B B B I", len(dstr), arr.ndim, 0, len(payload)) + dstr + struct.pack(
        f"<{arr.ndim}q", *arr.shape)
    return header + payload


def decompress_latent(blob: bytes) -> np.ndarray:
    if blob[:4] == MAGIC_LOSSY:
        return _decompress_lossy(blob)
    if blob[:4] != MAGIC:
        raise ValueError("not an LBC1/LBQ1 blob")
    dlen, ndim, _pad, plen = struct.unpack_from("<B B B I", blob, 4)
    off = 4 + 7
    dt = np.dtype(blob[off:off + dlen].decode())
    off += dlen
    shape = struct.unpack_from(f"<{ndim}q", blob, off)
    off += 8 * ndim
    payload = zlib.decompress(blob[off:off + plen])

    n_elems = int(np.prod(shape))
    planes = np.frombuffer(payload, np.uint8).reshape(dt.itemsize, n_elems)
    zz = np.ascontiguousarray(planes.T).reshape(-1).view(
        _UINT_OF[dt.itemsize]).copy()

    delta = _unzigzag(zz).reshape(-1, shape[-1] if ndim > 1 else n_elems)
    u = _cumsum_wrap(delta)

    if dt.kind == "f":
        u = _ordered_uint_to_float_bits(u)
        return u.view(dt).reshape(shape)
    if dt.kind == "i":
        return u.view(dt).reshape(shape)
    return u.astype(dt).reshape(shape)


def _cumsum_wrap(delta: np.ndarray) -> np.ndarray:
    """Wrap-around (modular) cumulative sum along axis 1."""
    # np.cumsum upcasts; do it in the same unsigned dtype via add.accumulate
    return np.add.accumulate(delta, axis=1, dtype=delta.dtype)


def compression_ratio(arr: np.ndarray, level: int = 6) -> Tuple[int, int, float]:
    blob = compress_latent(arr, level)
    raw = arr.nbytes
    return raw, len(blob), raw / len(blob)


# ---------------------------------------------------------------------------
# Lossy variant (LBQ1): uniform quantization + the same entropy stack.
# ---------------------------------------------------------------------------

def compress_latent_lossy(arr: np.ndarray, bits: int, rung: int = 0,
                          level: int = 6) -> bytes:
    """Quantize a float tensor to ``bits`` bits per element over its
    observed finite range, then run the lossless delta/zigzag/byte-plane
    stack on the quantized codes.  ``rung`` is recorded in the header so
    a blob knows its own ladder position (see :func:`blob_rung`)."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype
    if dt.kind != "f":
        raise TypeError(f"lossy codec is float-only, got {dt}")
    if not 1 <= int(bits) <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    bits = int(bits)

    f = arr.astype(np.float64, copy=False)
    finite = np.isfinite(f)
    if finite.all():
        lo, hi = float(f.min()), float(f.max())
    elif finite.any():
        lo, hi = float(f[finite].min()), float(f[finite].max())
        f = np.clip(np.nan_to_num(f, nan=lo, posinf=hi, neginf=lo), lo, hi)
    else:                                   # no finite values at all
        lo = hi = 0.0
        f = np.zeros_like(f)

    levels = (1 << bits) - 1
    scale = (hi - lo) / levels if hi > lo else 0.0
    q = (np.round((f - lo) / scale) if scale
         else np.zeros_like(f)).astype(
        np.uint8 if bits <= 8 else np.uint16)

    flat = q.reshape(-1, arr.shape[-1]) if arr.ndim > 1 else q.reshape(1, -1)
    delta = flat.copy()
    delta[:, 1:] = flat[:, 1:] - flat[:, :-1]
    zz = _zigzag(delta)
    raw = zz.reshape(-1).view(np.uint8).reshape(-1, q.itemsize)
    payload = zlib.compress(np.ascontiguousarray(raw.T).tobytes(), level)

    dstr = dt.str.encode()
    return (MAGIC_LOSSY
            + struct.pack("<B B B B I", len(dstr), arr.ndim, bits,
                          int(rung) & 0xFF, len(payload))
            + dstr + struct.pack(f"<{arr.ndim}q", *arr.shape)
            + struct.pack("<dd", lo, hi) + payload)


def _decompress_lossy(blob: bytes) -> np.ndarray:
    dlen, ndim, bits, _rung, plen = struct.unpack_from("<B B B B I", blob, 4)
    off = 4 + 8
    dt = np.dtype(blob[off:off + dlen].decode())
    off += dlen
    shape = struct.unpack_from(f"<{ndim}q", blob, off)
    off += 8 * ndim
    lo, hi = struct.unpack_from("<dd", blob, off)
    off += 16
    payload = zlib.decompress(blob[off:off + plen])

    qdt = np.dtype(np.uint8 if bits <= 8 else np.uint16)
    n_elems = int(np.prod(shape))
    planes = np.frombuffer(payload, np.uint8).reshape(qdt.itemsize, n_elems)
    zz = np.ascontiguousarray(planes.T).reshape(-1).view(qdt).copy()
    delta = _unzigzag(zz).reshape(-1, shape[-1] if ndim > 1 else n_elems)
    q = _cumsum_wrap(delta).astype(np.float64)

    levels = (1 << int(bits)) - 1
    scale = (hi - lo) / levels if hi > lo else 0.0
    return (lo + q * scale).astype(dt).reshape(shape)


def blob_rung(blob: bytes) -> int:
    """Ladder rung a durable blob was encoded at (0 = lossless LBC1)."""
    if blob[:4] == MAGIC:
        return 0
    if blob[:4] == MAGIC_LOSSY:
        return blob[7]
    raise ValueError("not an LBC1/LBQ1 blob")

"""Decoder weight quantization and the +-1-LSB serving gate (counterpart
of the JAX package's ``vae/quantize.py``).

Storage per ``weight_dtype``:

=========  ==========================================================
float32    identity (the oracle).
bfloat16   every >=2-D weight (convs and attention denses) in bf16;
           biases and GroupNorm affines stay fp32.  ~2 bytes/param.
int8       4-D conv weights -> :class:`QuantizedWeight` (symmetric
           per-output-channel scale, fp32 accumulation); 2-D denses
           in bf16.  ~1 byte/param on the conv-dominated decoder.
=========  ==========================================================

The conv kernels read bf16 and int8 weights in their storage dtype and
fold the int8 scale into the fp32 accumulator
(:mod:`repro_torch.kernels.ops`), so no fp32 copy of a quantized weight
is made in device memory.

**The gate.**  A quantized decoder is admitted only if its uint8 pixels
differ from the fp32-weight oracle's by at most +-1 LSB at every decode
bucket (:func:`check_u8_gate`); the engine runs the check when it opens
and refuses the configuration otherwise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import QuantizedWeight
from repro_torch.vae.model import map_params, probe_latents

WEIGHT_DTYPES = ("float32", "bfloat16", "int8")

#: Nominal storage cost (bytes/param) per mode on the conv-dominated
#: decoder; :func:`decoder_storage` measures a real tree.
BYTES_PER_PARAM = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0}


class QuantizationGateError(ValueError):
    """A quantized decoder breached the +-1-LSB uint8 output gate (the
    configuration is refused; serving stays on fp32 weights)."""


# ---------------------------------------------------------------------------
# array-level quantizers
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8: ``scale[c] = max|w[..., c]| /
    127`` (1 for an all-zero channel), ``q = clip(round(w / scale))``
    with round half to even, as ``jnp.round`` does."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q.contiguous(), scale.contiguous())


def _to_bf16(p):
    return p.to(torch.bfloat16) if p.ndim >= 2 else p


def _to_int8(p):
    if p.ndim == 4:
        return quantize_int8(p)
    if p.ndim >= 2:
        return p.to(torch.bfloat16)
    return p


#: ``weight_dtype -> params tree transform``; a registry, so tests can
#: install an out-of-tolerance quantizer and see the gate refuse it.
QUANTIZERS: Dict[str, Callable[[Any], Any]] = {
    "float32": lambda params: params,
    "bfloat16": lambda params: map_params(params, _to_bf16),
    "int8": lambda params: map_params(params, _to_int8),
}


def quantize_decoder(params, weight_dtype: str):
    """The ``weight_dtype`` storage form of a decoder tree (the fp32
    tree is left as it is: it stays the gate's oracle)."""
    try:
        quantizer = QUANTIZERS[weight_dtype]
    except KeyError:
        raise ValueError(
            f"weight_dtype must be one of {tuple(QUANTIZERS)}: "
            f"{weight_dtype!r}") from None
    return quantizer(params)


def decoder_storage(params) -> Dict[str, float]:
    """Measured storage of a (possibly quantized) parameter tree."""
    leaves = []
    map_params(params, leaves.append)
    nbytes = sum(int(p.nbytes) for p in leaves)
    count = sum(int(p.numel()) for p in leaves)
    return {"bytes": float(nbytes), "params": float(count),
            "bytes_per_param": nbytes / max(count, 1)}


# ---------------------------------------------------------------------------
# the +-1-LSB uint8 output gate
# ---------------------------------------------------------------------------

def gate_max_lsb(vae, buckets: Sequence[int],
                 latent_hwc: Tuple[int, int, int],
                 seed: int = 0) -> Dict[int, int]:
    """Per-bucket max |uint8 difference| between the quantized and the
    fp32-oracle ``decode_u8`` on shared probe latents."""
    out: Dict[int, int] = {}
    for b in sorted(set(int(x) for x in buckets)):
        z = probe_latents(latent_hwc, b, seed)
        ref = vae.decode_u8(z, precision="float32").cpu().numpy()
        got = vae.decode_u8(z).cpu().numpy()
        out[b] = int(np.max(np.abs(ref.astype(np.int16)
                                   - got.astype(np.int16))))
    return out


def check_u8_gate(vae, buckets: Sequence[int],
                  latent_hwc: Tuple[int, int, int], seed: int = 0,
                  tol: int = 1) -> Dict[int, int]:
    """Run the gate; returns the per-bucket max LSB error, raising
    :class:`QuantizationGateError` if any bucket exceeds ``tol``."""
    lsb = gate_max_lsb(vae, buckets, latent_hwc, seed=seed)
    bad = {b: v for b, v in lsb.items() if v > tol}
    if bad:
        raise QuantizationGateError(
            f"weight_dtype={vae.weight_dtype!r} breaches the +-{tol}-LSB "
            f"uint8 gate on bucket(s) {bad} (per-bucket max LSB: {lsb}); "
            f"config rejected: serve float32 weights or a gentler "
            f"weight_dtype")
    return lsb


# ---------------------------------------------------------------------------
# test and smoke fixture
# ---------------------------------------------------------------------------

def snap_to_grid(vae) -> None:
    """Snap the decoder's weights (in place) onto their quantized storage
    grids: 4-D convs onto the symmetric int8 grid, other >=2-D weights
    onto bf16, so that int8 storage round-trips exactly.  A fixture: it
    turns the gate into a check of storage and plumbing, with no
    approximation error in the way."""
    def snap(p):
        if p.ndim == 4:
            return quantize_int8(p).dequant(torch.float32)
        if p.ndim >= 2:
            return p.to(torch.bfloat16).float()
        return p
    vae.decoder = map_params(vae.decoder, snap)
    vae.set_weight_dtype(vae.weight_dtype)

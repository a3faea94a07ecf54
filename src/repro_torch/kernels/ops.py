"""The kernel layer of the port: one entry point per kernel, and the
launch counters.

The tensor's device picks the implementation.  A CPU tensor runs the
kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA
tensor launches the hand-written Hopper kernel or raises.  There is no
process-wide ``impl`` switch and no fallback from a CUDA tensor to the
plain version.

The four decode-path conv kernels (``conv3x3``, ``gn_silu_conv3x3``,
``upsample_conv3x3``, ``output_epilogue``) take their weight in its
storage form: an fp32 or bf16 tensor, or a :class:`QuantizedWeight`
(int8 codes plus a per-output-channel fp32 scale).  The kernels read the
stored type and fold the scale into the fp32 accumulator, so no fp32
copy of a quantized weight is made in device memory (the JAX package's
``kernels/ops.py``).

Each wrapper counts its kernel launches in a plain integer (the module
attribute ``launches`` of its kernel module, incremented right after a
successful launch and nowhere else); :func:`launch_counts` reads them
and :func:`reset_launch_counts` sets them to 0, so a run can show that
the main path went through every kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import conv3x3 as _conv3x3
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import flash_attention_bwd as _flash_attention_bwd
from repro_torch.kernels import gn_silu as _gn_silu
from repro_torch.kernels import gn_silu_conv as _gn_silu_conv
from repro_torch.kernels import output_epilogue as _output_epilogue
from repro_torch.kernels import rwkv6_scan as _rwkv6_scan
from repro_torch.kernels import rwkv6_scan_bwd as _rwkv6_scan_bwd
from repro_torch.kernels import upsample_conv as _upsample_conv

group_norm_silu = _gn_silu.group_norm_silu
flash_attention = _flash_attention.flash_attention
decode_attention = _decode_attention.decode_attention
decode_attention_partial = _decode_attention.decode_attention_partial
merge_partials = _decode_attention.merge_partials
rwkv6_scan = _rwkv6_scan.rwkv6_scan


class QuantizedWeight:
    """int8 weight storage plus a per-output-channel fp32 scale.

    ``q`` keeps the weight's shape in int8; ``scale`` is ``[Cout]`` (the
    last axis).  The logical value is ``q * scale``: the kernels read
    ``q`` and multiply each output channel's fp32 sum by its scale, so
    the dequantized weight never exists in device memory."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    @property
    def size(self) -> int:
        return self.q.numel()

    def numel(self) -> int:
        return self.q.numel()

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The logical tensor (the plain paths and the 1x1 shortcut only;
        the kernels never call this)."""
        return (self.q.float() * self.scale).to(dtype)

    def __repr__(self) -> str:
        return (f"QuantizedWeight(shape={self.shape}, "
                f"scale[{self.scale.shape[0]}])")


def weight_dtype_of(w) -> str:
    """The storage tag of a kernel weight: 'float32', 'bfloat16' or
    'int8'."""
    if isinstance(w, QuantizedWeight):
        return "int8"
    return str(w.dtype).replace("torch.", "")


def weight_parts(w) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the weight in its storage dtype, the per-Cout scale or None)."""
    if isinstance(w, QuantizedWeight):
        return w.q, w.scale
    return w, None


def conv3x3(x, w, b=None):
    """3x3 SAME conv; ``w`` fp32, bf16 or :class:`QuantizedWeight`."""
    wq, s = weight_parts(w)
    return _conv3x3.conv3x3(x, wq, b, w_scale=s)


def gn_silu_conv3x3(x, scale, bias, w, b=None, groups: int = 32,
                    eps: float = 1e-6):
    """Fused GroupNorm + SiLU + 3x3 conv; ``w`` as for :func:`conv3x3`."""
    wq, s = weight_parts(w)
    return _gn_silu_conv.gn_silu_conv3x3(x, scale, bias, wq, b, groups=groups,
                                         eps=eps, w_scale=s)


def upsample_conv3x3(x, w, b=None):
    """Nearest-2x upsample + 3x3 conv; ``w`` as for :func:`conv3x3`."""
    wq, s = weight_parts(w)
    return _upsample_conv.upsample_conv3x3(x, wq, b, w_scale=s)


def upsample_conv3x3_taps(x, wc, b=None):
    """The upsampler from taps collapsed beforehand
    (``ref.storage_phase_weights`` of the filter, ``[2, 2, 2, 2, Cin,
    Cout]``): fp32, bf16, or a :class:`QuantizedWeight` of int16 codes
    with the filter's per-Cout scale."""
    wq, s = weight_parts(wc)
    return _upsample_conv.upsample_conv3x3_taps(x, wq, b, w_scale=s)


def output_epilogue(x, scale, bias, w, b=None, groups: int = 32,
                    eps: float = 1e-6):
    """GroupNorm + SiLU + conv_out + clamp + uint8; ``w`` as for
    :func:`conv3x3`."""
    wq, s = weight_parts(w)
    return _output_epilogue.output_epilogue(x, scale, bias, wq, b,
                                            groups=groups, eps=eps,
                                            w_scale=s)


#: kernel name -> the module that holds its wrapper and launch counter
KERNEL_MODULES = {
    "conv3x3": _conv3x3,
    "gn_silu_conv3x3": _gn_silu_conv,
    "upsample_conv3x3": _upsample_conv,
    "output_epilogue": _output_epilogue,
    "flash_attention": _flash_attention,
    "flash_attention_bwd": _flash_attention_bwd,
    "group_norm_silu": _gn_silu,
    "decode_attention": _decode_attention,
    "rwkv6_scan": _rwkv6_scan,
    "rwkv6_scan_bwd": _rwkv6_scan_bwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0

"""The kernel layer of the port: one entry point per kernel, and the
launch counters.

The tensor's device picks the implementation.  A CPU tensor runs the
kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA
tensor launches the hand-written Hopper kernel or raises.  There is no
process-wide ``impl`` switch and no fallback from a CUDA tensor to the
plain version.

Each wrapper counts its kernel launches in a plain integer (the module
attribute ``launches`` of its kernel module, incremented right after a
successful launch and nowhere else); :func:`launch_counts` reads them
and :func:`reset_launch_counts` sets them to 0, so a run can show that
the main path went through every kernel.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import conv3x3 as _conv3x3
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import gn_silu as _gn_silu
from repro_torch.kernels import gn_silu_conv as _gn_silu_conv
from repro_torch.kernels import output_epilogue as _output_epilogue
from repro_torch.kernels import rwkv6_scan as _rwkv6_scan
from repro_torch.kernels import upsample_conv as _upsample_conv

conv3x3 = _conv3x3.conv3x3
gn_silu_conv3x3 = _gn_silu_conv.gn_silu_conv3x3
group_norm_silu = _gn_silu.group_norm_silu
upsample_conv3x3 = _upsample_conv.upsample_conv3x3
output_epilogue = _output_epilogue.output_epilogue
flash_attention = _flash_attention.flash_attention
decode_attention = _decode_attention.decode_attention
rwkv6_scan = _rwkv6_scan.rwkv6_scan

#: kernel name -> the module that holds its wrapper and launch counter
KERNEL_MODULES = {
    "conv3x3": _conv3x3,
    "gn_silu_conv3x3": _gn_silu_conv,
    "upsample_conv3x3": _upsample_conv,
    "output_epilogue": _output_epilogue,
    "flash_attention": _flash_attention,
    "group_norm_silu": _gn_silu,
    "decode_attention": _decode_attention,
    "rwkv6_scan": _rwkv6_scan,
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0

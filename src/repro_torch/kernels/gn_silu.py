"""Standalone GroupNorm + SiLU (counterpart of the JAX package's
``kernels/gn_silu.py``): the encoder's and the float decode's
``norm_out``, where no conv follows that could take it as a prologue.

On CUDA: ``csrc/gn_stats.cu`` computes the per-(n, group) statistics
(two launches: the coalesced partial pass and the fixed-order merge),
then ``csrc/gn_silu.cu`` normalises, applies the affine and the SiLU in
one float4 pass with four loads in flight per thread.  On the CPU: the
plain version, ``ref.group_norm_silu_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gn_silu_conv import gn_stats

#: kernel launches of :func:`group_norm_silu` in this process
launches = 0


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """``silu(group_norm(x) * scale + bias)``, fp32 statistics.  x
    [N, H, W, C] NHWC, scale/bias [C] -> [N, H, W, C]."""
    global launches
    if x.device.type == "cpu":
        return ref.group_norm_silu_ref(x, scale, bias, groups, eps)
    build.require("group_norm_silu", x=x, scale=scale, bias=bias)
    n, h, w, c = x.shape
    if c % 4 or c % groups or tuple(scale.shape) != (c,) or \
            tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm_silu: C={c} must be a multiple of 4 "
                         f"and of groups={groups}, scale/bias [C]; got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_silu: x must be 16-byte aligned "
                         "(float4 loads)")
    stats = gn_stats(x, groups, eps)
    out = torch.empty_like(x)
    build.check(build.lib("gn_silu").gn_silu_launch(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h * w, c, groups, build.stream_of(x)),
        "group_norm_silu")
    launches += 1
    return out

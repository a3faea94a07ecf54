"""Fused GroupNorm + SiLU + 3x3 conv, the decoder's res-block hot path
(counterpart of the JAX package's ``kernels/gn_silu_conv.py``).

On CUDA: ``csrc/gn_stats.cu`` computes the per-(n, group) statistics,
then ``csrc/gn_silu_conv.cu`` normalises, activates and convolves the
input halo in shared memory (the normalised activation never reaches
device memory), an implicit GEMM in 3xTF32 on the tensor cores (two
TF32 products per product for bf16 and int8 weights, which TF32 holds
exactly).  On the CPU: the plain version, ``ref.gn_silu_conv3x3_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`gn_silu_conv3x3` in this process
launches = 0

#: elements of one (n, group) a statistics block reduces, about
STATS_BLOCK_ELEMS = 8192


def gn_stats(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Launch the statistics pass: ``[N, G, 2]`` fp32 (mean, rstd) of an
    NHWC CUDA tensor (a launch helper of this kernel and of
    ``output_epilogue``; not counted on its own)."""
    n, h, w, c = x.shape
    hw, cpg = h * w, c // groups
    slices = max(1, min(hw, -(-hw * cpg // STATS_BLOCK_ELEMS)))
    partial = torch.empty((n, groups, slices, 3), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    build.check(build.lib("gn_stats").gn_stats_launch(
        x.data_ptr(), partial.data_ptr(), stats.data_ptr(), n, hw, c,
        groups, slices, float(eps), build.stream_of(x)), "gn_stats")
    return stats


def check_gn_conv(what, x, scale, bias, w, b, groups, w_scale=None):
    """Validate a GN-prologue conv call; returns the bias (zeros if None),
    the weight's storage code and its scale's pointer (0 if none)."""
    if b is None:
        b = torch.zeros(w.shape[-1], dtype=torch.float32, device=x.device)
    build.require(what, x=x, scale=scale, bias=bias, b=b)
    wcode, sptr = build.conv_weight(what, w, w_scale)
    n, h, wd, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{what}: w must be [3, 3, {cin}, Cout], got "
                         f"{tuple(w.shape)}")
    if cin % groups or tuple(scale.shape) != (cin,) or \
            tuple(bias.shape) != (cin,) or tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"{what}: bad GroupNorm/bias shapes for Cin={cin}, "
                         f"groups={groups}")
    return b, wcode, sptr


def gn_silu_conv3x3(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    w: torch.Tensor, b: Optional[torch.Tensor] = None,
                    groups: int = 32, eps: float = 1e-6,
                    w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(silu(group_norm(x)))``.  x [N, H, W, Cin] NHWC, scale/bias
    [Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with w_scale [Cout]),
    b [Cout] -> [N, H, W, Cout]."""
    global launches
    if x.device.type == "cpu":
        return ref.gn_silu_conv3x3_ref(x, scale, bias, w, b, groups, eps,
                                       w_scale)
    b, wcode, sptr = check_gn_conv("gn_silu_conv3x3", x, scale, bias, w, b,
                                   groups, w_scale)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    stats = gn_stats(x, groups, eps)
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    build.check(build.lib("gn_silu_conv").gn_silu_conv3x3_launch(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        w.data_ptr(), sptr, b.data_ptr(), out.data_ptr(), n, h, wd, cin,
        cout, groups, wcode, build.stream_of(x)), "gn_silu_conv3x3")
    launches += 1
    return out

"""Fused GroupNorm + SiLU + 3x3 conv, the decoder's res-block hot path
(counterpart of the JAX package's ``kernels/gn_silu_conv.py``).

On CUDA: ``csrc/gn_stats.cu`` computes the per-(n, group) statistics,
then ``csrc/gn_silu_conv.cu`` normalises, activates and convolves the
input halo in shared memory (the normalised activation never reaches
device memory), an implicit GEMM in 3xTF32 on the warpgroup tile of
``csrc/wg_conv_tile.cuh`` (``wgmma`` TF32 products; two TF32 products
per product for bf16 and int8 weights, which TF32 holds exactly).  The
tile's layout code (``layout``: the tile has one, 0 or its name 1; see
:mod:`repro_torch.kernels.autotune`) is the active tuning cache's for the
call's shape, or the shape's default.  On the CPU: the plain version,
``ref.gn_silu_conv3x3_ref``, which takes no layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, build, ref

#: kernel launches of :func:`gn_silu_conv3x3` in this process
launches = 0

#: the statistics pass's pixel slices per image (``csrc/gn_stats.cu``):
#: about this many elements each (256 KB), at least MIN_STATS_SLICES (one
#: block per SM of an H100) and at most MAX_STATS_SLICES, the fastest on
#: the card at the VAE's shapes (a block's merge and the second pass grow
#: with the slices)
STATS_BLOCK_ELEMS = 65536
MIN_STATS_SLICES = 132
MAX_STATS_SLICES = 512


def stats_slices(hw: int, c: int) -> int:
    """Pixel slices of one image in the statistics pass, from the shape
    alone (never the batch), so each image's statistics have the same
    bits at every batch size; every slice holds ceil(hw / slices)
    pixels but the last, which holds at least one."""
    want = -(-hw * c // STATS_BLOCK_ELEMS)
    s = max(1, min(hw, MAX_STATS_SLICES, max(want, MIN_STATS_SLICES)))
    return -(-hw // -(-hw // s))


def gn_stats(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Launch the statistics pass: ``[N, G, 2]`` fp32 (mean, rstd) of an
    NHWC CUDA tensor (a launch helper of this kernel, ``output_epilogue``
    and ``group_norm_silu``; not counted on its own)."""
    n, h, w, c = x.shape
    hw = h * w
    slices = stats_slices(hw, c)
    buf = torch.empty(n * groups * (slices * 3 + 2), dtype=torch.float32,
                      device=x.device)
    stats = buf[:n * groups * 2].view(n, groups, 2)
    partial = buf[n * groups * 2:]
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
                    w_scale: Optional[torch.Tensor] = None,
                    layout: Optional[int] = None) -> torch.Tensor:
    """``conv3x3(silu(group_norm(x)))``.  x [N, H, W, Cin] NHWC, scale/bias
    [Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with w_scale [Cout]),
    b [Cout] -> [N, H, W, Cout].  ``layout`` as for
    :func:`repro_torch.kernels.conv3x3.conv3x3`."""
    global launches
    if x.device.type == "cpu":
        return ref.gn_silu_conv3x3_ref(x, scale, bias, w, b, groups, eps,
                                       w_scale)
    b, wcode, sptr = check_gn_conv("gn_silu_conv3x3", x, scale, bias, w, b,
                                   groups, w_scale)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if layout is None:
        layout = autotune.launch_knob("gn_silu_conv3x3", x.shape, cout, w)
    stats = gn_stats(x, groups, eps)
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    build.check(build.lib("gn_silu_conv").gn_silu_conv3x3_launch(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        w.data_ptr(), sptr, b.data_ptr(), out.data_ptr(), n, h, wd, cin,
        cout, groups, wcode, layout, build.stream_of(x)),
        f"gn_silu_conv3x3 (layout {layout})")
    launches += 1
    return out


def wgmma_tf32_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ``wgmma`` TF32 product on the card through the conv tile's
    operand layouts (``csrc/wg_conv_tile.cuh``: A as a halo plane, B as a
    weight slot, both K-major): a [64, 8] @ b [8, 128] ->
    [64, 128] fp32, each input used as its TF32 bits (a check of the
    layouts against a product on the CPU; not a wrapper of the main path,
    so it counts no launch)."""
    build.require("wgmma_tf32_probe", a=a, b=b)
    if tuple(a.shape) != (64, 8) or tuple(b.shape) != (8, 128):
        raise ValueError(f"wgmma_tf32_probe: a [64, 8] and b [8, 128], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    d = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    build.check(build.lib("gn_silu_conv").wgmma_tf32_probe_launch(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), build.stream_of(a)),
        "wgmma_tf32_probe")
    return d

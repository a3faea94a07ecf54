"""3x3 SAME conv, NHWC x HWIO (counterpart of the JAX package's
``kernels/conv3x3.py``).

On CUDA: ``csrc/conv3x3.cu``, reading the weight in its storage dtype
(fp32, bf16, or int8 with a per-Cout scale applied to the fp32 sum):
for Cout > 4 the 3xTF32 tensor-core tile, its K split over a thread
block cluster of :func:`k_split` blocks where Cout <= 32; for Cout <= 4
the CUDA-core tile.  The wide tile's layout (``layout``; see
:mod:`repro_torch.kernels.autotune`) is the active tuning cache's for the
call's shape, or the shape's default.  On the CPU: the plain version,
``ref.conv3x3_ref``, which takes no layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, build, ref

#: kernel launches of :func:`conv3x3` in this process
launches = 0

#: the tensor-core tile's geometry (``csrc/tc_conv_tile.cuh``): pixels per
#: block (4 rows x 32), input channels per K chunk, the narrow Cout tile
TILE_H, TILE_W, CHUNK, NARROW_COUT = 4, 32, 16, 32
#: blocks per image a K split aims for: two per SM of an H100 (132 SMs)
SPLIT_BLOCKS = 256
MAX_SPLIT = 8


def k_split(h: int, w: int, cin: int, cout: int) -> int:
    """Cluster blocks that split K (9 taps x Cin) of one output tile of
    the 32-wide tensor-core tile (4 < Cout <= 32), else 1.

    The split doubles while the image's tiles times the split stay within
    ``SPLIT_BLOCKS`` and every block keeps at least one 16-channel chunk.
    It follows from the shape alone, never from the batch: the sum order
    of every output is fixed by (H, W, Cin, Cout), so an image decoded or
    encoded in a batch gives the bits it gives alone (the encoder's
    conv_out, 64 x 64 x 512 -> 32: 32 tiles, split 8)."""
    if not 4 < cout <= NARROW_COUT:
        return 1
    tiles = -(-h // TILE_H) * -(-w // TILE_W)
    chunks = -(-cin // CHUNK)
    ks = 1
    while (ks < MAX_SPLIT and tiles * ks * 2 <= SPLIT_BLOCKS
           and chunks >= ks * 2):
        ks *= 2
    return ks


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None,
            w_scale: Optional[torch.Tensor] = None,
            layout: Optional[int] = None) -> torch.Tensor:
    """x [N, H, W, Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with
    w_scale [Cout]), b [Cout] -> [N, H, W, Cout].  ``layout``: the tile
    layout code (None: the tuned one or the default; a code the shape's
    route lacks raises)."""
    global launches
    if x.device.type == "cpu":
        return ref.conv3x3_ref(x, w, b, w_scale)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if b is None:
        b = torch.zeros(cout, dtype=torch.float32, device=x.device)
    build.require("conv3x3", x=x, b=b)
    wcode, sptr = build.conv_weight("conv3x3", w, w_scale)
    if tuple(w.shape[:3]) != (3, 3, cin) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3: w must be [3, 3, {cin}, Cout] and b "
                         f"[Cout], got {tuple(w.shape)}, {tuple(b.shape)}")
    if layout is None:
        layout = autotune.launch_knob("conv3x3", x.shape, cout, w)
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    build.check(build.lib("conv3x3").conv3x3_launch(
        x.data_ptr(), w.data_ptr(), sptr, b.data_ptr(), out.data_ptr(), n,
        h, wd, cin, cout, k_split(h, wd, cin, cout), wcode, layout,
        build.stream_of(x)), f"conv3x3 (layout {layout})")
    launches += 1
    return out

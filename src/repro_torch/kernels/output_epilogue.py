"""Fused decode epilogue: GroupNorm + SiLU + conv_out + clamp + uint8
(counterpart of the JAX package's ``kernels/output_epilogue.py``).

On CUDA: ``csrc/gn_stats.cu`` then ``csrc/output_epilogue.cu``: the
whole filter (three output channels a block, the weight read in its
storage dtype) staged once in shared memory, the input halo by cp.async
in 16-channel chunks, GN + SiLU applied once per halo element, the
products on the CUDA cores, and the uint8 store, so the decode's last
write is the displayable image itself.  The pixel tile's height
(``tile_h``; see :mod:`repro_torch.kernels.autotune`) is the active
tuning cache's for the call's shape, or 16.
On the CPU: the plain version, ``ref.output_epilogue_ref``, which takes
no tile height.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, build, ref
from repro_torch.kernels.gn_silu_conv import check_gn_conv, gn_stats

#: kernel launches of :func:`output_epilogue` in this process
launches = 0


def output_epilogue(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    w: torch.Tensor, b: Optional[torch.Tensor] = None,
                    groups: int = 32, eps: float = 1e-6,
                    w_scale: Optional[torch.Tensor] = None,
                    tile_h: Optional[int] = None) -> torch.Tensor:
    """``quantize_u8(conv3x3(silu(group_norm(x))))``.  x [N, H, W, Cin]
    NHWC, scale/bias [Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with
    w_scale [Cout]), b [Cout] -> uint8 [N, H, W, Cout].  ``tile_h``: the
    pixel tile's height, 16 or 8 (None: the tuned one or 16; a height the
    kernel lacks raises)."""
    global launches
    if x.device.type == "cpu":
        return ref.output_epilogue_ref(x, scale, bias, w, b, groups, eps,
                                       w_scale)
    b, wcode, sptr = check_gn_conv("output_epilogue", x, scale, bias, w, b,
                                   groups, w_scale)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if tile_h is None:
        tile_h = autotune.launch_knob("output_epilogue", x.shape, cout, w)
    stats = gn_stats(x, groups, eps)
    out = torch.empty((n, h, wd, cout), dtype=torch.uint8, device=x.device)
    build.check(build.lib("output_epilogue").output_epilogue_launch(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        w.data_ptr(), sptr, b.data_ptr(), out.data_ptr(), n, h, wd, cin,
        cout, groups, wcode, tile_h, build.stream_of(x)),
        f"output_epilogue (tile_h {tile_h})")
    launches += 1
    return out

"""3x3 SAME conv, NHWC x HWIO (counterpart of the JAX package's
``kernels/conv3x3.py``).

On CUDA: ``csrc/conv3x3.cu`` with no prologue and the fp32 epilogue,
reading the weight in its storage dtype (fp32, bf16, or int8 with a
per-Cout scale applied to the fp32 sum).  On the CPU: the plain
version, ``ref.conv3x3_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`conv3x3` in this process
launches = 0


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None,
            w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H, W, Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with
    w_scale [Cout]), b [Cout] -> [N, H, W, Cout]."""
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
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    build.check(build.lib("conv3x3").conv3x3_launch(
        x.data_ptr(), 0, 0, 0, w.data_ptr(), sptr, b.data_ptr(),
        out.data_ptr(), n, h, wd, cin, cout, 1, 0, 0, wcode,
        build.stream_of(x)), "conv3x3")
    launches += 1
    return out

"""Fused nearest-2x upsample + 3x3 SAME conv, the decoder's upsampler
(counterpart of the JAX package's ``kernels/upsample_conv.py``).

On CUDA: the weights collapse into per-phase 2x2 filters
(``ref.phase_weights``, a few tensor additions per call), then
``csrc/upsample_conv.cu`` computes the four phases from the
pre-upsample tensor; the 4x upsampled intermediate never exists.  On
the CPU: the plain version, ``ref.upsample_conv3x3_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`upsample_conv3x3` in this process
launches = 0


def upsample_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H, W, Cin], w [3, 3, Cin, Cout], b [Cout] -> [N, 2H, 2W, Cout]."""
    global launches
    if x.device.type == "cpu":
        return ref.upsample_conv3x3_ref(x, w, b)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if b is None:
        b = torch.zeros(cout, dtype=torch.float32, device=x.device)
    build.require("upsample_conv3x3", x=x, w=w, b=b)
    if tuple(w.shape[:3]) != (3, 3, cin) or tuple(b.shape) != (cout,):
        raise ValueError(f"upsample_conv3x3: w must be [3, 3, {cin}, Cout] "
                         f"and b [Cout], got {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    wc = ref.phase_weights(w).contiguous()       # [2, 2, 2, 2, Cin, Cout]
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.float32,
                      device=x.device)
    build.check(build.lib("upsample_conv").upsample_conv3x3_launch(
        x.data_ptr(), wc.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, h, wd, cin, cout, build.stream_of(x)), "upsample_conv3x3")
    launches += 1
    return out

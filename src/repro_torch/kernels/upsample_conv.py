"""Fused nearest-2x upsample + 3x3 SAME conv, the decoder's upsampler
(counterpart of the JAX package's ``kernels/upsample_conv.py``).

On CUDA: the weights collapse into per-phase 2x2 filters in their
storage dtype (``ref.storage_phase_weights``: int8 codes in int16, which
holds their sums exactly, bf16 in bf16, rounding as the JAX package's
collapse does), then ``csrc/upsample_conv.cu`` computes the four phases
from the pre-upsample tensor in 3xTF32 on the warpgroup tile of
``csrc/wg_conv_tile.cuh``; the 4x upsampled intermediate never exists.
:func:`upsample_conv3x3_taps` is the launch alone, from taps collapsed
beforehand: the decoder's serving tree holds its upsamplers' taps
collapsed once (``vae/model.py``), so a decode runs no collapse;
:func:`upsample_conv3x3` collapses on every call.  The tile's layout
(``layout``; see :mod:`repro_torch.kernels.autotune`) is the active
tuning cache's for the call's shape, keyed by the filter's storage dtype
(int8 taps, though launched in int16, key as ``"int8"``), or the shape's
default.  On the CPU: the plain versions, ``ref.upsample_conv3x3_ref``
and ``ref.upsample_conv3x3_phase_ref``, which take no layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, build, ref

#: kernel launches of :func:`upsample_conv3x3` (and of
#: :func:`upsample_conv3x3_taps`, which it calls) in this process
launches = 0


def upsample_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None,
                     layout: Optional[int] = None) -> torch.Tensor:
    """x [N, H, W, Cin], w [3, 3, Cin, Cout] (fp32, bf16, or int8 with
    w_scale [Cout]), b [Cout] -> [N, 2H, 2W, Cout].  ``layout`` as for
    :func:`repro_torch.kernels.conv3x3.conv3x3`."""
    if x.device.type == "cpu":
        return ref.upsample_conv3x3_ref(x, w, b, w_scale)
    cin = x.shape[-1]
    build.conv_weight("upsample_conv3x3", w, w_scale)
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"upsample_conv3x3: w must be [3, 3, {cin}, Cout], "
                         f"got {tuple(w.shape)}")
    wc = ref.storage_phase_weights(w).contiguous()   # [2, 2, 2, 2, Cin, Cout]
    return upsample_conv3x3_taps(x, wc, b, w_scale, layout)


def upsample_conv3x3_taps(x: torch.Tensor, wc: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          w_scale: Optional[torch.Tensor] = None,
                          layout: Optional[int] = None) -> torch.Tensor:
    """The upsampler from collapsed taps: x [N, H, W, Cin], wc [2, 2, 2, 2,
    Cin, Cout] (``ref.storage_phase_weights`` of the filter: fp32, bf16,
    or int16 with w_scale [Cout]), b [Cout] -> [N, 2H, 2W, Cout]."""
    global launches
    if x.device.type == "cpu":
        return ref.upsample_conv3x3_phase_ref(x, wc, b, w_scale)
    n, h, wd, cin = x.shape
    cout = wc.shape[-1]
    if b is None:
        b = torch.zeros(cout, dtype=torch.float32, device=x.device)
    build.require("upsample_conv3x3", x=x, b=b)
    wcode, sptr = build.conv_weight("upsample_conv3x3", wc, w_scale,
                                    torch.int16)
    if tuple(wc.shape[:5]) != (2, 2, 2, 2, cin) or tuple(b.shape) != (cout,):
        raise ValueError(f"upsample_conv3x3: wc must be [2, 2, 2, 2, {cin}, "
                         f"Cout] and b [Cout], got {tuple(wc.shape)}, "
                         f"{tuple(b.shape)}")
    if layout is None:
        layout = autotune.launch_knob("upsample_conv3x3", x.shape, cout, wc)
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.float32,
                      device=x.device)
    build.check(build.lib("upsample_conv").upsample_conv3x3_launch(
        x.data_ptr(), wc.data_ptr(), sptr, b.data_ptr(), out.data_ptr(),
        n, h, wd, cin, cout, wcode, layout, build.stream_of(x)),
        f"upsample_conv3x3 (layout {layout})")
    launches += 1
    return out

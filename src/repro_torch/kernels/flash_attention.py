"""Online-softmax attention (counterpart of the JAX package's
``kernels/flash_attention.py``), the VAE mid-block's single head.

On CUDA: ``csrc/flash_attention.cu``, non-causal with one kv head per q
head.  On the CPU: the plain version, ``ref.flash_attention_ref``.  The
causal, sliding-window and GQA cases (the LM's) are refused on every
device until the kernel implements them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`flash_attention` in this process
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [n, h, sq, d], k/v [n, h, skv, d] -> [n, h, sq, d]; ``scale``
    defaults to ``d ** -0.5``."""
    global launches
    if causal or window is not None or q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "flash_attention: causal, sliding-window and GQA attention wait "
            "for the LM slice of the port (ROADMAP: LM substrate)")
    n, h, sq, d = q.shape
    skv = k.shape[2]
    if tuple(k.shape) != (n, h, skv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale)
    build.require("flash_attention", q=q, k=k, v=v)
    if d % 4:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         "of 4")
    out = torch.empty_like(q)
    build.check(build.lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n * h, sq,
        skv, d, scale, build.stream_of(q)), "flash_attention")
    launches += 1
    return out

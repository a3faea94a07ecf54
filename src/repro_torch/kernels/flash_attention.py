"""Online-softmax attention (counterpart of the JAX package's
``kernels/flash_attention.py``): the VAE mid-block's single head and the
LM prefill's causal, sliding-window, grouped-query attention.

On CUDA: ``csrc/flash_attention.cu`` on the tensor cores (bf16 up to
head dim 128 on ``wgmma`` with P rounded to bf16 before P V; fp32 in
3xTF32, up to head dim 128 on ``mma.sync``, above it, with bf16 above
128, on ``wgmma`` with one S per 64-row block and key tile, summed over
a thread block cluster that splits the head dim), fp32 softmax and
accumulation, output in ``q.dtype``.  On the CPU: the plain version,
``ref.flash_attention_ref``.

:func:`flash_attention` goes through :class:`FlashAttention`, so the
output stays in the autograd graph on both devices: the forward is the
kernel (or the plain version on the CPU), the backward
``ref.flash_attention_bwd_ref``, PyTorch arithmetic as the JAX package's
backward is XLA's (no TPU kernel had a backward).  Under
``torch.inference_mode()`` the launch and its bits are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`flash_attention` in this process
launches = 0

#: element types the kernel takes, and their code in the C launcher
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel's forward and a plain backward: saves q,
    k, v and the output, and hands the output's gradient to
    ``ref.flash_attention_bwd_ref``.  Under remat the forward (and so the
    kernel) runs again in the backward pass, and counts again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o = _forward(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = ref.flash_attention_bwd_ref(
                q, k, v, o, do.contiguous(), causal=ctx.causal,
                scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [n, hq, sq, d], k/v [n, hkv, skv, d] with ``hq % hkv == 0`` (q
    head h reads kv head ``h // (hq // hkv)``) -> [n, hq, sq, d].
    ``causal`` and ``window`` mask with q aligned at the sequence end
    (query i sits at position ``i + skv - sq``); ``scale`` defaults to
    ``d ** -0.5``.  Differentiable (:class:`FlashAttention`)."""
    d = q.shape[-1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    return FlashAttention.apply(q, k, v, bool(causal), scale, window)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: float, window: Optional[int]
             ) -> torch.Tensor:
    """The forward alone: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    global launches
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (n, hkv, skv, d) or tuple(v.shape) != tuple(k.shape) \
            or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         "(k/v [n, hkv, skv, d] with hq a multiple of hkv)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       window=window)
    build.require("flash_attention", dtypes=tuple(DTYPES), q=q, k=k, v=v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    align = 4 * q.element_size()            # one 4-element load
    if d % 4 or any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 4 and q/k/v {align}-byte aligned")
    if n * hq > 65535:
        raise ValueError(f"flash_attention: n * hq = {n * hq} exceeds the "
                         "grid's 65535")
    out = torch.empty_like(q)
    build.check(build.lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, hq, hkv,
        sq, skv, d, scale, int(causal), window or 0, DTYPES[q.dtype],
        build.stream_of(q)), "flash_attention")
    launches += 1
    return out


def wide_probe(p: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
               k: torch.Tensor):
    """One ``wgmma`` of each product of the fp32 kernel above head dim 128
    on the card, through its operand layouts: ``p [64, 8] @ v [8, 128]``
    with P from registers in the accumulator layout of S and V in its
    transposed, key-permuted plane, and ``q [64, 8] @ k [64, 8]^T`` with q
    and k in their K-major planes; each input used as its TF32 bits.
    Returns (o [64, 128], s [64, 64]) fp32: a check of the layouts against
    products on the CPU, not a wrapper of the main path, so it counts no
    launch."""
    build.require("flash_wide_probe", p=p, v=v, q=q, k=k)
    shapes = tuple(tuple(t.shape) for t in (p, v, q, k))
    if shapes != ((64, 8), (8, 128), (64, 8), (64, 8)):
        raise ValueError(f"flash_wide_probe: p [64, 8], v [8, 128], q and k "
                         f"[64, 8], got {shapes}")
    o = torch.empty((64, 128), dtype=torch.float32, device=p.device)
    s = torch.empty((64, 64), dtype=torch.float32, device=p.device)
    build.check(build.lib("flash_attention").flash_wide_probe_launch(
        p.data_ptr(), v.data_ptr(), q.data_ptr(), k.data_ptr(), o.data_ptr(),
        s.data_ptr(), build.stream_of(p)), "flash_wide_probe")
    return o, s

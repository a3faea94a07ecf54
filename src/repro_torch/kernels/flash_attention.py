"""Online-softmax attention (counterpart of the JAX package's
``kernels/flash_attention.py``): the VAE mid-block's single head and the
LM prefill's causal, sliding-window, grouped-query attention.

On CUDA: ``csrc/flash_attention.cu`` on the tensor cores, fp32 softmax
and accumulation, output in ``q.dtype``, by one of four routes chosen
before the launch from the type, the head dim and the operands'
alignment alone (:func:`route`; a failed build or launch raises, nothing
is retried on another route):

- ``bf16_tma``: bf16 with d % 8 == 0, d <= 128 and q, k, v 16-byte
  aligned (every model's prefill): a persistent CTA an SM drawing blocks
  of 128 query rows from a counter, a TMA producer warp and two consumer
  warpgroups of 64 rows, 128 x 128 tiles on ``wgmma``, P rounded to bf16
  before P V;
- ``bf16_cp_async``: the rest of bf16 up to d 128 (d % 8 == 4, or
  8-byte-aligned operands): three warpgroups, 64-key tiles by
  ``cp.async`` on ``wgmma``, P rounded to bf16 the same way;
- ``fp32_mma_sync``: fp32 up to d 128 (and any type above d 1024) in
  3xTF32 on ``mma.sync``;
- ``wide_cluster``: fp32 and bf16 above d 128 in 3xTF32 on ``wgmma``,
  one S per 64-row block and key tile summed over a thread block cluster
  that splits the head dim.

On the CPU: the plain version, ``ref.flash_attention_ref``.

:func:`flash_attention` goes through :class:`FlashAttention`, so the
output stays in the autograd graph on both devices.  Its backward is
:mod:`repro_torch.kernels.flash_attention_bwd` (kernels on CUDA, the
plain ``ref.flash_attention_bwd_ref`` on the CPU).  Under
``torch.inference_mode()`` the forward's launch and its bits are the
same.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

#: kernel launches of :func:`flash_attention` in this process
launches = 0

#: element types the kernel takes, and their code in the C launcher
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the C launcher's route codes (``flash_attention_route``)
ROUTES = {0: "fp32_mma_sync", 1: "wide_cluster", 2: "bf16_cp_async",
          3: "bf16_tma"}


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' forward and backward: saves q, k, v
    and the output, and hands the output's gradient to
    :func:`flash_attention_bwd`.  Under remat the forward (and so the
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
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                             ctx.causal, ctx.scale,
                                             ctx.window)
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
    lib = build.lib("flash_attention")
    # the bf16_tma route's unit counter (the launcher clears it); the other
    # routes take none
    counter = None
    if ROUTES[lib.flash_attention_route(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d,
            DTYPES[q.dtype])] == "bf16_tma":
        counter = torch.empty(1, dtype=torch.int32, device=q.device)
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if counter is None else counter.data_ptr(), n, hq, hkv, sq, skv, d,
        scale, int(causal), window or 0, DTYPES[q.dtype],
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


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route :func:`flash_attention` takes for these operands (a name
    of :data:`ROUTES`; ``"plain"`` on the CPU), as the C launcher decides
    it; the output is the wrapper's own allocation, 16-byte aligned."""
    if q.device.type == "cpu":
        return "plain"
    code = build.lib("flash_attention").flash_attention_route(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, q.shape[-1],
        DTYPES[q.dtype])
    return ROUTES[code]


def bf16_probe(q: torch.Tensor, k: torch.Tensor, p: torch.Tensor,
               v: torch.Tensor):
    """One ``q k^T`` and one ``P V`` of the ``bf16_tma`` kernel on the
    card, through its TMA boxes, 128-byte swizzle and operand layouts:
    ``q [64, d] @ k [128, d]^T`` with both K-major, and ``p [64, 128] @ v
    [128, d]`` with P from registers in the accumulator layout of S and V
    MN-major; bf16 inputs, d % 8 == 0 and d <= 128.  Returns (s [64, 128],
    o [64, d]) fp32: a check of the layouts against products on the CPU,
    not a wrapper of the main path, so it counts no launch."""
    build.require("flash_bf16_probe", dtypes=(torch.bfloat16,), q=q, k=k,
                  p=p, v=v)
    d = q.shape[-1]
    shapes = tuple(tuple(t.shape) for t in (q, k, p, v))
    if shapes != ((64, d), (128, d), (64, 128), (128, d)) or d % 8 \
            or d > 128:
        raise ValueError(f"flash_bf16_probe: q [64, d], k [128, d], p [64, "
                         f"128], v [128, d] with d % 8 == 0 and d <= 128, "
                         f"got {shapes}")
    s = torch.empty((64, 128), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    build.check(build.lib("flash_attention").flash_bf16_probe_launch(
        q.data_ptr(), k.data_ptr(), p.data_ptr(), v.data_ptr(), s.data_ptr(),
        o.data_ptr(), d, build.stream_of(q)), "flash_bf16_probe")
    return s, o

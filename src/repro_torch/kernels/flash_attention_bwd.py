"""The backward of ``flash_attention``: ``csrc/flash_attention_bwd.cu``.

It replaces no TPU kernel (the JAX package differentiates its XLA
reference).  FlashAttention-2's backward in three phases, in a fixed
order with no atomic sum: the rows' log-sum-exp and rowsum(dO * O); dK
and dV a block per 128 keys over the kv head's whole q-head group; dQ.
bf16 runs on ``wgmma``, fp32 in 3xTF32 on ``mma.sync``.  It takes
d <= 128 with d % 8 == 0 (bf16) or d % 4 == 0 (fp32) and 16-byte-aligned
operands, and raises outside them.  On the CPU: the plain version,
``ref.flash_attention_bwd_ref``.  ``flash_attention.FlashAttention``'s
backward calls :func:`flash_attention_bwd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: kernel launches of :func:`flash_attention_bwd` in this process
launches = 0

#: element types the kernel takes, and their code in the C launcher
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys a block of the dK/dV phase covers, by element type
BLOCK_KEYS = {torch.bfloat16: 128, torch.float32: 64}
#: query rows the statistics scratch keeps a q head: Sq rounded up to
#: this (``SQ_ALIGN`` in ``csrc/flash_attention_bwd.cu``)
SQ_ALIGN = 128


def parts(n: int, hkv: int, skv: int, dtype: torch.dtype, sms: int) -> int:
    """Blocks that share each key block's query tiles in the dK/dV phase:
    as many (up to 4) as keep twice ``sms`` blocks in the grid, so a
    causal grid's longest blocks are cut where the grid alone would leave
    SMs idle; their fp32 partials are summed in order."""
    blocks = n * hkv * -(-skv // BLOCK_KEYS[dtype])
    return max(1, min(4, 2 * sms // blocks))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, causal: bool,
                        scale: float, window: Optional[int]):
    """(dq, dk, dv), each in its input's dtype, given the forward's output
    ``o`` and its gradient ``do``: the kernels on CUDA tensors, the plain
    ``ref.flash_attention_bwd_ref`` on CPU ones."""
    global launches
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                           scale=scale, window=window)
    build.require("flash_attention_bwd", dtypes=tuple(DTYPES), q=q, k=k,
                  v=v, o=o, do=do)
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError("flash_attention_bwd: q, k, v, o and do must share "
                        "a dtype")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}")
    step = 8 if q.dtype == torch.bfloat16 else 4
    if d > 128 or d % step:
        raise ValueError(f"flash_attention_bwd: head dim {d} must be at most "
                         f"128 and a multiple of {step} in {q.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: q, k, v, o and do must be "
                         "16-byte aligned")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_parts = parts(n, hkv, skv, q.dtype, sms)
    sqp = -(-sq // SQ_ALIGN) * SQ_ALIGN
    scratch = torch.empty(2 * n * hq * sqp + 2 * n_parts * n * hkv * skv * d,
                          dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    build.check(build.lib("flash_attention_bwd").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), n, hq, hkv, sq, skv, d, scale, int(causal),
        window or 0, n_parts, DTYPES[q.dtype], build.stream_of(q)),
        "flash_attention_bwd")
    launches += 1
    return dq, dk, dv


def probe(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor,
          c: torch.Tensor):
    """One of each product form of the bf16 backward on the card, through
    its layouts and helpers: ``a [64, d] @ b [64, d]^T`` with both K-major
    in shared memory (the form of S = Q K^T, S^T = K Q^T, dP = dO V^T and
    dP^T = V dO^T), and ``p [64, 64] @ c [64, d]`` with p from registers
    in the accumulator layout of S and c MN-major (the form of dV += P^T
    dO, dK += dS^T Q and dQ += dS K); bf16 inputs, d % 8 == 0 and d <=
    128.  Returns (s [64, 64], o [64, d]) fp32: a check of the layouts
    against products on the CPU, not a wrapper of the main path, so it
    counts no launch."""
    build.require("flash_bwd_probe", dtypes=(torch.bfloat16,), a=a, b=b,
                  p=p, c=c)
    d = a.shape[-1]
    shapes = tuple(tuple(t.shape) for t in (a, b, p, c))
    if shapes != ((64, d), (64, d), (64, 64), (64, d)) or d % 8 or d > 128:
        raise ValueError(f"flash_bwd_probe: a, b, c [64, d], p [64, 64] "
                         f"with d % 8 == 0 and d <= 128, got {shapes}")
    s = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    o = torch.empty((64, d), dtype=torch.float32, device=a.device)
    build.check(build.lib("flash_attention_bwd").flash_bwd_probe_launch(
        a.data_ptr(), b.data_ptr(), p.data_ptr(), c.data_ptr(), s.data_ptr(),
        o.data_ptr(), d, build.stream_of(a)), "flash_bwd_probe")
    return s, o

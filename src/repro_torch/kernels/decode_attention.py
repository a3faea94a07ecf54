"""Single-token decode attention against a KV cache, grouped-query heads
(counterpart of the JAX package's ``kernels/decode_attention.py``): the
LM serving step's attention.

On CUDA: ``csrc/decode_attention.cu``, one kernel launch per call
(replacing the Pallas kernel ``_dec_kernel`` of the JAX package's
``kernels/decode_attention.py``).  The call is bound by the bytes of the
cache rows below each sequence's length.  Each (sequence, kv head) is a
cluster of CTAs that split its rows; each warp streams its rows through
its own ``cp.async`` ring in shared memory and keeps an fp32 online
softmax; bf16 ``q k^T`` runs on ``mma.sync``, and so does ``p v`` at head
dim 128 with grouped heads (``p`` split exactly into three bf16 parts;
other shapes on the CUDA cores); the cluster merges its warps' parts in
a fixed order through distributed shared memory.  No scratch in global
memory, no atomics: a sequence's bits depend only on its own length and
data.  fp32 or bf16 inputs, output in ``q.dtype``.  On the CPU: the plain
version, ``ref.decode_attention_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES

#: kernel launches of :func:`decode_attention` in this process
launches = 0

#: largest head dim the kernel takes
MAX_HEAD_DIM = 256


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [n, hq, d]; k_cache/v_cache [n, hkv, S, d] with ``hq % hkv ==
    0``; lengths [n] valid prefix lengths -> [n, hq, d]."""
    global launches
    n, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (n, hkv, s, d) or \
            tuple(v_cache.shape) != tuple(k_cache.shape) or hq % hkv or \
            tuple(lengths.shape) != (n,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)} disagree")
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale)
    build.require("decode_attention", dtypes=tuple(DTYPES), q=q, k=k_cache,
                  v=v_cache)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: q and the caches must share a "
                        f"dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    # cache rows are staged 16 bytes at a time: each row must be whole
    # 16-byte units (d % 4 in fp32, d % 8 in bf16) and start aligned
    if d * q.element_size() % 16 or d > MAX_HEAD_DIM or \
            any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"decode_attention: head dim {d} must fill whole "
                         f"16-byte units in {q.dtype} and be at most "
                         f"{MAX_HEAD_DIM}, q and the caches 16-byte aligned")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    build.check(build.lib("decode_attention").decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), n, hq, hkv, s, d, scale,
        DTYPES[q.dtype], build.stream_of(q)), "decode_attention")
    launches += 1
    return out

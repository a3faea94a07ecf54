"""Single-token decode attention against a KV cache, grouped-query heads
(counterpart of the JAX package's ``kernels/decode_attention.py``): the
LM serving step's attention.

On CUDA: ``csrc/decode_attention.cu`` (a chunked pass over the cache
rows below each sequence's length, then a merge of the chunks; one
launch count per call), fp32 or bf16 inputs, fp32 softmax and
accumulation, output in ``q.dtype``.  On the CPU: the plain version,
``ref.decode_attention_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES

#: kernel launches of :func:`decode_attention` in this process
launches = 0

#: cache rows one block of the kernel reads (``CHUNK`` in the source)
CHUNK = 64
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
    align = 4 * q.element_size()            # one 4-element load
    if d % 4 or d > MAX_HEAD_DIM or \
            any(t.data_ptr() % align for t in (q, k_cache, v_cache)):
        raise ValueError(f"decode_attention: head dim {d} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}, q and the caches "
                         f"{align}-byte aligned")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    splits = -(-s // CHUNK)
    part_ml = torch.empty((n, hq, splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((n, hq, splits, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    build.check(build.lib("decode_attention").decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), n, hq, hkv, s, d, splits, scale,
        DTYPES[q.dtype], build.stream_of(q)), "decode_attention")
    launches += 1
    return out

"""Single-token decode attention against a KV cache, grouped-query heads
(counterpart of the JAX package's ``kernels/decode_attention.py``): the
LM serving step's attention.

On CUDA: ``csrc/decode_attention.cu``, one kernel launch per call
(replacing the Pallas kernel ``_dec_kernel`` of the JAX package's
``kernels/decode_attention.py``).  The call is bound by the bytes of the
cache rows below each sequence's length.  Each (sequence, kv head) is a
cluster of CTAs that split its rows; in each CTA a producer thread loads
the rows by TMA (tensor maps encoded per call) into a ring of stages,
sized so that two CTAs share an SM, and consumer warps keep fp32 online
softmaxes (base 2) over their rows of each stage; bf16 ``q k^T`` runs on
``mma.sync``, and so does ``p v`` for grouped heads at every head dim
that is a multiple of 16 up to 128 (``p`` split exactly into three bf16
parts; other shapes on the CUDA cores); the warps merge inside the CTA,
then each CTA sends its part by ``st.async`` to the CTAs that own the
output slices, which merge them in a fixed order.  No scratch in global
memory, no atomics: a sequence's bits depend only on its own length and
data.  fp32 or bf16 inputs, output in ``q.dtype``.  A sequence of length
0 gives 0 (ROADMAP C 2).  On the CPU: the plain version,
``ref.decode_attention_ref``.  :func:`config` reports the launch
configuration a call gets.

:func:`decode_attention_partial` is the same launch with the merged row
written in fp32 and its log-sum-exp beside it (plain version
``ref.decode_attention_partial_ref``): the part of a sequence whose
slots are split over ranks, which :func:`merge_partials` (plain tensor
code, not a kernel) joins into the whole.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES

#: kernel launches of :func:`decode_attention` in this process
launches = 0

#: largest head dim the kernel takes
MAX_HEAD_DIM = 256

#: the fields of :func:`config`, in the C launcher's order
CONFIG_FIELDS = ("grid_x", "grid_y", "grid_z", "cluster", "threads",
                 "smem_bytes", "ctas_per_sm", "max_active_clusters",
                 "tensor_core_pv", "stages", "stage_rows")


def _check(q, k_cache, v_cache, lengths, scale, what):
    """The shared checks of both forms; returns the scale."""
    n, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (n, hkv, s, d) or \
            tuple(v_cache.shape) != tuple(k_cache.shape) or hq % hkv or \
            tuple(lengths.shape) != (n,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)} disagree")
    return float(d ** -0.5) if scale is None else float(scale)


def _launch_args(q, k_cache, v_cache, lengths, what):
    """The CUDA checks of both forms; returns the int32 lengths."""
    d = q.shape[2]
    build.require("decode_attention", dtypes=tuple(DTYPES), q=q, k=k_cache,
                  v=v_cache)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{what}: q and the caches must share a "
                        f"dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    # cache rows are staged 16 bytes at a time: each row must be whole
    # 16-byte units (d % 4 in fp32, d % 8 in bf16) and start aligned
    if d * q.element_size() % 16 or d > MAX_HEAD_DIM or \
            any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{what}: head dim {d} must fill whole "
                         f"16-byte units in {q.dtype} and be at most "
                         f"{MAX_HEAD_DIM}, q and the caches 16-byte aligned")
    return lengths.to(device=q.device, dtype=torch.int32).contiguous()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [n, hq, d]; k_cache/v_cache [n, hkv, S, d] with ``hq % hkv ==
    0``; lengths [n] valid prefix lengths -> [n, hq, d]."""
    global launches
    scale = _check(q, k_cache, v_cache, lengths, scale, "decode_attention")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale)
    lengths = _launch_args(q, k_cache, v_cache, lengths, "decode_attention")
    n, hq, d = q.shape
    out = torch.empty_like(q)
    build.check(build.lib("decode_attention").decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), n, hq, k_cache.shape[1],
        k_cache.shape[2], d, scale, DTYPES[q.dtype], build.stream_of(q)),
        "decode_attention")
    launches += 1
    return out


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, lengths: torch.Tensor,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`decode_attention`, but returns (o [n, hq, d] fp32,
    normalised over the row's own keys and never rounded to ``q.dtype``,
    lse [n, hq] fp32, the natural log-sum-exp of its scaled scores); a
    row of length 0 gives o = 0 and lse = -inf.  Its launches count as
    :func:`decode_attention`'s."""
    global launches
    scale = _check(q, k_cache, v_cache, lengths, scale,
                   "decode_attention_partial")
    if q.device.type == "cpu":
        return ref.decode_attention_partial_ref(q, k_cache, v_cache, lengths,
                                                scale)
    lengths = _launch_args(q, k_cache, v_cache, lengths,
                           "decode_attention_partial")
    n, hq, d = q.shape
    out = torch.empty((n, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((n, hq), dtype=torch.float32, device=q.device)
    build.check(build.lib("decode_attention").decode_attention_partial_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), n, hq,
        k_cache.shape[1], k_cache.shape[2], d, scale, DTYPES[q.dtype],
        build.stream_of(q)), "decode_attention_partial")
    launches += 1
    return out, lse


def config(q: torch.Tensor, k_cache: torch.Tensor) -> Dict[str, int]:
    """The launch configuration that :func:`decode_attention` gives these
    operands, launching nothing: its grid (x the cluster's CTAs, y the kv
    heads times the passes of 8 q heads, z the sequences), the cluster,
    threads and shared bytes of a CTA, the CTAs an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``), whether ``p
    v`` runs on the tensor cores (1) or the CUDA cores (0), the ring's
    stages and the rows of a stage.  Needs the card."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention.config: the launch configuration "
                         "is the card's; q is on the CPU")
    n, hq, d = q.shape
    info = (ctypes.c_int * len(CONFIG_FIELDS))()
    build.check(build.lib("decode_attention").decode_attention_config(
        n, hq, k_cache.shape[1], k_cache.shape[2], d, DTYPES[q.dtype], info),
        "decode_attention_config")
    return dict(zip(CONFIG_FIELDS, info))


def merge_partials(o: torch.Tensor, lse: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The rows of R parts over disjoint key ranges joined into the
    attention over all of them: o [R, n, hq, d] and lse [R, n, hq] from
    :func:`decode_attention_partial` -> [n, hq, d] in ``dtype``, rounded
    once.  Each part weighs exp(lse - max lse), a part with no keys 0;
    the parts add in order r = 0, 1, ..., so every caller with the same
    parts gets the same bits.  A row with no key in any part gives 0.
    Plain tensor code: R n hq (d + 1) values."""
    m = lse.max(dim=0).values
    w = torch.exp(lse - torch.where(torch.isinf(m), 0.0, m))
    num, den = o[0] * w[0, ..., None], w[0]
    for r in range(1, o.shape[0]):
        num = num + o[r] * w[r, ..., None]
        den = den + w[r]
    return (num / torch.where(den > 0, den, 1.0)[..., None]).to(dtype)

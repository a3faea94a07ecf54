"""Transformer blocks in PyTorch (counterpart of the JAX package's
``models/blocks.py``): GQA attention (qk-norm / bias / sliding-window /
M-RoPE variants, causal or not, self- or cross-attention) for prefill
and for the one-token decode step, the dense MLP, and the
capacity-based top-k MoE.

Attention goes through :mod:`repro_torch.kernels.ops`
(``flash_attention`` for a full sequence, ``decode_attention`` against
the KV cache), whose device dispatch picks the Hopper kernel for a CUDA
tensor and the plain version for a CPU one.  The projections, the MLP
and the experts are plain products, as the JAX package leaves them to
XLA.  Dense weights keep the JAX package's ``[in, out]`` layout (``x @
w``); sharding specs have no counterpart on one card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models.common import ModelConfig


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = cfg.dtype, gen.device
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    p = {
        "wq": C.dense(gen, d, qd, dt),
        "wk": C.dense(gen, d, kvd, dt),
        "wv": C.dense(gen, d, kvd, dt),
        "wo": C.dense(gen, qd, d, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((kvd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((kvd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B, S, Hq, dh], k/v [B, S, Hkv, dh], roped."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = C.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = C.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.mrope_sections is not None:
        # the text path's t, h and w streams are all the token position
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = C.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = C.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill, encoder).  With ``kv`` = (k, v)
    ``[B, Skv, Hkv, dh]`` (cross-attention) x makes only the queries, and
    there is no window.  Returns the block's output [B, S, D] and k and v
    as ``[B, Hkv, Skv, dh]`` (roped for self-attention), which a prefill
    keeps for its cache."""
    b, s, _ = x.shape
    if kv is None:
        q, k, v = _qkv(params, x, cfg, positions)
    else:
        q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
        if cfg.qkv_bias:
            q = q + params["bq"].to(q.dtype).reshape(cfg.n_heads,
                                                     cfg.head_dim)
        k, v = kv
    # the kernels take contiguous [n, h, s, d]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    o = ops.flash_attention(q.transpose(1, 2).contiguous(), kt, vt,
                            causal=causal,
                            window=cfg.sliding_window if kv is None else None)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return o @ params["wo"], kt, vt


def attention_decode(params, x1: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One-token decode.  x1 [B, 1, D]; caches [B, Hkv, S, dh]; pos [B].

    Writes this token's k and v into the caches **in place** (the JAX
    package returns updated copies; a copy of the whole cache per layer
    and step is what the port saves) and returns out [B, 1, D].  Sliding
    windows use ring-buffer slots (RoPE is applied before the cache, so
    slot order is free)."""
    b = x1.shape[0]
    s_max = k_cache.shape[2]
    q, k, v = _qkv(params, x1, cfg, pos[:, None])
    slot = pos % s_max if cfg.sliding_window else torch.clamp(pos,
                                                              max=s_max - 1)
    bidx = torch.arange(b, device=pos.device)
    k_cache[bidx, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, :, slot] = v[:, 0].to(v_cache.dtype)
    lengths = torch.clamp(pos + 1, max=s_max)
    o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths)
    return o.reshape(b, 1, cfg.q_dim) @ params["wo"]


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = cfg.dtype, gen.device
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": C.dense(gen, d, f, dt),
                "w_up": C.dense(gen, d, f, dt),
                "w_down": C.dense(gen, f, d, dt)}
    return {"w_up": C.dense(gen, d, f, dt),
            "b_up": torch.zeros((f,), dtype=dt, device=dev),
            "w_down": C.dense(gen, f, d, dt),
            "b_down": torch.zeros((d,), dtype=dt, device=dev)}


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w_up"] + params["b_up"].to(x.dtype),
               approximate="tanh")
    return h @ params["w_down"] + params["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# mixture of experts (top-k, capacity-based, sort-free dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """The fp32 router ``[d, E]`` and the experts' SwiGLU weights
    ``w_gate``/``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]`` at
    ``cfg.dtype``, each expert N(0, 1/cin) as a dense weight."""
    dt = cfg.dtype
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": C.dense(gen, d, e, torch.float32),
            "w_gate": C.normal(gen, (e, d, f), dt, 1.0 / math.sqrt(d)),
            "w_up": C.normal(gen, (e, d, f), dt, 1.0 / math.sqrt(d)),
            "w_down": C.normal(gen, (e, f, d), dt, 1.0 / math.sqrt(f))}


def moe_capacity(t: int, cfg: ModelConfig,
                 capacity_factor: Optional[float] = None) -> int:
    """Slots per expert for a step of ``t`` tokens: Switch-style
    ``round(t k / E * cf)`` (Python's round, halves to even), at least 1."""
    cf = capacity_factor or cfg.capacity_factor
    return int(max(1, round(t * cfg.experts_per_token / cfg.n_experts * cf)))


def moe(params, x: torch.Tensor, cfg: ModelConfig,
        capacity_factor: Optional[float] = None) -> torch.Tensor:
    """Capacity-based top-k MoE with Switch-style dropping, the JAX
    package's arithmetic step by step.

    Each (token, choice) is ranked into its expert's slots by an integer
    cumsum over the one-hot assignment, token-major then choice (no
    sort); an entry ranked at or past the capacity is dropped: it adds 0
    to slot ``(0, cap - 1)`` and its gate is 0.  Every shape follows from
    the step's token count, so a step is one stream of launches with no
    host sync."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.float() @ params["router"]                      # [T, E]
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), k)   # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    cap = moe_capacity(t, cfg, capacity_factor)
    # the one-hot [E, T k], so that the running count is a scan along the
    # contiguous axis (the device's scan across the outer axis is slow)
    experts = torch.arange(e, device=x.device)
    onehot = (experts[:, None] == idx.reshape(1, t * k)).to(torch.int32)
    rank = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0)
    rank = (rank - 1).reshape(t, k)
    keep = rank < cap

    # dispatch into [E, cap, d]: kept entries fill distinct slots, dropped
    # ones add 0, so each slot's sum is exact in any order
    slot = (torch.where(keep, idx, 0) * cap
            + torch.where(keep, rank, cap - 1)).reshape(-1)
    src = (xt[:, None] * keep.to(x.dtype)[..., None]).reshape(t * k, d)
    slots = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    slots.index_add_(0, slot, src)
    slots = slots.reshape(e, cap, d)

    # the experts, batched over E
    hg = torch.bmm(slots, params["w_gate"])
    hu = torch.bmm(slots, params["w_up"])
    ho = torch.bmm(F.silu(hg) * hu, params["w_down"])

    # combine: gather back and weight by the gate
    out_k = ho.reshape(e * cap, d)[slot].reshape(t, k, d)
    out = (out_k * (gates * keep).to(out_k.dtype)[..., None]).sum(dim=1)
    return out.reshape(b, s, d)

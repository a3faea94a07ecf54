"""Transformer blocks in PyTorch (counterpart of the JAX package's
``models/blocks.py``): GQA attention (qk-norm / bias / sliding-window
variants) for prefill and for the one-token decode step, and the dense
MLP.

Attention goes through :mod:`repro_torch.kernels.ops`
(``flash_attention`` for a full sequence, ``decode_attention`` against
the KV cache), whose device dispatch picks the Hopper kernel for a CUDA
tensor and the plain version for a CPU one.  The projections and the MLP
are plain products, as the JAX package leaves them to XLA.  Dense
weights keep the JAX package's ``[in, out]`` layout (``x @ w``).
M-RoPE (the VLM), cross-attention (enc-dec) and MoE wait for their
slices of the port; sharding specs have no counterpart on one card.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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
        raise NotImplementedError(
            "M-RoPE waits for the VLM slice of the port (ROADMAP A 15)")
    if cfg.rope_theta > 0:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal self-attention (prefill).  Returns the
    block's output [B, S, D] and the roped k and v as ``[B, Hkv, S, dh]``,
    which the prefill keeps for the KV cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    # the kernels take contiguous [n, h, s, d]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    o = ops.flash_attention(q.transpose(1, 2).contiguous(), kt, vt,
                            causal=True, window=cfg.sliding_window)
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

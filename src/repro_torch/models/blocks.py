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
w``).

Every ``*_init`` has a matching ``*_pspecs``, the reference's layout for
tensor parallelism on the ``model`` mesh axis (Megatron: column-parallel
in-projections, row-parallel out-projections; experts expert-parallel
when E divides the axis, otherwise ffn-sharded).  Under a constraint
mesh (:mod:`repro_torch.dist.sharding`) :func:`constrain_attention_layout`
pins q, k and v to a layout in which each rank's attention is its own
slice, and the kernel runs on the local shards.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P
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


def attn_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    p = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qkv_bias:
        p.update(bq=P("model"), bk=P("model"), bv=P("model"))
    if cfg.qk_norm:
        p.update(q_norm=P(None), k_norm=P(None))
    return p


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         token: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B, S, Hq, dh], k/v [B, S, Hkv, dh], roped.  With
    ``token`` (a decode step's one token) DTensor projections are laid
    out by :func:`token_layout` before they split into heads."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if token and D.is_dtensor(q):
        q, k, v = token_layout(q), token_layout(k), token_layout(v)
    else:
        q, k, v = (q_projection_layout(q, cfg), kv_projection_layout(k, cfg),
                   kv_projection_layout(v, cfg))
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


def _seq_parallel(x, cfg: ModelConfig) -> bool:
    """Whether ``x`` is a DTensor under a constraint mesh whose model
    axis does not divide the heads: the sequence-parallel layout."""
    mesh = D.get_constraint_mesh()
    if mesh is None or not D.is_dtensor(x):
        return False
    tp = D.axis_size(mesh, "model")
    return bool(cfg.n_heads % tp or cfg.n_kv_heads % tp)


def q_projection_layout(q, cfg: ModelConfig):
    """A q projection ``[B, S, H*dh]`` before it splits into heads: in
    the sequence-parallel layout its sequence carries the model axis
    (heads that the axis does not divide cannot), unless the axis does
    not divide the prompt's length either: then it stays whole."""
    return D.constrain(q, "data", "model", None, loose=(1,)) \
        if _seq_parallel(q, cfg) else q


def token_layout(t):
    """A DTensor whose dim 0 is the batch (one token's projections, a
    decode step's output) with its rows over the data axes that divide
    them and replicated over "model": an all-gather of one token's
    heads."""
    return D.lay_out(t, P(D.dp_axes(t.device_mesh)))


def kv_projection_layout(t, cfg: ModelConfig):
    """A k or v projection before it splits into heads: replicated over
    the model axis in the sequence-parallel layout."""
    return D.constrain(t, "data", None, None) \
        if _seq_parallel(t, cfg) else t


def constrain_attention_layout(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, cfg: ModelConfig):
    """Pin the [n, h, s, d] attention layout (the reference's, both
    branches).

    heads % TP == 0  -> Megatron head sharding P(dp, model, None, None);
    otherwise        -> sequence-parallel scores: q's seq dim carries the
                        model axis (k/v replicated over model), so the
                        scores shard on Sq (a prompt length the axis
                        does not divide stays whole)."""
    mesh = D.get_constraint_mesh()
    if mesh is None:
        return q, k, v
    tp = D.axis_size(mesh, "model")
    if q.shape[1] % tp == 0 and k.shape[1] % tp == 0:
        q = D.constrain(q, "data", "model", None, None)
        k = D.constrain(k, "data", "model", None, None)
        v = D.constrain(v, "data", "model", None, None)
    else:
        q = D.constrain(q, "data", None, "model", None, loose=(2,))
        k = D.constrain(k, "data", None, None, None)
        v = D.constrain(v, "data", None, None, None)
    return q, k, v


def _flash_attention(q, k, v, causal: bool, window: Optional[int]):
    """``ops.flash_attention`` on plain tensors, or on each rank's shards
    of DTensors laid out by :func:`constrain_attention_layout`: heads
    and batch rows are independent, and a shard of q's sequence reads
    the keys up to its own last row (the kernel aligns q at the end of
    the keys it is given), so each rank computes its slice exactly."""
    if not D.is_dtensor(q):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    ql = D.local_shard(q, q)
    kl, vl = D.local_shard(k, q), D.local_shard(v, q)
    sq_l, skv = ql.shape[2], k.shape[2]
    if sq_l != q.shape[2]:                # q's sequence is split
        if not causal and window is not None:
            raise ValueError("a windowed non-causal attention cannot split "
                             "q's sequence")
        if causal:
            end = D.mesh_coordinate(q, 2) * sq_l + sq_l + skv - q.shape[2]
            kl, vl = kl[:, :, :end], vl[:, :, :end]
    o = ops.flash_attention(ql, kl, vl, causal=causal, window=window)
    return D.from_local_like(o, q)


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
        # the bias goes on before the head split, as in _qkv: a sharded
        # bias may not split into heads the model axis does not divide
        q = x @ params["wq"]
        if cfg.qkv_bias:
            q = q + params["bq"].to(q.dtype)
        q = q_projection_layout(q, cfg).reshape(b, s, cfg.n_heads,
                                                cfg.head_dim)
        k, v = kv
    # the kernels take contiguous [n, h, s, d]
    qt, kt, vt = constrain_attention_layout(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), cfg)
    o = _flash_attention(qt, kt, vt, causal,
                         cfg.sliding_window if kv is None else None)
    o = q_projection_layout(o.transpose(1, 2).reshape(b, s, cfg.q_dim), cfg)
    return o @ params["wo"], kt, vt


def attention_decode(params, x1: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One-token decode.  x1 [B, 1, D]; caches [B, Hkv, S, dh]; pos [B].

    Writes this token's k and v into the caches **in place** (the JAX
    package returns updated copies; a copy of the whole cache per layer
    and step is what the port saves) and returns out [B, 1, D].  Sliding
    windows use ring-buffer slots (RoPE is applied before the cache, so
    slot order is free).  DTensor caches go through
    :func:`decode_attention_sharded`."""
    b = x1.shape[0]
    s_max = k_cache.shape[2]
    q, k, v = _qkv(params, x1, cfg, pos[:, None], token=True)
    slot = pos % s_max if cfg.sliding_window else torch.clamp(pos,
                                                              max=s_max - 1)
    lengths = torch.clamp(pos + 1, max=s_max)
    if D.is_dtensor(k_cache):
        o = decode_attention_sharded(q[:, 0], k_cache, v_cache, lengths,
                                     (k[:, 0], v[:, 0], slot))
    else:
        bidx = torch.arange(b, device=pos.device)
        k_cache[bidx, :, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, :, slot] = v[:, 0].to(v_cache.dtype)
        o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                 lengths)
    return o.reshape(b, 1, cfg.q_dim) @ params["wo"]


def _slot_dim(cache) -> Optional[int]:
    """The mesh dim of more than one rank that splits a DTensor cache
    ``[B, Hkv, S, dh]``'s slots, or None where each rank holds them all."""
    for i, p in enumerate(cache.placements):
        if p.is_shard(2) and cache.device_mesh.size(i) > 1:
            return i
    return None


def decode_attention_sharded(q, k_cache, v_cache, lengths, new=None):
    """One token's attention against DTensor caches ``[B, Hkv, S, dh]``
    laid out by ``cache_pspecs`` (rows over the data axes, slots over
    "model" where they divide): DTensors q [B, Hq, dh], lengths [B]; ``new`` = (k,
    v [B, Hkv, dh], slot [B]) is first written in place, by the rank
    that owns the slot, at its local slot.  Returns [B, Hq, dh] over the
    data axes, replicated over "model".

    Slots not split: ``ops.decode_attention`` on each rank's shard.
    Split over R ranks, rank r holding slots [r S_l, (r + 1) S_l): the
    partial form on its slots at lengths clamp(len - r S_l, 0, S_l); (o,
    lse) all-gathered over that mesh dim (one buffer) and merged in rank
    order by ``ops.merge_partials``, rounded once to the cache's dtype,
    so every rank has the same bits."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    mesh = k_cache.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in k_cache.placements]

    def local(t):
        return t.redistribute(mesh, rows).to_local()
    ql, lengths = local(q).contiguous(), local(lengths)
    kc, vc = k_cache.to_local(), v_cache.to_local()     # views: written
    md = _slot_dim(k_cache)
    r, s_l = (0 if md is None else mesh.get_coordinate()[md]), kc.shape[2]
    if new is not None:
        kn, vn, slot = (local(t) for t in new)
        bidx = torch.arange(kc.shape[0], device=kc.device)
        ls = slot - r * s_l
        mine = ((ls >= 0) & (ls < s_l))[:, None, None]
        ls = torch.clamp(ls, 0, s_l - 1)
        for c, t in ((kc, kn), (vc, vn)):
            c[bidx, :, ls] = torch.where(mine, t.to(c.dtype), c[bidx, :, ls])
    if md is None:
        o = ops.decode_attention(ql, kc, vc, lengths)
    else:
        n, hq, dh = ql.shape
        o, lse = ops.decode_attention_partial(
            ql, kc, vc, torch.clamp(lengths - r * s_l, 0, s_l))
        parts = funcol.all_gather_tensor(
            torch.cat([o.reshape(n, hq * dh), lse], dim=1), 0,
            (mesh, md)).reshape(-1, n, hq * (dh + 1))
        o = ops.merge_partials(parts[..., :hq * dh].reshape(-1, n, hq, dh),
                               parts[..., hq * dh:], kc.dtype)
    return D.from_local(o, mesh, rows, (q.shape[0],) + tuple(o.shape[1:]))


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


def mlp_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.act == "swiglu":
        return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                "w_down": P("model", None)}
    return {"w_up": P(None, "model"), "b_up": P("model"),
            "w_down": P("model", None), "b_down": P(None)}


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


def moe_pspecs(cfg: ModelConfig, model_axis_size: int) -> Dict[str, Any]:
    if cfg.n_experts % model_axis_size == 0:
        ex = P("model", None, None)        # expert parallel
    else:
        ex = P(None, None, "model")        # ffn-sharded within each expert
        return {"router": P(None, None), "w_gate": ex, "w_up": ex,
                "w_down": P(None, "model", None)}
    return {"router": P(None, None), "w_gate": ex, "w_up": ex, "w_down": ex}


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
    host sync.  A DTensor ``x`` goes through :func:`_moe_sharded`."""
    if D.is_dtensor(x):
        return _moe_sharded(params, x, cfg, capacity_factor)
    b, s, d = x.shape
    return _moe_tokens(params, x.reshape(b * s, d), cfg,
                       moe_capacity(b * s, cfg, capacity_factor), 0
                       ).reshape(b, s, d)


def _moe_tokens(params, xt: torch.Tensor, cfg: ModelConfig, cap: int,
                e0: int) -> torch.Tensor:
    """The MoE over tokens ``xt [T, d]`` with ``params`` holding experts
    ``e0 ..`` (as many as ``w_gate`` has): entries routed to other
    experts add 0, so the result is these experts' share of the sum."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    el = params["w_gate"].shape[0]

    logits = xt.float() @ params["router"]                      # [T, E]
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), k)   # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # the one-hot [E, T k], so that the running count is a scan along the
    # contiguous axis (the device's scan across the outer axis is slow)
    experts = torch.arange(e, device=xt.device)
    onehot = (experts[:, None] == idx.reshape(1, t * k)).to(torch.int32)
    rank = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0)
    rank = (rank - 1).reshape(t, k)
    keep = (rank < cap) & (idx >= e0) & (idx < e0 + el)

    # dispatch into [E local, cap, d]: kept entries fill distinct slots,
    # dropped ones add 0, so each slot's sum is exact in any order
    slot = (torch.where(keep, idx - e0, 0) * cap
            + torch.where(keep, rank, cap - 1)).reshape(-1)
    src = (xt[:, None] * keep.to(xt.dtype)[..., None]).reshape(t * k, d)
    slots = torch.zeros((el * cap, d), dtype=xt.dtype, device=xt.device)
    slots.index_add_(0, slot, src)
    slots = slots.reshape(el, cap, d)

    # the experts, batched over E
    hg = torch.bmm(slots, params["w_gate"])
    hu = torch.bmm(slots, params["w_up"])
    ho = torch.bmm(F.silu(hg) * hu, params["w_down"])

    # combine: gather back and weight by the gate
    out_k = ho.reshape(el * cap, d)[slot].reshape(t, k, d)
    return (out_k * (gates * keep).to(out_k.dtype)[..., None]).sum(dim=1)


def _moe_sharded(params, x, cfg: ModelConfig,
                 capacity_factor: Optional[float]):
    """The MoE of a DTensor ``x`` with its experts laid out by
    :func:`moe_pspecs`.  Routing and capacity are the whole batch's, as
    in the reference: every rank gathers the tokens (activations, not
    weights), routes them all, and runs its own experts (expert
    parallel) or its slice of every expert's ffn (ffn-sharded).  Its
    output is a partial sum over the mesh dims that split the experts,
    reduced into ``x``'s layout.  Weights stored split over other mesh
    dims too (FSDP's storage over "data") are gathered on those first."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    b, s, d = x.shape
    names = D.axis_names(mesh)

    def on_model(w):
        pl = [p if names[i] == "model" else Replicate()
              for i, p in enumerate(w.placements)]
        return w if pl == list(w.placements) else w.redistribute(mesh, pl)

    params = {name: on_model(w) for name, w in params.items()}
    lead = params["w_gate"]
    part = [Partial() if p.is_shard() else Replicate()
            for p in lead.placements]
    xt = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=part).reshape(b * s, d)
    local = {name: D.local_shard(w, lead) for name, w in params.items()}
    e0 = 0
    for i, p in enumerate(lead.placements):
        if p.is_shard(0):                       # expert parallel
            e0 = mesh.get_coordinate()[i] * local["w_gate"].shape[0]
    out = _moe_tokens(local, xt, cfg,
                      moe_capacity(b * s, cfg, capacity_factor), e0)
    return D.from_local(out.reshape(b, s, d), mesh, part,
                        (b, s, d)).redistribute(mesh, x.placements)

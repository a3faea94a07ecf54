"""Shared model substrate in PyTorch: config, norms, rotary embeddings,
inits (counterpart of the JAX package's ``models/common.py``).

One flat ``ModelConfig`` covers the whole architecture pool (dense GQA /
MoE / RWKV6 / Mamba2-hybrid / enc-dec / VLM), with the JAX package's
fields and parameter accounting.  Configs for the concrete architectures
live in ``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist import sharding as D


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # mlp
    act: str = "swiglu"              # swiglu|gelu
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # ssm
    ssm_type: Optional[str] = None   # rwkv6|mamba2
    ssm_state: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared transformer block every ``attn_every`` layers
    attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    frontend: Optional[str] = None   # audio|vision (STUB per assignment)
    scan_layers: bool = True
    scan_unroll: bool = False
    remat: bool = True
    # long-context capability marker (sub-quadratic decode state)
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe":
            mlp = 3 * d * f * self.n_experts + d * self.n_experts  # + router
        elif self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.ssm_type == "rwkv6":
            attn = 5 * d * d                      # r,k,v,g,o projections
            mlp = 2 * d * f
        elif self.ssm_type == "mamba2":
            d_in = self.ssm_expand * d
            attn = 0
            mlp = d * (2 * d_in + 2 * self.ssm_state
                       + d_in // self.ssm_head_dim) + d_in * d
        per_layer = attn + mlp
        total = self.n_layers * per_layer + v * d
        if not self.tie_embeddings:
            total += v * d
        if self.family == "hybrid" and self.attn_every:
            d_sh = self.d_model
            total += (4 * d_sh * d_sh) + 3 * d_sh * self.d_ff  # shared block
        if self.family == "encdec":
            enc = self.encoder_layers * (4 * d * d + 2 * d * f)
            cross = self.n_layers * (4 * d * d)
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (= dense count except for MoE)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - 3 * d * f * self.n_experts * self.n_layers
        return int(dense + 3 * d * f * self.experts_per_token * self.n_layers)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]``.  A DTensor table whose vocab is sharded
    over a mesh dim (the reference's ``P("model", None)``) is looked up
    on each rank's rows, the ids outside them giving 0, and the result is
    ``Partial`` over that dim (Megatron's vocab-parallel embedding);
    over any other mesh dim the rows take the tokens' layout.  A table
    whose width is split too (FSDP's storage over "data") is first
    gathered on those mesh dims."""
    if not D.is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        table = table.redistribute(mesh, [
            p if p.is_shard(0) else Replicate() for p in table.placements])
    if not D.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    ids = tokens.to_local()
    out_pl, vocab_dims = [], []
    for i, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        if tp.is_shard(0):
            vocab_dims.append(i)
            out_pl.append(Partial())
        elif tp.is_replicate():
            out_pl.append(kp)
        else:
            raise ValueError(f"embed_lookup: table placement {tp} on mesh "
                             f"dim {i} (vocab-sharded or replicated only)")
    if len(vocab_dims) > 1:
        raise ValueError("embed_lookup: the vocab is split over one mesh "
                         "dim at most")
    tl = D.local_shard(table, tokens)
    if vocab_dims:
        rows = tl.shape[0]
        ids = ids - mesh.get_coordinate()[vocab_dims[0]] * rows
        miss = (ids < 0) | (ids >= rows)
        rows_out = tl[torch.where(miss, 0, ids)]
        rows_out = rows_out * (~miss)[..., None].to(rows_out.dtype)
    else:
        rows_out = tl[ids]
    return D.from_local(rows_out, mesh, out_pl,
                        tuple(tokens.shape) + (table.shape[1],))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (population variance), the
    result in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, d]; positions: broadcastable to [..., seq].
    Split-halves layout: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    angles = positions[..., None].float() * freqs              # [..., s, d/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., s, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions3: [3, ..., seq] (t, h, w ids);
    the d/2 frequency slots are split into ``sections``: the first
    ``sections[0]`` follow the temporal stream, then height, then width."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    angles = positions3[..., None].float() * freqs     # [3, ..., s, d/2]
    idx = sec.expand(angles.shape[1:])[None]
    angles = torch.gather(angles, 0, idx)[0]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """[length, dim] fp32: sin at the even columns, cos at the odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# init helpers (the JAX package's scales; the numbers differ, since the
# generators differ)
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    """N(0, std^2) of ``shape`` drawn from ``gen`` on its device."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


def dense(gen: torch.Generator, cin: int, cout: int, dtype,
          std: Optional[float] = None) -> torch.Tensor:
    """A ``[cin, cout]`` weight (``x @ w``), N(0, 1/cin) by default."""
    return normal(gen, (cin, cout), dtype,
                  (1.0 / math.sqrt(cin)) if std is None else std)


def stacked(init_fn, gen: torch.Generator, n: int):
    """``n`` layers of ``init_fn(gen)``: the JAX package's stacked
    ``[L, ...]`` leaves become a list of per-layer trees."""
    return [init_fn(gen) for _ in range(n)]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL over the labels that are not ``ignore_id``, the
    logits' logsumexp in fp32 (the JAX package's ``cross_entropy_loss``);
    0 where every label is ignored."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

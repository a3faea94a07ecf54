"""Analytic FLOP / HBM-byte model per (arch x shape) cell.

Why analytic: XLA's ``cost_analysis()`` counts rolled-loop (lax.scan)
bodies once, so with depth-independent HLO (required for CPU compile
budgets) the aggregate FLOPs are undercounted by the trip counts.  We
therefore derive exact closed forms from the model definitions we control,
and *calibrate* them against cost_analysis on small unrolled single-device
compiles (tests/test_costs.py) — the two agree within ~10 %.

All counts are GLOBAL (whole step, all devices); the roofline divides by
chip count.  Byte counts model HBM traffic with explicit assumptions:
  * weights stream once per (micro)batch pass;
  * activations: C_ACT reads+writes of the residual-width tensor per layer;
  * XLA attention materializes the [B, H, S, ctx] score matrix (the Pallas
    flash kernel removes that term — the §Perf lever for 32k prefill);
  * decode streams the KV cache once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.common import ModelConfig

C_ACT = 8           # activation r/w per layer (qkv io, mlp io, norms, resid)
TRAIN_FLOP_FACTOR = 4.0       # fwd + 2x bwd + 1x remat recompute
TRAIN_BYTE_FACTOR = 3.0       # fwd + recompute + bwd activation traffic


def _dtype_size(cfg: ModelConfig) -> int:
    return 2 if "bfloat16" in str(cfg.dtype) or "16" in str(cfg.dtype) else 4


# ---------------------------------------------------------------------------
# per-token forward FLOPs
# ---------------------------------------------------------------------------

def _attn_flops_token(cfg: ModelConfig, ctx: float) -> float:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    proj = 2 * d * (qd + 2 * kvd) + 2 * qd * d
    attn = 4 * qd * ctx
    return proj + attn


def _mlp_flops_token(cfg: ModelConfig, d_ff: Optional[int] = None) -> float:
    f = d_ff or cfg.d_ff
    return (6 if cfg.act == "swiglu" else 4) * cfg.d_model * f


def _moe_flops_token(cfg: ModelConfig) -> float:
    d, f = cfg.d_model, cfg.d_ff
    router = 2 * d * cfg.n_experts
    experts = 6 * d * f * cfg.experts_per_token * cfg.capacity_factor
    return router + experts


def _rwkv6_flops_token(cfg: ModelConfig, chunk: int = 32) -> float:
    d, f = cfg.d_model, cfg.d_ff
    dh = cfg.ssm_head_dim
    h = d // dh
    proj = 2 * 5 * d * d + 4 * d * 64              # r,k,v,g,o + decay LoRA
    rec = h * (5 * chunk * dh + 4 * dh * dh)       # chunked recurrence
    channel = 4 * d * f + 2 * d * d
    return proj + rec + channel


def _mamba2_flops_token(cfg: ModelConfig, chunk: int = 64) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    proj = 2 * d * (2 * d_in + 2 * n + nh) + 2 * d_in * d
    conv = 2 * cfg.conv_width * (d_in + 2 * n)
    ssd = 2 * chunk * n + nh * (2 * chunk * hd + 4 * n * hd)
    return proj + conv + ssd


def fwd_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """One decoder-layer-stack forward, per token, at average context ctx."""
    if cfg.ssm_type == "rwkv6":
        per_layer = _rwkv6_flops_token(cfg)
    elif cfg.ssm_type == "mamba2":
        per_layer = _mamba2_flops_token(cfg)
        if cfg.family == "hybrid" and cfg.attn_every:
            shared = _attn_flops_token(cfg, ctx) + _mlp_flops_token(cfg)
            per_layer += shared / cfg.attn_every
    elif cfg.family == "moe":
        per_layer = _attn_flops_token(cfg, ctx) + _moe_flops_token(cfg)
    else:
        per_layer = _attn_flops_token(cfg, ctx) + _mlp_flops_token(cfg)
    return cfg.n_layers * per_layer


def _logits_flops(cfg: ModelConfig, positions: float) -> float:
    return 2.0 * cfg.d_model * cfg.vocab_size * positions


def _encoder_flops(cfg: ModelConfig, batch: float) -> float:
    if cfg.family != "encdec":
        return 0.0
    se = cfg.encoder_seq
    per_tok = _attn_flops_token(cfg, se) + _mlp_flops_token(cfg)
    return cfg.encoder_layers * per_tok * se * batch


def _cross_attn_flops(cfg: ModelConfig, batch: float, s_dec: float) -> float:
    if cfg.family != "encdec":
        return 0.0
    d, se = cfg.d_model, cfg.encoder_seq
    kv_once = 4 * d * d * se * batch * cfg.n_layers
    per_tok = 4 * d * d + 4 * cfg.q_dim * se       # q,o proj + attn ops
    return kv_once + per_tok * s_dec * batch * cfg.n_layers


# ---------------------------------------------------------------------------
# per-cell totals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellCost:
    flops: float                 # global FLOPs for the lowered step
    hbm_bytes: float             # global HBM traffic (model, see header)
    hbm_bytes_flash: float       # same, with Pallas flash attention
    model_flops: float           # 6*N*D (dense) / 6*N_active*D (MoE)
    params: int
    active_params: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _ctx(cfg: ModelConfig, kind: str, seq: int) -> float:
    full = seq / 2 if kind in ("train", "prefill") else seq
    if cfg.sliding_window:
        return min(full, cfg.sliding_window)
    return full


def cell_cost(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    dsz = _dtype_size(cfg)
    params = cfg.param_count()
    active = cfg.active_param_count()
    pbytes = params * dsz
    d = cfg.d_model
    L = cfg.n_layers

    if kind == "train":
        tokens = float(b) * s
        fwd = fwd_flops_per_token(cfg, _ctx(cfg, kind, s)) * tokens \
            + _logits_flops(cfg, tokens) \
            + _encoder_flops(cfg, b) + _cross_attn_flops(cfg, b, s)
        flops = fwd * TRAIN_FLOP_FACTOR
        # bytes: weights per microbatch-pass x3, activations, attn matrix
        micro = 8
        weights = pbytes * micro * 3.0
        act = L * tokens * d * dsz * C_ACT * TRAIN_BYTE_FACTOR
        attn_mat = _attn_matrix_bytes(cfg, b, s, _ctx(cfg, kind, s)) \
            * TRAIN_BYTE_FACTOR
        opt = pbytes * 5.0                      # m, v r/w + param update
        model_flops = 6.0 * active * tokens
        return CellCost(flops, weights + act + attn_mat + opt,
                        weights + act + opt, model_flops, params, active)

    if kind == "prefill":
        tokens = float(b) * s
        fwd = fwd_flops_per_token(cfg, _ctx(cfg, kind, s)) * tokens \
            + _logits_flops(cfg, b) \
            + _encoder_flops(cfg, b) + _cross_attn_flops(cfg, b, s)
        act = L * tokens * d * dsz * C_ACT
        attn_mat = _attn_matrix_bytes(cfg, b, s, _ctx(cfg, kind, s))
        kv_write = _kv_bytes(cfg, b, s)
        model_flops = 2.0 * active * tokens
        return CellCost(fwd, pbytes + act + attn_mat + kv_write,
                        pbytes + act + kv_write, model_flops, params, active)

    # decode: one token per sequence against a seq_len cache
    ctx = _ctx(cfg, kind, s)
    fwd = fwd_flops_per_token(cfg, ctx) * b + _logits_flops(cfg, b) \
        + (4 * d * d + 4 * cfg.q_dim * cfg.encoder_seq) * b * L \
        * (1.0 if cfg.family == "encdec" else 0.0)
    kv_read = _kv_bytes(cfg, b, s)
    act = L * b * d * dsz * C_ACT
    active_read = active * dsz                 # weights stream once
    model_flops = 2.0 * active * b
    total_bytes = active_read + kv_read + act
    return CellCost(fwd, total_bytes, total_bytes, model_flops, params,
                    active)


def _attn_matrix_bytes(cfg: ModelConfig, b: int, s: int, ctx: float) -> float:
    """XLA-path attention materializes [B, H, S, ctx] scores (fp32) ~3x
    (write logits, softmax rw, read for values).  Zero for SSM archs."""
    if cfg.ssm_type and cfg.family != "hybrid":
        return 0.0
    h = cfg.n_heads
    eff_layers = cfg.n_layers if not cfg.ssm_type else \
        cfg.n_layers // max(cfg.attn_every, 1)
    return 3.0 * eff_layers * b * h * s * ctx * 4.0


def _kv_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    dsz = _dtype_size(cfg)
    if cfg.ssm_type == "rwkv6":
        dh = cfg.ssm_head_dim
        h = cfg.d_model // dh
        return cfg.n_layers * b * h * dh * dh * 4.0
    if cfg.ssm_type == "mamba2":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        state = cfg.n_layers * b * nh * cfg.ssm_head_dim * cfg.ssm_state * 4.0
        if cfg.family == "hybrid" and cfg.attn_every:
            napp = cfg.n_layers // cfg.attn_every
            w = min(s, cfg.sliding_window or s)
            state += napp * b * cfg.kv_dim * w * dsz * 2
        return state
    w = min(s, cfg.sliding_window or s)
    kv = cfg.n_layers * b * cfg.kv_dim * w * dsz * 2
    if cfg.family == "encdec":
        kv += cfg.n_layers * b * cfg.kv_dim * cfg.encoder_seq * dsz * 2
    return kv

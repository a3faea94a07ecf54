"""Attention-free sequence mixers in PyTorch (counterpart of the JAX
package's ``models/ssm.py``): RWKV-6 (Finch) and Mamba-2 (SSD).

RWKV-6's recurrence goes through :func:`repro_torch.kernels.ops.rwkv6_scan`
(the Hopper kernel for a CUDA tensor, the sequential plain version on the
CPU).  The JAX model computes the same recurrence with its chunked XLA
form, ``rwkv6_chunked``, which has no counterpart here: the kernel
computes its function, and ``tests/test_kernels.py:267`` holds the
chunked form to the sequential one.  Mamba-2's chunked SSD has no Pallas
kernel in the JAX package (it runs as XLA), so it is plain tensor code
here, with a Python loop over chunks where JAX scans.  Large products stay
``torch.matmul``, as the JAX package leaves them to XLA.

``state`` is a layer's slice of the serving cache.  Where the JAX blocks
return a new state, the port's write it **in place** into the tensors
they were given (the RWKV-6 kernel writes its final state over its
initial one) and return that same dict; ``state=None`` runs from zeros and
keeps nothing.  The decay parameters (``w0``, ``u``, ``A_log``, ``D``,
``dt_bias``) are fp32 whatever ``cfg.dtype`` is, as in the JAX init.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P
from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models.common import ModelConfig

F32 = torch.float32


# ===========================================================================
# RWKV-6
# ===========================================================================

def rwkv6_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = cfg.dtype, gen.device
    d = cfg.d_model
    dh = cfg.ssm_head_dim
    h = d // dh
    f = cfg.d_ff
    lora = 64

    def full(value, dtype=dt):
        return torch.full((d,), value, dtype=dtype, device=dev)

    return {
        # token-shift lerp coefficients
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        # time-mix projections
        "wr": C.dense(gen, d, d, dt), "wk": C.dense(gen, d, d, dt),
        "wv": C.dense(gen, d, d, dt), "wg": C.dense(gen, d, d, dt),
        "wo": C.dense(gen, d, d, dt),
        # data-dependent decay (the Finch feature): w = w0 + tanh(x A) B
        "w0": full(-2.0, F32),
        "w_lora_a": C.dense(gen, d, lora, dt, std=0.01),
        "w_lora_b": C.dense(gen, lora, d, dt, std=0.01),
        "u": C.normal(gen, (h, dh), F32, 0.1),                # bonus
        "ln_x": full(1.0),
        # channel mix
        "mu_ck": full(0.5), "mu_cr": full(0.5),
        "ck": C.dense(gen, d, f, dt), "cv": C.dense(gen, f, d, dt),
        "cr": C.dense(gen, d, d, dt),
    }


def rwkv6_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    rep = P(None)
    return {
        "mu_r": rep, "mu_k": rep, "mu_v": rep, "mu_w": rep, "mu_g": rep,
        "wr": P(None, "model"), "wk": P(None, "model"), "wv": P(None, "model"),
        "wg": P(None, "model"), "wo": P("model", None),
        "w0": rep, "w_lora_a": P(None, None), "w_lora_b": P(None, "model"),
        "u": P("model", None), "ln_x": rep,
        "mu_ck": rep, "mu_cr": rep,
        "ck": P(None, "model"), "cv": P("model", None), "cr": P(None, "model"),
    }


def _shift(x: torch.Tensor, carry: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / the carried last token at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if carry is None else carry[:, None]
    return torch.cat([pad.to(x.dtype), x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, h*dh] -> contiguous [B, h, T, dh], the kernel's layout."""
    b, t, _ = x.shape
    return x.reshape(b, t, h, -1).transpose(1, 2).contiguous()


def _scan(r, k, v, w, u, s):
    """``ops.rwkv6_scan`` (the final state written over ``s``) on plain
    tensors, or on each rank's shards of DTensors: r, k, v and w are
    pinned to batch rows over the data axes and heads over ``model``
    (where the heads divide it), ``u`` to the same heads, and a carried
    state ``s`` is read in that layout and written back in its own, so
    each rank's recurrence is its own slice."""
    if not D.is_dtensor(r):
        return ops.rwkv6_scan(r, k, v, w, u, s, out_state=s)[0]
    mesh = D.get_constraint_mesh()
    heads = "model" if mesh is not None and \
        r.shape[1] % D.axis_size(mesh, "model") == 0 else None
    r, k, v, w = (D.constrain(t, "data", heads, None, None)
                  for t in (r, k, v, w))
    u = D.constrain(u, heads, None)
    s_in = None if s is None else s.redistribute(mesh, r.placements)
    out, final = ops.rwkv6_scan(*(D.local_shard(t, r) for t in (
        r, k, v, w, u)), None if s_in is None else s_in.to_local())
    if s is not None:
        s.copy_(D.from_local(final, mesh, r.placements, s.shape))
    return D.from_local_like(out, r)


def rwkv6_block(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full RWKV-6 layer (time mix + channel mix); the caller applies the
    pre-norm residual.  ``state``: {'s': [B,H,D,D] fp32, 'shift_t': [B,d],
    'shift_c': [B,d]}, read and then overwritten in place."""
    b, t, d = x.shape
    dh = cfg.ssm_head_dim
    h = d // dh

    xs = _shift(x, None if state is None else state["shift_t"])

    def mix(mu):
        return x + (xs - x) * mu.to(x.dtype)

    r = _heads(mix(p["mu_r"]) @ p["wr"], h)
    k = _heads(mix(p["mu_k"]) @ p["wk"], h)
    v = _heads(mix(p["mu_v"]) @ p["wv"], h)
    g = mix(p["mu_g"]) @ p["wg"]
    xw = mix(p["mu_w"])
    w_raw = p["w0"].float() + (torch.tanh(xw @ p["w_lora_a"])
                               @ p["w_lora_b"]).float()

    s = None if state is None else state["s"]
    out = _scan(r, k, v, _heads(w_raw, h), p["u"], s)
    # per-head normalization (official GroupNorm(h) over the flattened dim)
    out = C.rms_norm(out.transpose(1, 2),
                     torch.ones((dh,), dtype=x.dtype, device=x.device),
                     cfg.norm_eps).reshape(b, t, d) * p["ln_x"].to(x.dtype)
    out = (out * F.silu(g)) @ p["wo"]

    # channel mix (token-shifted squared-relu FFN with receptance gate)
    x2 = x + out
    xs2 = _shift(x2, None if state is None else state["shift_c"])

    def mix2(mu):
        return x2 + (xs2 - x2) * mu.to(x.dtype)

    kk = torch.square(torch.relu(mix2(p["mu_ck"]) @ p["ck"]))
    cm = (kk @ p["cv"]) * torch.sigmoid(mix2(p["mu_cr"]) @ p["cr"])

    if state is not None:
        state["shift_t"].copy_(x[:, -1])
        state["shift_c"].copy_(x2[:, -1])
    return out + cm, state


def rwkv6_state_init(cfg: ModelConfig, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dh = cfg.ssm_head_dim
    h = d // dh
    return {"s": torch.zeros((batch, h, dh, dh), dtype=F32, device=device),
            "shift_t": torch.zeros((batch, d), dtype=cfg.dtype,
                                   device=device),
            "shift_c": torch.zeros((batch, d), dtype=cfg.dtype,
                                   device=device)}


def rwkv6_state_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"s": P("data", "model", None, None),
            "shift_t": P("data", None), "shift_c": P("data", None)}


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================

def mamba2_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = cfg.dtype, gen.device
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    d_proj = 2 * d_in + 2 * n + nh                      # z, xBC, dt
    return {
        "in_proj": C.dense(gen, d, d_proj, dt),
        "conv_w": C.normal(gen, (cfg.conv_width, d_in + 2 * n), dt, 0.1),
        "conv_b": torch.zeros((d_in + 2 * n,), dtype=dt, device=dev),
        "A_log": torch.zeros((nh,), dtype=F32, device=dev),  # A = -exp(A_log)
        "D": torch.ones((nh,), dtype=F32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=dev),
        "norm": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": C.dense(gen, d_in, d, dt),
    }


def mamba2_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"in_proj": P(None, "model"), "conv_w": P(None, None),
            "conv_b": P(None), "A_log": P(None), "D": P(None),
            "dt_bias": P(None), "norm": P("model"),
            "out_proj": P("model", None)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as shifted elementwise sums.
    x [B, T, Cch]; w [K, Cch]; carry [B, K-1, Cch] (decode)."""
    kw = w.shape[0]
    pad = (torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if carry is None else carry.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * w[i].to(x.dtype) for i in range(kw))
    return y + b.to(x.dtype)


def mamba2_ssd(xh: torch.Tensor, dtv: torch.Tensor, A: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, state: torch.Tensor,
               chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh [B,T,nh,hd]; dtv [B,T,nh]; A [nh] (negative);
    Bc/Cc [B,T,N]; state [B,nh,hd,N] fp32.  Returns (y fp32, new state)."""
    b, t, nh, hd = xh.shape
    n = Bc.shape[-1]
    chunk = min(chunk, t)
    while t % chunk:
        chunk //= 2
    nc = t // chunk

    dA = dtv.float() * A.float()                           # [B,T,nh] <= 0
    xs = (xh.float() * dtv.float()[..., None]).reshape(b, nc, chunk, nh, hd)
    Bs = Bc.float().reshape(b, nc, chunk, n)
    Cs = Cc.float().reshape(b, nc, chunk, n)
    L = torch.cumsum(dA.reshape(b, nc, chunk, nh), dim=2)  # inclusive
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))        # with the diagonal
    S = state.float()
    ys = []
    for c in range(nc):
        xc, bc, cc, lc = xs[:, c], Bs[:, c], Cs[:, c], L[:, c]
        # inter: y_t += exp(L_t) * (C_t . S)
        y_inter = torch.einsum("bcn,bhdn->bchd", cc, S) * \
            torch.exp(lc)[..., None]
        # intra: pairwise decay per head (scalar), safe on the mask
        expo = lc[:, :, None, :] - lc[:, None, :, :]       # [B,t,s,nh]
        dec = torch.exp(torch.clamp(expo, max=0.0)) * mask[None, :, :, None]
        cb = torch.einsum("btn,bsn->bts", cc, bc)           # [B,t,s]
        y_intra = torch.einsum("bts,btsh,bshd->bthd", cb, dec, xc)
        ys.append(y_inter + y_intra)
        # state update
        llast = lc[:, -1:, :]                               # [B,1,nh]
        kd = torch.exp(torch.clamp(llast - lc, max=0.0))    # [B,C,nh]
        S = torch.exp(llast[:, 0])[:, :, None, None] * S + \
            torch.einsum("bch,bchd,bcn->bhdn", kd, xc, bc)
    y = torch.stack(ys, dim=1).reshape(b, t, nh, hd)
    return y, S


def mamba2_block(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x [B, T, d] -> [B, T, d].  ``state``: {'h': [B,nh,hd,N] fp32,
    'conv': [B, K-1, d_in+2N]}, read and then overwritten in place."""
    b, t, d = x.shape
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dtv = F.softplus(zxbcdt[..., -nh:].float() + p["dt_bias"].float())

    conv_carry = None if state is None else state["conv"]
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"], conv_carry))
    xc = xbc[..., :d_in].reshape(b, t, nh, hd)
    bc = xbc[..., d_in:d_in + n]
    cc = xbc[..., d_in + n:]

    A = -torch.exp(p["A_log"].float())
    h0 = (torch.zeros((b, nh, hd, n), dtype=F32, device=x.device)
          if state is None else state["h"])
    y, h_new = mamba2_ssd(xc, dtv, A, bc, cc, h0)
    y = y + p["D"].float()[None, None, :, None] * xc.float()
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = C.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]

    if state is not None:
        tail = xbc_raw_tail(zxbcdt, d_in, n, cfg.conv_width, state["conv"])
        state["h"].copy_(h_new)
        state["conv"].copy_(tail)
    return out, state


def xbc_raw_tail(zxbcdt: torch.Tensor, d_in: int, n: int, kw: int,
                 prev: torch.Tensor) -> torch.Tensor:
    """Last K-1 *pre-conv* xBC inputs for the decode conv carry."""
    xbc_raw = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    joined = torch.cat([prev.to(xbc_raw.dtype), xbc_raw], dim=1)
    return joined[:, -(kw - 1):]


def mamba2_state_init(cfg: ModelConfig, batch: int,
                      device=None) -> Dict[str, torch.Tensor]:
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    return {"h": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=F32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * n),
                                dtype=cfg.dtype, device=device)}


def mamba2_state_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"h": P("data", "model", None, None),
            "conv": P("data", None, "model")}

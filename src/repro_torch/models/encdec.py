"""Encoder-decoder LM (Whisper-style) in PyTorch (counterpart of the JAX
package's ``models/encdec.py``).

The conv frontend is a stub: the caller gives precomputed frame
embeddings [B, encoder_seq, d] (what Whisper's two conv layers would
make of the mel spectrogram).  Backbone: a bidirectional encoder
(sinusoidal positions) and a causal decoder with cross-attention (learned
positions), LayerNorm with bias, GELU MLPs, no RoPE.

Serving: the prefill encodes the frames once and keeps each decoder
layer's cross-attention K/V in the cache (``xk``/``xv`` ``[L, B, H, Se,
dh]``); a decode step reads them through ``decode_attention`` at length
Se and writes only its own token's self-attention K/V (``k``/``v`` ``[L,
B, H, max_len, dh]``, no window), in place.  The parameter tree is the
JAX package's with the stacked ``enc_layers`` and ``dec_layers`` as lists
of per-layer dicts.

Training: :func:`loss` is the decoder's mean token NLL over ``frames``,
``tokens`` and ``labels``; with ``cfg.remat`` on and grad enabled every
encoder and decoder layer is a checkpointed region (the JAX package's
``jax.checkpoint`` of each scanned layer).  :func:`param_pspecs` and
:func:`cache_pspecs` are the reference's layouts (per-layer leaves drop
the stack's leading ``None``); under a constraint mesh each layer pins
the residual stream batch-sharded, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P
from repro_torch.kernels import ops
from repro_torch.models import blocks as B
from repro_torch.models import common as C
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import batch_on_device, leaf_dtypes, remat_on
from repro_torch.vae.model import param_count


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ln_init(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                device=device)}


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig):
    return {"ln1": _ln_init(cfg, gen.device), "attn": B.attn_init(gen, cfg),
            "ln2": _ln_init(cfg, gen.device), "mlp": B.mlp_init(gen, cfg)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig):
    return {"ln1": _ln_init(cfg, gen.device),
            "self_attn": B.attn_init(gen, cfg),
            "lnx": _ln_init(cfg, gen.device),
            "cross_attn": B.attn_init(gen, cfg),
            "ln2": _ln_init(cfg, gen.device), "mlp": B.mlp_init(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                max_pos: int) -> Dict[str, Any]:
    """Seeded random parameters at the JAX package's scales: embed and
    ``pos_embed`` ([max_pos, d]) N(0, 0.02), dense weights N(0, 1/cin),
    LayerNorm scale 1 and bias 0."""
    return {
        "embed": C.normal(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype,
                          0.02),
        "pos_embed": C.normal(gen, (max_pos, cfg.d_model), cfg.dtype, 0.02),
        "enc_layers": C.stacked(lambda g: _enc_layer_init(g, cfg), gen,
                                cfg.encoder_layers),
        "enc_norm": _ln_init(cfg, gen.device),
        "dec_layers": C.stacked(lambda g: _dec_layer_init(g, cfg), gen,
                                cfg.n_layers),
        "final_norm": _ln_init(cfg, gen.device),
    }


_LN_SPEC = {"scale": P(None), "bias": P(None)}


def param_pspecs(cfg: ModelConfig, model_axis: int = 16) -> Dict[str, Any]:
    """The parameter tree's specs, a list entry per layer (the
    reference's stacked leaf ``P(None, *spec)`` is ``spec`` here).
    ``model_axis`` is unused, as in the reference (no experts)."""
    def enc_layer():
        return {"ln1": _LN_SPEC, "attn": B.attn_pspecs(cfg),
                "ln2": _LN_SPEC, "mlp": B.mlp_pspecs(cfg)}

    def dec_layer():
        return {"ln1": _LN_SPEC, "self_attn": B.attn_pspecs(cfg),
                "lnx": _LN_SPEC, "cross_attn": B.attn_pspecs(cfg),
                "ln2": _LN_SPEC, "mlp": B.mlp_pspecs(cfg)}

    return {"embed": P("model", None), "pos_embed": P(None, None),
            "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
            "enc_norm": _LN_SPEC,
            "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
            "final_norm": _LN_SPEC}


def cache_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    kv = P(None, "data", None, "model", None)   # sequence-sharded
    # cross K/V: 1500 encoder frames don't divide the model axis and the
    # tensor is small: replicated over 'model', batch-sharded only
    xkv = P(None, "data", None, None, None)
    return {"pos": P("data"), "k": kv, "v": kv, "xk": xkv, "xv": xkv}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The residual stream batch-sharded, replicated over model (the
    reference's constraint in every encoder and decoder layer)."""
    return D.constrain(x, "data", None, None)


# ---------------------------------------------------------------------------
# forward passes (plain functions on a parameter tree)
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    return C.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _layers(body, layers, x: torch.Tensor, cfg: ModelConfig, *args
            ) -> torch.Tensor:
    """``x = body(p, x, *args)`` for each layer's ``p``, each a
    checkpointed region under :func:`~repro_torch.models.lm.remat_on`."""
    remat = remat_on(cfg)
    for p in layers:
        x = (checkpoint(body, p, x, *args, use_reentrant=False) if remat
             else body(p, x, *args))
    return x


def _enc_layer(p, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    x = _rows(x)
    h, _, _ = B.attention(p["attn"], _ln(x, p["ln1"], cfg), cfg,
                          positions, causal=False)
    x = _rows(x + h)
    return x + B.mlp(p["mlp"], _ln(x, p["ln2"], cfg), cfg)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, Se, d] (the stub frontend's output) -> encoder states:
    non-causal attention over the frames in every layer."""
    b, se, _ = frames.shape
    pos = C.sinusoidal_positions(se, cfg.d_model, frames.device)
    x = frames.to(cfg.dtype) + pos.to(cfg.dtype)[None]
    positions = _positions(b, se, frames.device)
    x = _layers(_enc_layer, params["enc_layers"], x, cfg, cfg, positions)
    return _ln(x, params["enc_norm"], cfg)


def _dec_layer(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    """A decoder layer over a full sequence: causal self-attention,
    cross-attention to the encoder states, the MLP."""
    x = _rows(x)
    h, _, _ = B.attention(p["self_attn"], _ln(x, p["ln1"], cfg), cfg,
                          positions, causal=True)
    x = _rows(x + h)
    h, _, _ = B.attention(p["cross_attn"], _ln(x, p["lnx"], cfg), cfg,
                          positions, causal=False,
                          kv=cross_kv(p["cross_attn"], enc_out, cfg))
    x = x + h
    return x + B.mlp(p["mlp"], _ln(x, p["ln2"], cfg), cfg)


def loss(params, batch: Dict[str, torch.Tensor],
         cfg: ModelConfig) -> torch.Tensor:
    """The training objective: ``batch`` holds ``frames`` [B, Se, d],
    ``tokens`` and ``labels`` [B, S] -> the decoder's mean token NLL
    (labels -1 ignored), fp32."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = C.embed_lookup(params["embed"], tokens) + \
        params["pos_embed"][:s][None]
    x = _layers(_dec_layer, params["dec_layers"], x, cfg, cfg,
                _positions(b, s, tokens.device), enc_out)
    h = _ln(x, params["final_norm"], cfg)
    # vocab-sharded logits gather their vocab for the loss's logsumexp
    lg = D.constrain(h @ params["embed"].T, "data", None, None)
    return C.cross_entropy_loss(lg, batch["labels"])


def cross_kv(p_attn, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention k and v [B, Se, Hkv, dh] from the
    encoder states."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.head_dim)
    kx, vx = enc_out @ p_attn["wk"], enc_out @ p_attn["wv"]
    if cfg.qkv_bias:              # before the head split (blocks._qkv)
        kx = kx + p_attn["bk"].to(kx.dtype)
        vx = vx + p_attn["bv"].to(vx.dtype)
    return (B.kv_projection_layout(kx, cfg).reshape(shape),
            B.kv_projection_layout(vx, cfg).reshape(shape))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               encoder_seq: Optional[int] = None, mesh=None
               ) -> Dict[str, Any]:
    """``pos`` [B] int32, ``k``/``v`` [L, B, H, max_len, dh] and
    ``xk``/``xv`` [L, B, H, Se, dh] (Se = ``encoder_seq``, by default the
    config's), zeros; with a ``mesh``, DTensors laid out by
    :func:`cache_pspecs` (the axes that do not divide a dim dropped)."""
    if mesh is not None:
        return D.zeros_tree(init_cache(cfg, batch, max_len, "meta",
                                       encoder_seq), cache_pspecs(cfg), mesh)
    L, se = cfg.n_layers, encoder_seq or cfg.encoder_seq
    k = torch.zeros((L, batch, cfg.n_kv_heads, max_len, cfg.head_dim),
                    dtype=cfg.dtype, device=device)
    xk = torch.zeros((L, batch, cfg.n_kv_heads, se, cfg.head_dim),
                     dtype=cfg.dtype, device=device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": k, "v": torch.zeros_like(k),
            "xk": xk, "xv": torch.zeros_like(xk)}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode ``frames``, run the decoder over ``tokens`` [B, S] (causal
    self-attention, non-causal cross-attention to the encoder states) and
    return (logits of the last position [B, V], the filled cache).
    ``max_len`` (>= S) sizes the self-attention cache.  On DTensor
    parameters, as :func:`repro_torch.models.lm.prefill`: the cache laid
    out by :func:`cache_pspecs`, the logits over (data axes, "model")."""
    mesh = D.mesh_of(params["embed"])
    with D.on_mesh(mesh):
        if mesh is not None:
            inputs = D.distribute_batch({"tokens": tokens,
                                         "frames": frames}, mesh)
            tokens, frames = inputs["tokens"], inputs["frames"]
        enc_out = encode(params, frames, cfg)
        b, s = tokens.shape
        max_len = max(max_len or s, s)
        cache = init_cache(cfg, b, max_len, tokens.device, enc_out.shape[1],
                           mesh)
        x = C.embed_lookup(params["embed"], tokens) + \
            params["pos_embed"][:s][None]
        positions = _positions(b, s, tokens.device)
        pad = (0, 0, 0, max_len - s)             # free slots for decode
        for i, p in enumerate(params["dec_layers"]):
            h, kt, vt = B.attention(p["self_attn"], _ln(x, p["ln1"], cfg),
                                    cfg, positions, causal=True)
            cache["k"][i].copy_(F.pad(kt, pad))
            cache["v"][i].copy_(F.pad(vt, pad))
            x = x + h
            h, xkt, xvt = B.attention(p["cross_attn"],
                                      _ln(x, p["lnx"], cfg), cfg, positions,
                                      causal=False, kv=cross_kv(
                                          p["cross_attn"], enc_out, cfg))
            cache["xk"][i].copy_(xkt)
            cache["xv"][i].copy_(xvt)
            x = x + h
            x = x + B.mlp(p["mlp"], _ln(x, p["ln2"], cfg), cfg)
        cache["pos"].fill_(s)
        h = _ln(x[:, -1], params["final_norm"], cfg)
        lg = h @ params["embed"].T
        if mesh is not None:
            lg = D.lay_out(lg, P(D.dp_axes(mesh), "model"))
    return lg, cache


def decode_step(params, cache: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B] -> (logits [B, V], the cache, updated in place).  The
    learned position is ``pos_embed[min(pos, max_pos - 1)]``.  On DTensor
    parameters and cache, as :func:`repro_torch.models.lm.decode_step`:
    the self-attention's slots merged across "model", the cross K/V read
    on each rank's rows."""
    mesh = D.mesh_of(params["embed"])
    with D.on_mesh(mesh):
        if mesh is not None:
            tokens = D.distribute_batch({"tokens": tokens}, mesh)["tokens"]
        b = tokens.shape[0]
        pos = cache["pos"]
        max_pos = params["pos_embed"].shape[0]
        x = (C.embed_lookup(params["embed"], tokens) + C.embed_lookup(
            params["pos_embed"], torch.clamp(pos, max=max_pos - 1)))[:, None]
        lengths = torch.full_like(pos, cache["xk"].shape[3])
        for i, p in enumerate(params["dec_layers"]):
            x = x + B.attention_decode(p["self_attn"], _ln(x, p["ln1"], cfg),
                                       cfg, cache["k"][i], cache["v"][i], pos)
            # cross-attention against the cached encoder K/V
            pa = p["cross_attn"]
            q = _ln(x, p["lnx"], cfg) @ pa["wq"]
            if cfg.qkv_bias:          # before the head split (blocks._qkv)
                q = q + pa["bq"].to(q.dtype)
            if D.is_dtensor(q):
                q = B.token_layout(q)
            q = q.reshape(b, cfg.n_heads, cfg.head_dim)
            if D.is_dtensor(q):
                o = B.decode_attention_sharded(q, cache["xk"][i],
                                               cache["xv"][i], lengths)
            else:
                o = ops.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                         lengths)
            x = x + o.reshape(b, 1, cfg.q_dim) @ pa["wo"]
            x = x + B.mlp(p["mlp"], _ln(x, p["ln2"], cfg), cfg)
        cache["pos"] = pos + 1
        h = _ln(x[:, 0], params["final_norm"], cfg)
        lg = h @ params["embed"].T
        if mesh is not None:
            lg = D.lay_out(lg, P(D.dp_axes(mesh), "model"))
    return lg, cache


# ---------------------------------------------------------------------------
# the model on one device
# ---------------------------------------------------------------------------

class EncDecLM:
    """Config + parameters on one device, and the serving entry points
    ``encode``, ``prefill(tokens, frames, max_len)`` and
    ``decode_step(cache, tokens)``.

    As :class:`repro_torch.models.lm.CausalLM`: ``params`` (e.g. from
    :func:`repro_torch.models.bridge.encdec_from_numpy`) replaces the
    seeded initialisation; ``device`` defaults to ``"cuda"`` and raises
    where CUDA is absent; every serving entry point runs under
    ``torch.inference_mode()``, and the parameters are made under
    ``torch.no_grad()`` for training (:meth:`loss`).
    ``max_target_positions`` is the rows of
    ``pos_embed`` (the JAX package's default, 32768).
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None,
                 max_target_positions: int = 32768):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM serves the encdec "
                             f"family, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.no_grad():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    int(seed))
                params = init_params(gen, cfg, max_target_positions)
            self.params = leaf_dtypes(params, cfg, lambda t, dt: t.to(
                device=self.device, dtype=dt).contiguous())
        self.max_pos = self.params["pos_embed"].shape[0]

    @property
    def n_params(self) -> int:
        return param_count(self.params)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, device=self.device)

    def encode(self, frames) -> torch.Tensor:
        with torch.inference_mode():
            return encode(self.params, self._frames(frames), self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, tokens, frames, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with D.serving_mode(self.params["embed"]):
            return prefill(self.params, self._tokens(tokens),
                           self._frames(frames), self.cfg, max_len)

    def decode_step(self, cache: Dict[str, Any], tokens
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with D.serving_mode(self.params["embed"]):
            return decode_step(self.params, cache, self._tokens(tokens),
                               self.cfg)

    def param_pspecs(self, model_axis: int = 16) -> Dict[str, Any]:
        return param_pspecs(self.cfg, model_axis)

    def cache_pspecs(self) -> Dict[str, Any]:
        return cache_pspecs(self.cfg)

    def batch_on_device(self, batch) -> Dict[str, torch.Tensor]:
        return batch_on_device(batch, self.device)

    def loss(self, batch, params=None) -> torch.Tensor:
        """:func:`loss` of ``params`` (default: the model's own) on
        ``batch`` (numpy or tensors), under the caller's grad mode."""
        return loss(self.params if params is None else params,
                    self.batch_on_device(batch), self.cfg)

"""Decoder-only causal LM in PyTorch, dense family (counterpart of the JAX
package's ``models/lm.py``): the serving entry points ``prefill`` and
``decode_step``, and ``hidden`` / ``logits``.

The parameter tree is the JAX package's, with one difference: JAX's
stacked ``[L, ...]`` layer leaves become a list of per-layer dicts, and
the layers run in a Python loop where JAX scans.  The KV cache has the
JAX package's tree (``pos [B]`` int32, ``k``/``v`` ``[L, B, Hkv, S,
dh]``); ``decode_step`` updates it in place.  ``loss`` and training, and
the MoE, SSM, hybrid, enc-dec and VLM families, wait for their slices of
the port (``NOT_PORTED``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import common as C
from repro_torch.models.common import ModelConfig
from repro_torch.vae.model import map_params, param_count

#: families the port does not serve yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "moe": "ROADMAP A 11 (MoE)",
    "ssm": "ROADMAP A 12 (SSM: RWKV-6, then Mamba-2)",
    "hybrid": "ROADMAP A 13 (hybrid)",
    "encdec": "ROADMAP A 14 (enc-dec)",
    "vlm": "ROADMAP A 15 (VLM / M-RoPE)",
}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family waits for "
            f"{NOT_PORTED[cfg.family]}; the port serves the dense family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    ones = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)
    return {"ln1": ones, "attn": B.attn_init(gen, cfg),
            "ln2": ones.clone(), "mlp": B.mlp_init(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen``'s device at the JAX package's
    scales: embed N(0, 0.02), dense weights N(0, 1/cin), norms 1,
    biases 0."""
    params: Dict[str, Any] = {
        "embed": C.normal(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype,
                          0.02),
        "layers": C.stacked(lambda g: _layer_init(g, cfg), gen, cfg.n_layers),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                 device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = C.dense(gen, cfg.d_model, cfg.vocab_size,
                                    cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# forward passes (plain functions on a parameter tree)
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig):
    return C.rms_norm(x, scale, cfg.norm_eps)


def _mlp_residual(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + B.mlp(p["mlp"], _norm(x, p["ln2"], cfg), cfg)


def hidden(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids [B, S] -> final hidden states [B, S, d]."""
    x = params["embed"][tokens]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for p in params["layers"]:
        h, _, _ = B.attention(p["attn"], _norm(x, p["ln1"], cfg), cfg,
                              positions)
        x = _mlp_residual(p, x + h, cfg)
    return _norm(x, params["final_norm"], cfg)


def logits(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    s = min(max_len, cfg.sliding_window or max_len)
    k = torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim),
                    dtype=cfg.dtype, device=device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": k, "v": torch.zeros_like(k)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits for the last position [B, V], filled cache).

    ``max_len`` sizes the KV cache (>= prompt length) so decode steps
    have free slots; defaults to the prompt length.  With a sliding
    window the cache keeps the last ``window`` positions, rolled into the
    ring-buffer slots that ``decode_step`` continues."""
    x = params["embed"][tokens]
    b, s_total, _ = x.shape
    max_len = max(max_len or s_total, s_total)
    positions = torch.arange(s_total, device=x.device)[None].expand(
        b, s_total)
    cache = init_cache(cfg, b, max_len, x.device)
    w = cfg.sliding_window
    keep = min(s_total, w or s_total)
    for i, p in enumerate(params["layers"]):
        h, kt, vt = B.attention(p["attn"], _norm(x, p["ln1"], cfg), cfg,
                                positions)
        kk, vv = kt[:, :, -keep:], vt[:, :, -keep:]
        if w and s_total > w:
            shift = s_total % w                  # ring-buffer alignment
            kk = torch.roll(kk, shift, dims=2)
            vv = torch.roll(vv, shift, dims=2)
        cache["k"][i, :, :, :keep] = kk          # later slots stay 0
        cache["v"][i, :, :, :keep] = vv
        x = _mlp_residual(p, x + h, cfg)
    cache["pos"].fill_(s_total)
    h = _norm(x[:, -1], params["final_norm"], cfg)
    return logits(params, h, cfg), cache


def decode_step(params, cache: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B] -> (logits [B, V], the cache, updated in place)."""
    pos = cache["pos"]
    x = params["embed"][tokens][:, None, :]              # [B, 1, d]
    for i, p in enumerate(params["layers"]):
        h = B.attention_decode(p["attn"], _norm(x, p["ln1"], cfg), cfg,
                               cache["k"][i], cache["v"][i], pos)
        x = _mlp_residual(p, x + h, cfg)
    cache["pos"] = pos + 1
    h = _norm(x[:, 0], params["final_norm"], cfg)
    return logits(params, h, cfg), cache


# ---------------------------------------------------------------------------
# the model on one device
# ---------------------------------------------------------------------------

class CausalLM:
    """Config + parameters on one device, and the serving entry points.

    ``params`` (a tree of tensors with per-layer dicts, e.g. from
    :func:`repro_torch.models.bridge.lm_from_numpy`) replaces the seeded
    random initialisation, which draws from a ``torch.Generator`` on the
    target device.  ``device`` defaults to ``"cuda"`` and raises where
    CUDA is absent; pass ``device="cpu"`` for the plain path.  Every entry
    point runs under ``torch.inference_mode()`` and takes token ids as
    anything ``torch.as_tensor`` reads.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None):
        require_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.inference_mode():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    int(seed))
                params = init_params(gen, cfg)
            self.params = map_params(params, lambda t: t.to(
                device=self.device, dtype=cfg.dtype).contiguous())

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    @property
    def n_params(self) -> int:
        return param_count(self.params)

    def hidden(self, tokens) -> torch.Tensor:
        with torch.inference_mode():
            return hidden(self.params, self._tokens(tokens), self.cfg)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return logits(self.params, h, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, tokens, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with torch.inference_mode():
            return prefill(self.params, self._tokens(tokens), self.cfg,
                           max_len)

    def decode_step(self, cache: Dict[str, Any], tokens
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with torch.inference_mode():
            return decode_step(self.params, cache, self._tokens(tokens),
                               self.cfg)

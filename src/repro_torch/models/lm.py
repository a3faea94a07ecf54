"""Decoder-only causal LM in PyTorch (counterpart of the JAX package's
``models/lm.py``) for the dense, MoE, SSM (RWKV-6), hybrid (Mamba-2 plus
a shared attention block, Zamba2) and VLM (M-RoPE, a prefix of
precomputed vision embeds) families: the serving entry points
``prefill`` and ``decode_step``, and ``hidden`` / ``logits``.

The parameter tree is the JAX package's, with one difference: JAX's
stacked ``[L, ...]`` layer leaves become a list of per-layer dicts, and
the layers run in a Python loop where JAX scans.  The hybrid family's
``shared`` block stays one dict outside the list and runs after every
``attn_every``-th layer.  Each leaf keeps the dtype the JAX init gives it:
``cfg.dtype``, except the fp32 leaves named in ``FP32_LEAVES``.  The
cache has the JAX package's tree: ``pos [B]`` int32; ``k``/``v`` ``[L, B,
Hkv, S, dh]`` (dense); ``ssm`` with each state leaf stacked on L (SSM and
hybrid); ``shared_k``/``shared_v`` ``[napp, B, Hkv, S, dh]`` (hybrid).
``decode_step`` updates it in place.  The enc-dec family is
:class:`repro_torch.models.encdec.EncDecLM`, as in the JAX package.

Training: :func:`loss` is the JAX package's objective (mean token NLL,
a VLM's embeds prefix unlabelled).  With ``cfg.remat`` on and grad
enabled each layer (with the hybrid's shared block after it) runs under
``torch.utils.checkpoint``: its activations are recomputed in the
backward pass, as the JAX package's ``jax.checkpoint`` with
``nothing_saveable`` recomputes them.

Layouts: :func:`param_pspecs` and :func:`cache_pspecs` are the
reference's specs (a per-layer leaf's spec drops the reference's leading
``None`` of its ``[L, ...]`` stack; the cache keeps the stack).  With a
constraint mesh installed (:mod:`repro_torch.dist.sharding`) and a
DTensor parameter tree, every layer starts from the reference's
residual-stream layout (:func:`_boundary`), and the loss,
:func:`prefill` and :func:`decode_step` run sharded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P
from repro_torch.models import blocks as B
from repro_torch.models import common as C
from repro_torch.models import ssm as S
from repro_torch.models.common import ModelConfig
from repro_torch.vae.model import param_count

#: the families this model serves (the enc-dec family is ``EncDecLM``)
CAUSAL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")

#: parameter leaves the JAX init makes fp32 whatever ``cfg.dtype`` is:
#: RWKV-6's decay base and bonus, Mamba-2's decay, skip and step bias, and
#: the MoE router
FP32_LEAVES = frozenset({"w0", "u", "A_log", "D", "dt_bias", "router"})


def leaf_dtypes(params, cfg: ModelConfig, fn):
    """``fn(leaf, dtype)`` on every leaf of ``params``, with the dtype the
    JAX init gives a leaf of that name (``FP32_LEAVES`` fp32, the rest
    ``cfg.dtype``)."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        return fn(tree, torch.float32 if name in FP32_LEAVES else cfg.dtype)
    return walk(params, None)


def _hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.attn_every)


def _shared_slot(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The shared block's application index after layer ``idx``, or None
    where it is not applied."""
    if _hybrid(cfg) and idx % cfg.attn_every == cfg.attn_every - 1:
        return idx // cfg.attn_every
    return None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    ones = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)
    if cfg.ssm_type == "rwkv6":
        return {"ln1": ones, "ln2": ones.clone(),
                "mix": S.rwkv6_init(gen, cfg)}
    if cfg.ssm_type == "mamba2":
        return {"ln1": ones, "mix": S.mamba2_init(gen, cfg)}
    layer = {"ln1": ones, "attn": B.attn_init(gen, cfg), "ln2": ones.clone()}
    if cfg.family == "moe":
        layer["moe"] = B.moe_init(gen, cfg)
    else:
        layer["mlp"] = B.mlp_init(gen, cfg)
    return layer


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen``'s device at the JAX package's
    scales and dtypes: embed N(0, 0.02), dense weights N(0, 1/cin), norms
    1, biases 0; the SSM leaves as ``ssm.rwkv6_init`` / ``mamba2_init``,
    the experts as ``blocks.moe_init``."""
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
    if _hybrid(cfg):
        ones = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)
        params["shared"] = {"ln1": ones, "attn": B.attn_init(gen, cfg),
                            "ln2": ones.clone(), "mlp": B.mlp_init(gen, cfg)}
    return params


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def layer_pspecs(cfg: ModelConfig, model_axis: int) -> Dict[str, Any]:
    """One layer's specs (the reference's ``_layer_pspecs``)."""
    if cfg.ssm_type == "rwkv6":
        return {"ln1": P(None), "ln2": P(None),
                "mix": S.rwkv6_pspecs(cfg)}
    if cfg.ssm_type == "mamba2":
        return {"ln1": P(None), "mix": S.mamba2_pspecs(cfg)}
    layer = {"ln1": P(None), "attn": B.attn_pspecs(cfg), "ln2": P(None)}
    if cfg.family == "moe":
        layer["moe"] = B.moe_pspecs(cfg, model_axis)
    else:
        layer["mlp"] = B.mlp_pspecs(cfg)
    return layer


def param_pspecs(cfg: ModelConfig, model_axis: int = 16) -> Dict[str, Any]:
    """The parameter tree's specs: ``layers`` a list of per-layer specs
    (the reference's stacked leaf ``P(None, *spec)`` is ``spec`` here)."""
    specs: Dict[str, Any] = {
        "embed": P("model", None),
        "layers": [layer_pspecs(cfg, model_axis)
                   for _ in range(cfg.n_layers)],
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    if _hybrid(cfg):
        specs["shared"] = {"ln1": P(None), "attn": B.attn_pspecs(cfg),
                           "ln2": P(None), "mlp": B.mlp_pspecs(cfg)}
    return specs


def cache_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    """The cache's specs (stacked on L, as the cache is)."""
    c: Dict[str, Any] = {"pos": P("data")}
    if cfg.ssm_type:
        state = (S.rwkv6_state_pspecs(cfg) if cfg.ssm_type == "rwkv6"
                 else S.mamba2_state_pspecs(cfg))
        c["ssm"] = D.map_specs(lambda p: P(None, *p), state)
    else:
        # KV caches shard the SEQUENCE dim over 'model' (kv-head counts
        # are below the model-axis degree on most archs)
        c["k"] = P(None, "data", None, "model", None)
        c["v"] = P(None, "data", None, "model", None)
    if _hybrid(cfg):
        c["shared_k"] = P(None, "data", None, "model", None)
        c["shared_v"] = P(None, "data", None, "model", None)
    return c


def _boundary(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Residual-stream layout at block boundaries (the reference's).

    heads % TP == 0: batch-sharded, replicated over model (Megatron);
    otherwise sequence-sharded over model (Megatron-SP), so the
    sequence-parallel attention scores compose with it (a prompt length
    the axis does not divide stays whole)."""
    mesh = D.get_constraint_mesh()
    if mesh is None or x.ndim != 3:
        return x
    if cfg.n_heads % D.axis_size(mesh, "model") == 0:
        return D.constrain(x, "data", None, None)
    return D.constrain(x, "data", "model", None, loose=(1,))


# ---------------------------------------------------------------------------
# forward passes (plain functions on a parameter tree)
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig):
    return C.rms_norm(x, scale, cfg.norm_eps)


def _mlp_residual(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x + ffn(norm(x))``: the experts of a MoE layer, else the MLP."""
    if "moe" in p:
        return x + B.moe(p["moe"], _norm(x, p["ln2"], cfg), cfg)
    return x + B.mlp(p["mlp"], _norm(x, p["ln2"], cfg), cfg)


def _store_kv(kt: torch.Tensor, vt: torch.Tensor, k_dst: torch.Tensor,
              v_dst: torch.Tensor, cfg: ModelConfig) -> None:
    """Write a prefill's roped k/v ``[B, Hkv, S, dh]`` into cache slices.
    With a sliding window the cache keeps the last ``window`` positions,
    rolled into the ring-buffer slots that ``decode_step`` continues;
    later slots stay 0.  DTensor slices take the k/v in their own layout
    (the sequence over "model")."""
    s_total = kt.shape[2]
    w = cfg.sliding_window
    keep = min(s_total, w or s_total)
    kk, vv = kt[:, :, -keep:], vt[:, :, -keep:]
    if w and s_total > w:
        shift = s_total % w                      # ring-buffer alignment
        kk = torch.roll(kk, shift, dims=2)
        vv = torch.roll(vv, shift, dims=2)
    pad = (0, 0, 0, k_dst.shape[2] - keep)       # free slots for decode
    k_dst.copy_(F.pad(kk, pad))
    v_dst.copy_(F.pad(vv, pad))


def _attn_block(p, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, kv=None,
                layer: bool = True) -> torch.Tensor:
    """Pre-norm attention and MLP (or experts) over a full sequence: a
    dense, MoE or VLM ``layer``, or (``layer=False``) the hybrid's shared
    block, whose residual the reference leaves unconstrained.  ``kv`` =
    (k, v) cache slices take the roped k and v."""
    h, kt, vt = B.attention(p["attn"], _norm(x, p["ln1"], cfg), cfg,
                            positions)
    if kv is not None:
        _store_kv(kt, vt, kv[0], kv[1], cfg)
    x = x + h
    return _mlp_residual(p, _boundary(x, cfg) if layer else x, cfg)


def _attn_block_decode(p, x: torch.Tensor, cfg: ModelConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    h = B.attention_decode(p["attn"], _norm(x, p["ln1"], cfg), cfg,
                           k_cache, v_cache, pos)
    return _mlp_residual(p, x + h, cfg)


def _ssm_layer(p, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """``x + mixer(norm(x))``; RWKV-6's block holds its own channel mix
    (its ``ln2`` is unused, as in the JAX model)."""
    block = S.rwkv6_block if cfg.ssm_type == "rwkv6" else S.mamba2_block
    h, _ = block(p["mix"], _norm(x, p["ln1"], cfg), cfg, state)
    return x + h


def _layer_state(cache: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the SSM state cache (views: written in
    place)."""
    return {k: v[i] for k, v in cache["ssm"].items()}


def remat_on(cfg: ModelConfig) -> bool:
    """Whether a full pass recomputes its layers in the backward pass:
    ``cfg.remat`` with grad enabled (a serving pass keeps nothing)."""
    return cfg.remat and torch.is_grad_enabled()


def _layer(params, i: int, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor,
           cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Layer ``i``, then the shared block where it follows layer ``i``."""
    p = params["layers"][i]
    x = _boundary(x, cfg)
    if cfg.ssm_type:
        x = _ssm_layer(p, x, cfg,
                       None if cache is None else _layer_state(cache, i))
    else:
        x = _attn_block(p, x, cfg, positions,
                        None if cache is None
                        else (cache["k"][i], cache["v"][i]))
    app = _shared_slot(cfg, i)
    if app is not None:
        x = _attn_block(params["shared"], x, cfg, positions,
                        None if cache is None
                        else (cache["shared_k"][app],
                              cache["shared_v"][app]), layer=False)
    return x


def _forward(params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor,
             cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Every layer (and the shared block after every ``attn_every``-th)
    over a full sequence; with a cache, each layer's k/v or final SSM
    state goes into it.  Without one, under :func:`remat_on`, each layer
    is a checkpointed region."""
    remat = cache is None and remat_on(cfg)
    for i in range(len(params["layers"])):
        if remat:
            x = checkpoint(_layer, params, i, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _layer(params, i, x, cfg, positions, cache)
    return x


def embed_inputs(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input sequence [B, S, d]: precomputed frontend ``embeds`` (cast
    to ``cfg.dtype``) and then the tokens' embeddings."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(cfg.dtype))
    if tokens is not None:
        parts.append(C.embed_lookup(params["embed"], tokens))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def hidden(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
           embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids [B, S] (and/or frontend embeds, put first) -> final
    hidden states [B, S_total, d]."""
    x = embed_inputs(params, tokens, cfg, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return _norm(_forward(params, x, cfg, positions), params["final_norm"],
                 cfg)


def logits(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def loss(params, batch: Dict[str, torch.Tensor],
         cfg: ModelConfig) -> torch.Tensor:
    """The training objective: ``batch`` holds ``tokens`` [B, S] and
    ``labels`` [B, S] (and a VLM's ``vision_embeds`` [B, P, d], whose
    positions get label -1 and no loss) -> mean token NLL, fp32."""
    h = hidden(params, batch.get("tokens"), cfg, batch.get("vision_embeds"))
    # vocab-sharded logits gather their vocab for the loss's logsumexp
    lg = D.constrain(logits(params, h, cfg), "data", None, None)
    labels = batch["labels"]
    if lg.shape[1] != labels.shape[1]:            # frontend prefix: no loss
        pad = lg.shape[1] - labels.shape[1]
        labels = torch.cat([torch.full(labels.shape[:1] + (pad,), -1,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    return C.cross_entropy_loss(lg, labels)


def batch_on_device(batch, device) -> Dict[str, torch.Tensor]:
    """A training batch (numpy arrays or tensors) on ``device``: token ids
    and labels as int64, side inputs (``vision_embeds``, ``frames``) in
    their own dtype; DTensors (a batch already laid out on a mesh) as
    they are."""
    return {k: v if D.is_dtensor(v) else
            torch.as_tensor(v, device=device,
                            dtype=(torch.long if k in ("tokens", "labels")
                                   else None))
            for k, v in batch.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device, mesh=None) -> Dict[str, Any]:
    """The zero cache on ``device``; with a ``mesh``, DTensors laid out
    by :func:`cache_pspecs` (the axes that do not divide a dim dropped),
    each rank holding its own shard."""
    if mesh is not None:
        return D.zeros_tree(init_cache(cfg, batch, max_len, "meta"),
                            cache_pspecs(cfg), mesh)
    L = cfg.n_layers
    s = min(max_len, cfg.sliding_window or max_len)
    cache: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.ssm_type:
        init = (S.rwkv6_state_init if cfg.ssm_type == "rwkv6"
                else S.mamba2_state_init)
        cache["ssm"] = {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype,
                                       device=device)
                        for k, v in init(cfg, batch, "meta").items()}
    else:
        k = torch.zeros((L, batch, cfg.n_kv_heads, s, cfg.head_dim),
                        dtype=cfg.dtype, device=device)
        cache["k"], cache["v"] = k, torch.zeros_like(k)
    if _hybrid(cfg):
        napp = cfg.n_layers // cfg.attn_every
        k = torch.zeros((napp, batch, cfg.n_kv_heads, s, cfg.head_dim),
                        dtype=cfg.dtype, device=device)
        cache["shared_k"], cache["shared_v"] = k, torch.zeros_like(k)
    return cache


def prefill(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits for the last position [B, V], filled cache).

    ``embeds`` (the VLM's vision prefix) go before the tokens; positions
    run over both, and ``pos`` ends at the total length.  ``max_len``
    sizes the KV caches (>= that length) so decode steps have free slots;
    defaults to that length.  The SSM state does not depend on it.

    On DTensor parameters (their mesh installed as the constraint mesh)
    the inputs' rows go over the data axes, every layer runs in the
    reference's layouts, and logits and cache come back as DTensors: the
    logits over (data axes, "model"), the cache laid out by
    :func:`cache_pspecs`, in both the axes that do not divide a dim
    dropped, as the reference launcher's ``validate_divisibility`` does."""
    mesh = D.mesh_of(params["embed"])
    with D.on_mesh(mesh):
        if mesh is not None:
            inputs = D.distribute_batch({k: v for k, v in (
                ("tokens", tokens), ("embeds", embeds)) if v is not None},
                mesh)
            tokens, embeds = inputs.get("tokens"), inputs.get("embeds")
        x = embed_inputs(params, tokens, cfg, embeds)
        b, s_total, _ = x.shape
        max_len = max(max_len or s_total, s_total)
        positions = torch.arange(s_total, device=x.device)[None].expand(
            b, s_total)
        cache = init_cache(cfg, b, max_len, x.device, mesh)
        x = _forward(params, x, cfg, positions, cache)
        cache["pos"].fill_(s_total)
        h = _norm(x[:, -1], params["final_norm"], cfg)
        lg = logits(params, h, cfg)
        if mesh is not None:
            lg = D.lay_out(lg, P(D.dp_axes(mesh), "model"))
    return lg, cache


def decode_step(params, cache: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B] -> (logits [B, V], the cache, updated in place).

    On DTensor parameters and a cache laid out by :func:`cache_pspecs`
    (as :func:`prefill` leaves it) the tokens' rows go over the data
    axes, each attention layer writes its token into the rank that owns
    the slot and merges the ranks' partial attention
    (``blocks.decode_attention_sharded``), the SSM state stays on each
    rank's heads, and the logits come back over (data axes, "model")."""
    mesh = D.mesh_of(params["embed"])
    with D.on_mesh(mesh):
        if mesh is not None:
            tokens = D.distribute_batch({"tokens": tokens}, mesh)["tokens"]
        pos = cache["pos"]
        x = C.embed_lookup(params["embed"], tokens)[:, None, :]   # [B, 1, d]
        for i, p in enumerate(params["layers"]):
            if cfg.ssm_type:
                x = _ssm_layer(p, x, cfg, _layer_state(cache, i))
            else:
                x = _attn_block_decode(p, x, cfg, cache["k"][i],
                                       cache["v"][i], pos)
            app = _shared_slot(cfg, i)
            if app is not None:
                x = _attn_block_decode(params["shared"], x, cfg,
                                       cache["shared_k"][app],
                                       cache["shared_v"][app], pos)
        cache["pos"] = pos + 1
        h = _norm(x[:, 0], params["final_norm"], cfg)
        lg = logits(params, h, cfg)
        if mesh is not None:
            lg = D.lay_out(lg, P(D.dp_axes(mesh), "model"))
    return lg, cache


# ---------------------------------------------------------------------------
# the model on one device
# ---------------------------------------------------------------------------

class CausalLM:
    """Config + parameters on one device, and the serving entry points.

    ``params`` (a tree of tensors with per-layer dicts, e.g. from
    :func:`repro_torch.models.bridge.lm_from_numpy`) replaces the seeded
    random initialisation, which draws from a ``torch.Generator`` on the
    target device.  Each leaf is cast to the dtype the JAX init gives it
    (:func:`leaf_dtypes`).  ``device`` defaults to ``"cuda"`` and raises
    where CUDA is absent; pass ``device="cpu"`` for the plain path.  Every
    serving entry point runs under ``torch.inference_mode()`` and takes
    token ids (and a VLM's ``embeds`` [B, P, d]) as anything
    ``torch.as_tensor`` reads.  The parameters are made under
    ``torch.no_grad()``, not as inference tensors, so that training can
    differentiate them in place (:meth:`loss`,
    :mod:`repro_torch.train.train_step`).
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None):
        if cfg.family not in CAUSAL_FAMILIES:
            raise ValueError(f"{cfg.name}: CausalLM serves the families "
                             f"{CAUSAL_FAMILIES}, not {cfg.family!r} (the "
                             "enc-dec family is models.encdec.EncDecLM)")
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.no_grad():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    int(seed))
                params = init_params(gen, cfg)
            self.params = leaf_dtypes(params, cfg, lambda t, dt: t.to(
                device=self.device, dtype=dt).contiguous())

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    @property
    def n_params(self) -> int:
        return param_count(self.params)

    def _inputs(self, tokens, embeds):
        return (None if tokens is None else self._tokens(tokens),
                None if embeds is None
                else torch.as_tensor(embeds, device=self.device))

    def hidden(self, tokens=None, embeds=None) -> torch.Tensor:
        with torch.inference_mode():
            toks, emb = self._inputs(tokens, embeds)
            return hidden(self.params, toks, self.cfg, emb)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return logits(self.params, h, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return init_cache(self.cfg, batch, max_len, self.device)

    def _layer_pspecs(self, model_axis: int) -> Dict[str, Any]:
        return layer_pspecs(self.cfg, model_axis)

    def param_pspecs(self, model_axis: int = 16) -> Dict[str, Any]:
        return param_pspecs(self.cfg, model_axis)

    def cache_pspecs(self) -> Dict[str, Any]:
        return cache_pspecs(self.cfg)

    def prefill(self, tokens=None, max_len: Optional[int] = None,
                embeds=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with D.serving_mode(self.params["embed"]):
            toks, emb = self._inputs(tokens, embeds)
            return prefill(self.params, toks, self.cfg, max_len, emb)

    def decode_step(self, cache: Dict[str, Any], tokens
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        with D.serving_mode(self.params["embed"]):
            return decode_step(self.params, cache, self._tokens(tokens),
                               self.cfg)

    def batch_on_device(self, batch) -> Dict[str, torch.Tensor]:
        return batch_on_device(batch, self.device)

    def loss(self, batch, params=None) -> torch.Tensor:
        """:func:`loss` of ``params`` (default: the model's own) on
        ``batch`` (numpy or tensors), under the caller's grad mode."""
        return loss(self.params if params is None else params,
                    self.batch_on_device(batch), self.cfg)

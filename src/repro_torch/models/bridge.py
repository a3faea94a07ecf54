"""Parameter bridge from the JAX package's causal LM to the port.

The JAX ``CausalLM.init`` tree, exported as numpy
(``jax.tree_util.tree_map(np.asarray, params)``), has the port's leaves
and layouts (``[in, out]`` dense weights, so both stacks compute
``x @ w``); its stacked ``[L, ...]`` layer leaves are split along the
layer axis into the port's list of per-layer dicts, and the hybrid's
``shared`` block stays whole.  Leaves come over exactly (through fp32,
which holds every bf16 value) and :class:`CausalLM` then gives each the
dtype the JAX init gives it, so an fp32 leaf (RWKV-6's ``w0`` and ``u``,
Mamba-2's ``A_log``, ``D`` and ``dt_bias``) never passes through
``cfg.dtype``.  The enc-dec tree (the JAX ``EncDecLM.init``) splits
its ``enc_layers`` and ``dec_layers`` the same way::

    lm_from_numpy(cfg, tree, device=...)
    encdec_from_numpy(cfg, tree, device=...)

:func:`to_numpy` goes the other way, for a tree of parameters or of
their gradients: each list of per-layer trees is stacked back into the
JAX package's ``[L, ...]`` leaves, as numpy (floating leaves in fp32,
which holds every bf16 value).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import CausalLM
from repro_torch.vae.bridge import params_from_numpy
from repro_torch.vae.model import map_params


def lm_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                  device=None) -> CausalLM:
    """A port :class:`CausalLM` on ``device`` (``"cuda"`` unless the
    caller asks for the CPU) holding the exported tree."""
    dev = resolve_device(device)
    params = _split(params_from_numpy(tree, device=dev), "layers",
                    cfg.n_layers)
    return CausalLM(cfg, device=dev, params=params)


def encdec_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device=None) -> EncDecLM:
    """A port :class:`EncDecLM` on ``device`` (``"cuda"`` unless the
    caller asks for the CPU) holding the exported tree; ``pos_embed``'s
    rows set its ``max_target_positions``."""
    dev = resolve_device(device)
    params = params_from_numpy(tree, device=dev)
    params = _split(params, "enc_layers", cfg.encoder_layers)
    params = _split(params, "dec_layers", cfg.n_layers)
    return EncDecLM(cfg, device=dev, params=params,
                    max_target_positions=params["pos_embed"].shape[0])


def _split(params: Dict[str, Any], key: str, n: int) -> Dict[str, Any]:
    """``params[key]``'s stacked ``[n, ...]`` leaves -> a list of ``n``
    per-layer trees."""
    stacked = params[key]
    params[key] = [map_params(stacked, lambda t, i=i: t[i]) for i in range(n)]
    return params


def to_numpy(tree) -> Any:
    """A port tree (dicts, per-layer lists, tensors) -> the JAX package's
    layout as numpy: every list of layer trees becomes one tree of
    ``[L, ...]`` leaves; floating tensors come over in fp32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        layers = [to_numpy(v) for v in tree]
        return _stack(layers)
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack(layers)

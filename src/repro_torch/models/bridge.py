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
``cfg.dtype``::

    lm_from_numpy(cfg, tree, device=...)
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import CausalLM
from repro_torch.vae.bridge import params_from_numpy
from repro_torch.vae.model import map_params


def lm_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                  device=None) -> CausalLM:
    """A port :class:`CausalLM` on ``device`` (``"cuda"`` unless the
    caller asks for the CPU) holding the exported tree."""
    dev = resolve_device(device)
    params = params_from_numpy(tree, device=dev)
    stacked = params["layers"]
    params["layers"] = [map_params(stacked, lambda t, i=i: t[i])
                        for i in range(cfg.n_layers)]
    return CausalLM(cfg, device=dev, params=params)

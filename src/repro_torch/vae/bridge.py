"""Parameter bridge from the JAX package's decoder to the port.

The JAX decoder's parameter tree, exported as nested dicts/lists of numpy
arrays (``jax.tree_util.tree_map(np.asarray, vae.decoder)``), already has
the port's structure and layouts (HWIO conv weights, ``[in, out]`` dense
weights), so the bridge converts leaves and nothing else.  The port's
:class:`~repro_torch.vae.model.VAE` built from it computes the same
function as the JAX one::

    VAE(cfg, params=params_from_numpy(tree), device=...)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.vae.model import map_params


def params_from_numpy(tree: Dict[str, Any], device="cpu",
                      dtype=torch.float32) -> Dict[str, Any]:
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    return map_params(tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device=device, dtype=dtype))

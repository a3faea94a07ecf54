"""Parameter bridge from the JAX package's VAE to the port.

The JAX decoder's and encoder's parameter trees, exported as nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray,
vae.decoder)``, and the same for ``vae.encoder``), already have the
port's structure and layouts (HWIO conv weights, ``[in, out]`` dense
weights), so the bridge converts leaves and nothing else: both trees go
through the same :func:`params_from_numpy`.  The port's
:class:`~repro_torch.vae.model.VAE` built from them computes the same
functions as the JAX one::

    vae_from_numpy(cfg, decoder_tree, encoder_tree, device=...)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.vae.model import VAE, VAEConfig, map_params


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype=torch.float32) -> Dict[str, Any]:
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return map_params(tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype))


def vae_from_numpy(cfg: VAEConfig, decoder: Dict[str, Any],
                   encoder: Optional[Dict[str, Any]] = None,
                   device=None) -> VAE:
    """A port :class:`VAE` on ``device`` (``"cuda"`` unless the caller
    asks for the CPU) holding the exported decoder tree and, if given,
    the encoder tree (no encoder otherwise)."""
    dev = resolve_device(device)
    return VAE(cfg, device=dev, params=params_from_numpy(decoder, dev),
               with_encoder=encoder is not None,
               encoder_params=(params_from_numpy(encoder, dev)
                               if encoder is not None else None))

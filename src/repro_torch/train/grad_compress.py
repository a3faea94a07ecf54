"""Int8 error-feedback gradient compression (counterpart of the JAX
package's ``train/grad_compress.py``).

Each gradient leaf is quantized to int8 with a per-tensor fp32 scale
(max |g| / 127; a per-layer list shares each leaf's scale across its
layers, as the reference's stacked ``[L, ...]`` leaf does) and
dequantized; the residual is carried to the next
step in an fp32 error-feedback buffer, so the bias vanishes over steps
(Seide et al.; EF-SGD).  On one card nothing crosses a link: the
round trip is the arithmetic a cross-pod reduction of the codes would
see.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.train.tree import tree_map


def quantize_int8(g: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale) of ``g`` at the scale of ``amax``
    (default: its own max |g|)."""
    gf = g.float()
    amax = gf.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _amax(tree):
    """Each leaf's max |value|; across a list of per-layer trees one
    value per leaf name, the max over the layers: the JAX package's
    tensor there is the stacked ``[L, ...]`` leaf, so its scale is
    shared by the layers."""
    if isinstance(tree, dict):
        return {k: _amax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        per = [_amax(v) for v in tree]
        shared = tree_map(lambda *xs: torch.stack(xs).max(), *per)
        return [shared] * len(per)
    return tree.abs().max()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, error: Optional[Any] = None):
    """((int8 codes tree, fp32 scale tree), new error tree): quantize(g +
    e), with the residual fed back."""
    if error is None:
        error = ef_init(grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    qs = tree_map(quantize_int8, corrected, _amax(corrected))
    q_tree = tree_map(lambda c, t: t[0], corrected, qs)
    s_tree = tree_map(lambda c, t: t[1], corrected, qs)
    recon = tree_map(dequantize_int8, q_tree, s_tree)
    new_error = tree_map(lambda c, r: c - r, corrected, recon)
    return (q_tree, s_tree), new_error


def decompress_tree(q_tree, s_tree):
    return tree_map(dequantize_int8, q_tree, s_tree)

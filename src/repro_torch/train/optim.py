"""AdamW by hand (counterpart of the JAX package's ``train/optim.py``):
decoupled weight decay, global-norm clipping, cosine / linear / constant
schedules with warmup.

The arithmetic is the reference's, in its order, per leaf in fp32: the
moments, the bias corrections from the incremented step, ``delta = mhat
/ (sqrt(vhat) + eps) + weight_decay * p`` and ``p - lr * delta`` cast
back to the parameter's dtype; moments stored in ``moment_dtype``.  The
step, the learning rate and the corrections stay 0-dim fp32 tensors on
the device, so an update makes no host sync.  ``torch.optim.AdamW``
orders the decay and the clipping otherwise, so it is not used.

Where the reference returns new trees, :meth:`AdamW.update` writes the
new parameters and moments into the tensors it was given (and clips the
gradients in place) and returns those same trees: a model the size of
the card's memory has no room for a second copy.

Sharded: parameters, gradients and moments may be DTensors.  The
moments' layout may differ from the parameters' (ZeRO-1: a moment
replicated over the data axis in the parameter is sharded over it
here, ``dist.sharding.opt_state_pspecs(zero1=True)``); each rank then
updates its moments' shard and the matching slice of the parameter, and
the new parameter is all-gathered back to its own layout, as the
reference's ``out_shardings = in_shardings`` lays it out.  The global
norm sums each leaf's local squares and reduces the sums (``Partial``
to ``Replicate``), never a whole leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist import sharding as D
from repro_torch.train.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32, 0-dim
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine|linear|constant
    moment_dtype: str = "float32"     # 'bfloat16' halves optimizer memory


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32: linear warmup over
    ``warmup_steps``, then the schedule's decay to ``total_steps``."""
    s = step.float()
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones((), dtype=torch.float32, device=step.device)
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, the leaves'
    sums added one after another in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    top = torch.full_like(norm, max_norm)
    return torch.clamp(top / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(the tree scaled to a global norm of at most ``max_norm``, each
    leaf in its own dtype; the norm before)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _dzeros(params, specs, dtype):
    """DTensor zeros shaped as the DTensor tree ``params``, laid out by
    the spec tree ``specs`` (default: each parameter's layout)."""
    from torch.distributed.tensor import zeros
    if isinstance(params, dict):
        return {k: _dzeros(v, None if specs is None else specs[k], dtype)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_dzeros(v, None if specs is None else s, dtype)
                            for v, s in zip(params, specs or [None] *
                                            len(params)))
    mesh = params.device_mesh
    pl = params.placements if specs is None else \
        D.placements(specs, mesh, params.shape)
    return zeros(tuple(params.shape), dtype=dtype, device_mesh=mesh,
                 placements=pl)


class AdamW:
    """init(params) -> state; update(grads, state, params) -> (params,
    state, metrics), written in place."""

    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    def init(self, params, moment_specs=None) -> AdamWState:
        """Zero moments in ``moment_dtype``.  For a DTensor tree each
        moment is a DTensor on the parameters' mesh, laid out by
        ``moment_specs`` (an ``OptStatePSpecs``; default: each
        parameter's own layout)."""
        mdt = getattr(torch, self.cfg.moment_dtype)
        first = leaves(params)[0]
        if D.is_dtensor(first):
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32,
                                 device=first.to_local().device),
                m=_dzeros(params, None if moment_specs is None
                          else moment_specs.m, mdt),
                v=_dzeros(params, None if moment_specs is None
                          else moment_specs.v, mdt))
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=first.device),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        if D.is_dtensor(leaves(params)[0]):
            # the step, lr and corrections stay plain 0-dim tensors
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                return self._update(grads, state, params)
        return self._update(grads, state, params)

    def _update(self, grads, state: AdamWState, params
                ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        metrics: Dict[str, torch.Tensor] = {}
        flat_g = leaves(grads)
        if cfg.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = _clip_scale(gnorm, cfg.clip_norm)
            for g in flat_g:
                g.copy_((g.float() * scale).to(g.dtype))
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        lr = schedule_lr(cfg, step)
        metrics["lr"] = lr
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(b1, step.float())
        bc2 = 1.0 - torch.pow(b2, step.float())
        mdt = getattr(torch, cfg.moment_dtype)
        for p, g, m, v in zip(leaves(params), flat_g, leaves(state.m),
                              leaves(state.v)):
            # ZeRO-1: this rank's slice of the parameter, as its moments
            ps = p.redistribute(m.device_mesh, m.placements) \
                if D.is_dtensor(m) and m.placements != p.placements else p
            gf = g.float()
            m2 = b1 * m.float() + (1 - b1) * gf
            v2 = b2 * v.float() + (1 - b2) * gf * gf
            mhat = m2 / bc1
            vhat = v2 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * ps.float()
            new = (ps.float() - lr * delta).to(p.dtype)
            if ps is not p:                     # all-gather the slices
                new = new.redistribute(p.device_mesh, p.placements)
            p.copy_(new)
            m.copy_(m2.to(mdt))
            v.copy_(v2.to(mdt))
        return params, AdamWState(step, state.m, state.v), metrics

"""Train-step factory (counterpart of the JAX package's
``train/train_step.py``): microbatched gradient accumulation, the
model's remat'd layers, optional int8 error-feedback gradient
compression, AdamW.

The returned function has the reference's signature::

    train_step(params, opt_state, ef_state, batch)
        -> (params, opt_state, ef_state, metrics)

The batch (numpy or tensors, leading axis the batch) is split into
``microbatches`` equal slices; each slice's loss is differentiated
with ``torch.autograd.grad`` and its gradients added into a
``grad_dtype`` buffer (fp32 by default, never the bf16 parameters'
``.grad``), and loss and gradients are divided by the slice count.  With
one microbatch the gradients keep the parameters' dtype, as the
reference's ``value_and_grad`` gives them.  Then compression, then
:meth:`AdamW.update`, which writes ``params`` and the moments in place.
``metrics`` holds 0-dim tensors on the device (``loss``, ``lr`` and,
with clipping, ``grad_norm``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.train import grad_compress as GC
from repro_torch.train.optim import AdamW
from repro_torch.train.tree import leaves, map_with_paths, paths

#: what the sharded gradient and parameter layouts wait for
DIST = "sharded training layouts are not ported yet (ROADMAP A 16, dist)"


def make_train_step(model, optimizer: AdamW, microbatches: int = 1,
                    compress_grads: bool = False,
                    grad_dtype=torch.float32, grad_shardings=None,
                    param_gather_shardings=None) -> Callable:
    """``model`` is a :class:`~repro_torch.models.lm.CausalLM` or
    :class:`~repro_torch.models.encdec.EncDecLM` (its ``loss(batch,
    params)``); ``params`` are trees on its device."""
    if grad_shardings is not None or param_gather_shardings is not None:
        raise NotImplementedError(DIST)

    def grads_of(params, flat, batch):
        loss = model.loss(batch, params)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt_state, ef_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = model.batch_on_device(batch)
        with torch.enable_grad():
            if microbatches > 1:
                rows = {v.shape[0] for v in batch.values()}
                if any(r % microbatches for r in rows):
                    raise ValueError(f"batch rows {sorted(rows)} do not "
                                     f"split into {microbatches} "
                                     "microbatches")
                slices = {k: v.chunk(microbatches) for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=flat[0].device)
                acc = [torch.zeros(p.shape, dtype=grad_dtype,
                                   device=p.device) for p in flat]
                for i in range(microbatches):
                    mb = {k: v[i] for k, v in slices.items()}
                    mb_loss, grads = grads_of(params, flat, mb)
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    del grads
                    loss = loss + mb_loss
                loss = loss / microbatches
                for a in acc:
                    a.div_(microbatches)
            else:
                loss, acc = grads_of(params, flat, batch)
        by_path = dict(zip(paths(params), acc))
        grads = map_with_paths(lambda path, _: by_path[path], params)
        if compress_grads:
            with record_function("grad_compress"):
                (q, s), ef_state = GC.compress_tree(grads, ef_state)
                grads = GC.decompress_tree(q, s)
        with record_function("adamw"):
            params, opt_state, metrics = optimizer.update(grads, opt_state,
                                                          params)
        metrics["loss"] = loss
        return params, opt_state, ef_state, metrics

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(batch, params)
    return eval_step

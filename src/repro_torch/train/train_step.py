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
``grad_dtype`` buffer (a copy of the first slice's, fp32 by default,
never the bf16 parameters' ``.grad``), and loss and gradients are divided by the slice count.  With
one microbatch the gradients keep the parameters' dtype, as the
reference's ``value_and_grad`` gives them.  Then compression, then
:meth:`AdamW.update`, which writes ``params`` and the moments in place.
``metrics`` holds 0-dim tensors on the device (``loss``, ``lr`` and,
with clipping, ``grad_norm``).

On DTensor trees (a device mesh, :mod:`repro_torch.dist.sharding`) the
same step runs sharded: see :func:`make_train_step`.  The layouts pin
nothing on a plain tree, which has none.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.dist import sharding as D
from repro_torch.train import grad_compress as GC
from repro_torch.train.optim import AdamW
from repro_torch.train.tree import leaves, map_with_paths, paths


def _acc_placements(g, spec, mesh):
    """The accumulator's placements for a gradient ``g`` under its spec
    in ``grad_shardings``: a mesh axis the spec names shards its dim (a
    dp axis there is reduce-scattered onto, after every microbatch); a
    dp axis it leaves out keeps ``g``'s placement (``Partial``: the
    partial sums stay local until the optimizer boundary); any other
    axis it leaves out is replicated."""
    from torch.distributed.tensor import Replicate
    dp = D.dp_axes(mesh)
    dp = dp if isinstance(dp, tuple) else (dp,)
    out = []
    for name, n, gp in zip(D.axis_names(mesh),
                           D.placements(spec, mesh, g.shape), g.placements):
        out.append(n if n.is_shard() else gp if name in dp else Replicate())
    return out


def make_train_step(model, optimizer: AdamW, microbatches: int = 1,
                    compress_grads: bool = False,
                    grad_dtype=torch.float32, grad_shardings=None,
                    param_gather_shardings=None) -> Callable:
    """``model`` is a :class:`~repro_torch.models.lm.CausalLM` or
    :class:`~repro_torch.models.encdec.EncDecLM` (its ``loss(batch,
    params)``); ``params`` are trees on its device.

    Sharded: ``params`` and ``opt_state`` may be DTensor trees, laid out
    by ``param_pspecs`` and ``dist.sharding.opt_state_pspecs`` (ZeRO-1
    with ``zero1=True``), with the constraint mesh installed
    (``dist.sharding.set_constraint_mesh``).  The batch (numpy or plain
    tensors, the global batch) is cut into microbatches, each laid out
    by ``dist.sharding.distribute_batch`` (its rows over the data axes).
    ``grad_shardings`` is a tree of specs (:class:`~repro_torch.dist.
    sharding.P`) in the parameters' structure pinning the gradient
    accumulator after every microbatch (:func:`_acc_placements`): with
    the dp axes stripped (the reference's "local" plan) the partial sums
    stay local and are reduced once, at the optimizer boundary; with dp
    axes named (its "sharded" plan) they are reduce-scattered after
    every microbatch.  At the boundary each gradient takes its moment's
    layout: a reduce-scatter into ZeRO-1's data-sharded moments, an
    all-reduce where the moment is replicated.
    ``param_gather_shardings`` (a spec tree) re-lays the parameters out
    once before the microbatch loop (FSDP's gather-once); the gradients
    are taken there."""
    def grads_of(params, flat, batch):
        loss = model.loss(batch, params)
        if D.is_dtensor(loss):                  # the global mean
            loss = D.replicate(loss)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt_state, ef_state, batch):
        mesh = D.mesh_of(leaves(params)[0])
        with D.on_mesh(mesh):
            compute = params
            if mesh is not None and param_gather_shardings is not None:
                with record_function("param_gather"):
                    compute = D.relayout_tree(params, param_gather_shardings,
                                              mesh)
            flat = leaves(compute)
            for p in flat:
                p.requires_grad_(True)
            gspecs = None if mesh is None or grad_shardings is None else \
                D.spec_leaves(grad_shardings)
            batch = model.batch_on_device(batch)
            slices = _split(batch) if microbatches > 1 else [batch]
            loss, acc = None, None
            with torch.enable_grad():
                for mb in slices:
                    if mesh is not None:
                        mb = D.distribute_batch(mb, mesh)
                    mb_loss, grads = grads_of(compute, flat, mb)
                    if acc is not None:
                        for a, g in zip(acc, grads):
                            D.add_into(a, g)
                    else:
                        acc = grads if microbatches == 1 else \
                            [g.to(grad_dtype, copy=True) for g in grads]
                        if gspecs is not None:
                            acc = [a.redistribute(
                                mesh, _acc_placements(a, sp, mesh))
                                for a, sp in zip(acc, gspecs)]
                    del grads
                    loss = mb_loss if loss is None else loss + mb_loss
            if microbatches > 1:
                loss = loss / microbatches
                for a in acc:
                    a.div_(microbatches)
            if mesh is not None:
                with record_function("grad_reduce"):
                    acc = [a.redistribute(mesh, m.placements)
                           for a, m in zip(acc, leaves(opt_state.m))]
            params, opt_state, ef_state, metrics = finish(
                params, opt_state, ef_state, acc, loss)
        return params, opt_state, ef_state, {
            k: v.full_tensor() if D.is_dtensor(v) else v
            for k, v in metrics.items()}

    def _split(batch):
        rows = {v.shape[0] for v in batch.values()}
        if any(r % microbatches for r in rows):
            raise ValueError(f"batch rows {sorted(rows)} do not split into "
                             f"{microbatches} microbatches")
        chunks = {k: v.chunk(microbatches) for k, v in batch.items()}
        return [{k: v[i] for k, v in chunks.items()}
                for i in range(microbatches)]

    def finish(params, opt_state, ef_state, acc, loss):
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

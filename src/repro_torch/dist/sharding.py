"""Layouts over a device mesh (counterpart of the JAX package's
``dist/sharding.py``), on PyTorch's ``DeviceMesh`` and DTensor.

A layout is a :class:`P`, the port's own ``PartitionSpec``: one entry per
tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of axis
names (the dim split over several mesh axes, major first).
:func:`placements` turns it into DTensor placements, one per mesh dim;
:func:`distribute_tree` lays a parameter tree out by a tree of specs.

The model code pins residual-stream and attention layouts through a
process-global "constraint mesh", as the reference does: ``None`` (the
default) turns every :func:`constrain` into the identity, so one device
runs unchanged; a launcher that builds a mesh calls
:func:`set_constraint_mesh` once, and ``constrain`` on a DTensor becomes
``x.redistribute(mesh, placements(...))``.  Axis names the mesh lacks, or
has at extent 1, drop to ``None``, so the same model code runs under
data-only, model-only or 2D meshes.

The kernels take plain tensors through ``ctypes`` (a DTensor has no
``data_ptr``): :func:`local_shard` and :func:`from_local_like` hand them
each rank's shard of a layout whose slices are independent (head-local
or sequence-local attention, head-local RWKV-6) and wrap the result back,
with the gradients of replicated inputs marked ``Partial``.

Unlike DTensor, a dim that its mesh axes do not divide raises
(:func:`placements` given a shape, :func:`constrain`): uneven shards
would give layouts the reference cannot have.  Where a shape is not the
caller's choice (a batch of one, a prompt's length, a cache shorter
than the model axis), :func:`fit_spec` drops the axes that do not
divide, as the reference launcher's ``validate_divisibility`` does:
:func:`zeros_tree`, :func:`lay_out` and :func:`distribute_batch` always,
:func:`constrain` for a dim smaller than its axes' extent or one the
caller lists.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

_CONSTRAINT_MESH = None


class P(tuple):
    """A partition spec: a tuple of entries (None, an axis name, or a
    tuple of axis names) that compares equal to the JAX package's
    ``PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn: Callable, tree):
    """``fn(spec)`` on every :class:`P` of a tree of dicts and lists."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def set_constraint_mesh(mesh):
    """Install (or clear, with ``None``) the process-global constraint
    mesh, a ``DeviceMesh`` with named dims."""
    global _CONSTRAINT_MESH
    _CONSTRAINT_MESH = mesh
    return mesh


def get_constraint_mesh():
    return _CONSTRAINT_MESH


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    """The extent of mesh axis ``axis`` (1 where the mesh lacks it)."""
    names = axis_names(mesh)
    return mesh.size(names.index(axis)) if axis in names else 1


def _resolve_axis(mesh, axis) -> Optional[str]:
    if axis is None:
        return None
    if axis in axis_names(mesh) and axis_size(mesh, axis) > 1:
        return axis
    return None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh, shape=None) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names that axis, else
    ``Replicate()``; dims past the spec's end are replicated.  A tuple
    entry shards its dim over several mesh dims
    in the tuple's order, which must be the mesh's.  With ``shape``, a
    dim that its axes' extents do not divide raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which "
                                 f"the mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec!r}: the axes {axes} of dim {d} "
                             f"must follow the mesh's order {names}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec!r} uses axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
        if shape is not None:
            ways = 1
            for i in idx:
                ways *= mesh.size(i)
            if shape[d] % ways:
                raise ValueError(
                    f"dim {d} of size {shape[d]} does not split evenly over "
                    f"the axes {axes} ({ways} ways) of spec {spec!r}")
    return out


def fit_spec(spec: Sequence, shape, mesh) -> P:
    """``spec`` padded with ``None`` to ``len(shape)`` entries, each dim
    keeping only the mesh axes (in order) whose extents divide it, and
    no axis the mesh lacks (the reference launcher's
    ``validate_divisibility``: a batch of one, a cache shorter than the
    model axis)."""
    names = axis_names(mesh)
    out = []
    for d, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        keep, ways = [], 1
        for a in _axes_of(entry):
            if a in names and shape[d] % (ways * axis_size(mesh, a)) == 0:
                keep.append(a)
                ways *= axis_size(mesh, a)
        out.append(tuple(keep) if len(keep) > 1 else
                   keep[0] if keep else None)
    return P(*out)


def zeros_tree(tree, specs, mesh):
    """DTensors of zeros in the shapes and dtypes of ``tree`` (dicts and
    lists; tensors on the meta device will do), laid out by ``specs``
    retargeted to the mesh (:func:`retarget_pspec`) and fitted to each
    shape (:func:`fit_spec`): each rank allocates only its own shard, on
    the mesh's device."""
    if isinstance(tree, dict):
        return {k: zeros_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [zeros_tree(v, s, mesh) for v, s in zip(tree, specs,
                                                      strict=True)]
    spec = fit_spec(retarget_pspec(specs, mesh), tree.shape, mesh)
    pl = placements(spec, mesh, tree.shape)
    local = list(tree.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else
              torch.device(mesh.device_type))
    return from_local(torch.zeros(local, dtype=tree.dtype, device=device),
                      mesh, pl, tree.shape)


def mesh_of(t):
    """The mesh of a DTensor ``t`` (a parameter), which must be the
    installed constraint mesh; None for a plain tensor."""
    if not is_dtensor(t):
        return None
    mesh = _CONSTRAINT_MESH
    if mesh is None or t.device_mesh != mesh:
        raise ValueError("DTensor parameters need their mesh installed as "
                         "the constraint mesh (set_constraint_mesh)")
    return mesh


def lay_out(x, spec: Sequence):
    """DTensor ``x`` laid out by ``spec`` on its mesh, the axes that do not
    divide a dim dropped (:func:`fit_spec`)."""
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(fit_spec(spec, x.shape, mesh),
                                           mesh, x.shape))


def on_mesh(mesh):
    """The context a step over ``mesh`` runs in: plain tensors meeting
    DTensors count as replicated.  Nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def serving_mode(t):
    """The grad mode a serving entry point runs its parameter ``t``'s tree
    in: ``torch.inference_mode()``, or ``torch.no_grad()`` for a DTensor,
    of which no view can be taken in inference mode (the parameters are
    not inference tensors)."""
    return torch.no_grad() if is_dtensor(t) else torch.inference_mode()


def distribute_batch(batch, mesh):
    """Batch inputs (a dict of plain tensors) as DTensors, the leading dim
    over the data-parallel axes where they divide it (each rank has the
    whole batch and keeps its rows)."""
    specs = batch_pspecs_for(mesh, batch)
    return distribute_tree(batch, {k: fit_spec(specs[k], v.shape, mesh)
                                   for k, v in batch.items()}, mesh)


def constrain(x, *axes, loose: Sequence[int] = ()):
    """Constrain ``x`` to ``P(*axes)`` on the constraint mesh.

    The identity when no mesh is installed, or when ``x`` is a plain
    tensor (it carries no layout).  The gradient takes the same layout.
    ``axes`` has one entry per dim of ``x``; entries naming axes the mesh
    lacks (or has at extent 1) collapse to replication.  An axis whose
    extent does not divide its dim raises, unless the dim is smaller than
    that extent (a batch of one, a microbatch of one row) or is listed in
    ``loose`` (a prompt's sequence, whose length the caller does not
    choose): those collapse to replication too (:func:`fit_spec`)."""
    mesh = _CONSTRAINT_MESH
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(
            f"constrain: got {len(axes)} axes for rank-{x.ndim} array")
    if not is_dtensor(x):
        return x
    want = [_resolve_axis(mesh, a) for a in axes]
    spec = fit_spec(want, x.shape, mesh)
    for d, (w, got) in enumerate(zip(want, spec)):
        ways = 1
        for a in _axes_of(w):
            ways *= axis_size(mesh, a)
        if w != got and d not in loose and x.shape[d] >= ways:
            placements(want, mesh, x.shape)      # raises, naming the dim
    # redistributed even where the placements already agree: the node
    # pins the gradient to the same layout, as a JAX constraint pins the
    # cotangent's
    return x.redistribute(mesh, placements(spec, mesh, x.shape))


def local_shard(x, lead):
    """``x``'s local shard, contiguous, for a kernel that computes each
    rank's slice of ``lead``'s layout from these shards alone.  Its
    gradient keeps ``x``'s placements, except on a mesh dim where ``x``
    is replicated and ``lead`` is not: each rank's gradient there is its
    own slice's share, so it is ``Partial`` (summed on its way back)."""
    from torch.distributed.tensor import Partial
    gp = [Partial() if p.is_replicate() and not lp.is_replicate() else p
          for p, lp in zip(x.placements, lead.placements)]
    return x.to_local(grad_placements=gp).contiguous()


def from_local(t: torch.Tensor, mesh, placements, shape):
    """A local shard ``t`` as a DTensor of global ``shape`` (contiguous
    strides)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(t, mesh, placements, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def from_local_like(t: torch.Tensor, lead):
    """A kernel's local output ``t`` as a DTensor with ``lead``'s mesh,
    placements and global shape."""
    return from_local(t, lead.device_mesh, lead.placements, lead.shape)


def mesh_coordinate(x, dim: int) -> int:
    """This rank's index along the mesh dim that shards ``x``'s dim
    ``dim`` (0 where no mesh dim does; one mesh dim at most)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    dims = [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim == dim]
    if len(dims) > 1:
        raise ValueError(f"dim {dim} is split over {len(dims)} mesh dims")
    return coord[dims[0]] if dims else 0


def spec_leaves(tree) -> list:
    """The specs of a spec tree in the leaf order of
    :func:`repro_torch.train.tree.leaves` (dict keys sorted)."""
    if is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


def replicate(x):
    """``x`` replicated over every mesh dim (a ``Partial`` sum reduced)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def add_into(acc, g) -> None:
    """``acc += g`` in place; on a DTensor ``acc``, ``g`` is first laid
    out as ``acc`` is (reduced or reduce-scattered where ``g`` is
    ``Partial`` and ``acc`` is not)."""
    if is_dtensor(acc):
        g = g.redistribute(acc.device_mesh, acc.placements)
    acc.add_(g)


def relayout_tree(tree, specs, mesh):
    """A DTensor tree laid out anew by ``specs``, each leaf a new leaf
    (detached from ``tree``'s)."""
    if isinstance(tree, dict):
        return {k: relayout_tree(v, specs[k], mesh) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(relayout_tree(v, s, mesh)
                          for v, s in zip(tree, specs, strict=True))
    return tree.detach().redistribute(mesh, placements(specs, mesh,
                                                       tree.shape))


def distribute_tree(tree, specs, mesh):
    """The tree (dicts and per-layer lists of tensors, as the port's
    parameter trees) with every leaf a DTensor laid out by its spec in
    ``specs`` (the same structure, :class:`P` leaves).  Each rank holds
    the whole tree already (the same seed, or the same file): it keeps
    a copy of its own shard (so that updating one tree in place leaves
    the other alone), and nothing crosses a link."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs, strict=True))
    if not is_spec(specs):
        raise TypeError(f"no spec for a leaf of shape {tuple(tree.shape)}")
    if len(specs) > tree.ndim:
        raise ValueError(f"spec {specs!r} for a rank-{tree.ndim} tensor")
    dt = distribute_tensor(tree.detach(), mesh,
                           placements(specs, mesh, tree.shape),
                           src_data_rank=None)
    return from_local(dt.to_local().clone(), mesh, dt.placements, dt.shape)


# ---------------------------------------------------------------------------
# PartitionSpec plumbing for launchers (ZeRO-1 moments, multi-pod retarget)
# ---------------------------------------------------------------------------

def _mentions(entry, axis: str) -> bool:
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return axis in entry
    return entry == axis


def _zero1_leaf(spec: P) -> P:
    """Shard an optimizer-moment leaf over the data axis for ZeRO-1.

    Leaves whose parameter spec already carries ``data`` (FSDP leaves)
    are left untouched: double-sharding them over data would
    over-partition.  Otherwise the first replicated dim picks up the data
    axis; fully sharded leaves stay as they are."""
    entries = list(spec)
    if any(_mentions(e, "data") for e in entries):
        return spec
    for i, e in enumerate(entries):
        if e is None:
            entries[i] = "data"
            return P(*entries)
    return spec


@dataclasses.dataclass(frozen=True)
class OptStatePSpecs:
    """Specs for AdamW-style (m, v) moment trees."""

    m: Any
    v: Any


def opt_state_pspecs(param_pspecs, zero1: bool = False) -> OptStatePSpecs:
    """Moment specs from parameter specs; ``zero1`` shards replicated
    moments over the data axis (optimizer-state partitioning)."""
    leaf = _zero1_leaf if zero1 else (lambda s: s)
    return OptStatePSpecs(m=map_specs(leaf, param_pspecs),
                          v=map_specs(leaf, param_pspecs))


def dp_axes(mesh):
    """Every mesh axis that carries the batch (all but ``model``)."""
    axes = tuple(a for a in axis_names(mesh) if a != "model")
    return axes if len(axes) != 1 else axes[0]


def retarget_pspec(spec: P, mesh) -> P:
    """Rewrite a (data, model)-world spec for ``mesh``: every ``data``
    entry expands to the mesh's full set of data-parallel axes (e.g.
    ``("pod", "data")`` on a multi-pod mesh)."""
    dp = dp_axes(mesh)
    return P(*[dp if _mentions(e, "data") else e for e in spec])


def retarget_tree(tree, mesh):
    return map_specs(lambda s: retarget_pspec(s, mesh), tree)


def batch_pspec(mesh, ndim: int = 1) -> P:
    """Spec for one batch array: leading dim sharded over the
    data-parallel axes, the remaining ``ndim - 1`` dims replicated."""
    return P(dp_axes(mesh), *([None] * (max(ndim, 1) - 1)))


def batch_pspecs_for(mesh, batch_tree):
    """Batch arrays (a dict of them) shard their leading dim over the
    data-parallel axes."""
    dp = dp_axes(mesh)
    return {k: P(dp) for k in batch_tree}

"""Dry run of the port over the production mesh, on the CPU: every
(architecture x input shape x mesh) cell traced once per device's share,
with its FLOPs, collective wire bytes and peak memory per device
(counterpart of the JAX package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers each cell over 512 fake XLA devices and reads XLA's
cost and memory analyses and the optimised HLO.  The port has no
compiler to ask, so it runs the step itself, on nothing:

- **World.** A fake process group (``FakeStore``, backend ``"fake"``) of
  256 ranks (``single``, the ``(16, 16)`` mesh) or 512 (``multi``, ``(2,
  16, 16)``), this process rank 0; :func:`~repro_torch.launch.mesh.
  make_production_mesh` on device type ``"cpu"``.  Collectives return at
  once and move nothing.
- **Tensors.** Parameters, optimizer state, cache and batch are fake
  tensors (``FakeTensorMode``): shapes, dtypes and layouts, no memory.
  The parameters, moments and cache are DTensors over rank 0's local
  shards, laid out by the reference's specs (its ``PLANS``:
  ``fsdp_param_pspecs``, ZeRO-1 moments, the gradient accumulation plan)
  fitted to each shape.  The tensors lie on the CPU, so every kernel
  wrapper takes its plain version and nothing is launched: the counts
  are those of the plain versions (full attention scores included), as
  the reference's are those of its CPU lowering.  **The dry run measures
  nothing on a device.**
- **FLOPs per device.** ``torch.utils.flop_counter``'s formulas over the
  local aten ops only (:class:`Recorder`): DTensor runs each op once on
  fake tensors of the global shape to propagate its layout, and those
  runs are not counted.
- **Collectives.** The functional collectives that DTensor and the model
  issue, each a ring of the group's size: wire bytes per device from the
  result's bytes, the reference's ``_wire_bytes_of_line`` model
  (:func:`wire_bytes`).
- **Memory.** The peak of the bytes held by live storages during the
  step, the arguments' local shards (and the global batch every rank is
  given) counted from the start; the arguments' bytes alone as
  ``argument_size_in_bytes``.
- **RWKV-6.** The plain scan walks its tokens one at a time, too slow
  to trace at 32k tokens: its outputs are made at once and its FLOPs
  counted as its loop's products count (:func:`counted_scan`).
- **Depth.** Each cell is traced at its config's full depth.  FLOPs,
  bytes and counts are affine in depth, but the peak is not: it is a
  maximum over the step, and where it lies moves with depth (traced at
  1 and 2 layers and extrapolated, qwen2-vl-72b's prefill_32k peak came
  out 92.3 GiB a device; traced at its 80 layers it is 14.3 GiB).

Per cell: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys (``devices``, ``status``, ``plan``,
``cost_analysis.flops``, ``memory_analysis.peak_memory_in_bytes``,
``collectives`` with ``wire_bytes``, ``counts`` and ``total_wire_bytes``)
and ``trace_s`` for its ``lower_s``/``compile_s``; ``status`` is ``ok``,
``skipped`` (with ``cell_applicable``'s reason) or ``error``.  Numbers
are per device.  :mod:`repro_torch.launch.roofline` reads them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

import repro_torch.configs as RC
from repro_torch.configs.shapes import LM_SHAPES, VAE_SHAPES, ShapeSpec
from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P
from repro_torch.train.tree import leaves

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

#: the reference's stub patch-embedding prefix of a VLM cell
VISION_PREFIX = 256

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


# ---------------------------------------------------------------------------
# per-arch parallelism plans (the reference's, without its
# ``constraints`` lever)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    microbatches: int = 8
    fsdp: bool = False               # shard params over 'data' (FSDP)
    zero1: bool = True               # shard optimizer moments over 'data'
    moment_dtype: str = "float32"    # 'bfloat16' for the XL archs
    compress_grads: bool = False
    grad_dtype: str = "float32"      # accumulator dtype
    grad_accum: str = "local"        # 'local' | 'sharded' | 'auto' (no pin)
    gather_once: bool = False        # FSDP: gather weights once per step


PLANS: Dict[str, Plan] = {
    "whisper-large-v3": Plan(microbatches=4, grad_accum="auto"),
    "granite-8b": Plan(microbatches=8),
    "qwen3-14b": Plan(microbatches=8),
    "qwen2-7b": Plan(microbatches=8),
    "phi4-mini-3.8b": Plan(microbatches=4),
    "mixtral-8x7b": Plan(microbatches=8, fsdp=True,
                         grad_dtype="bfloat16", moment_dtype="bfloat16",
                         grad_accum="auto"),
    "kimi-k2-1t-a32b": Plan(microbatches=16, fsdp=True,
                            moment_dtype="bfloat16",
                            grad_dtype="bfloat16", grad_accum="auto"),
    "rwkv6-7b": Plan(microbatches=8),
    "qwen2-vl-72b": Plan(microbatches=16, fsdp=True,
                         moment_dtype="bfloat16",
                         grad_dtype="bfloat16", grad_accum="sharded"),
    "zamba2-2.7b": Plan(microbatches=4),
}

#: what the artifact's ``plan`` leaves out: DTensor parameters need
#: their mesh installed as the constraint mesh, so the port always
#: applies the model's layout constraints (the reference turns them off
#: for whisper, mixtral and kimi-k2, and in its baseline)
PLAN_NOTE = "in-model layout constraints: always applied"


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def _shard_last_free_dim(spec: P, ndim: int, axis: str, first: int) -> P:
    parts = list(spec) + [None] * (ndim - len(spec))
    for i in range(len(parts) - 1, first - 1, -1):
        if parts[i] is None:
            parts[i] = axis
            return P(*parts)
    return P(*parts)


def fsdp_param_pspecs(specs, shapes, mesh, dp_name: str = "data",
                      layers: int = 1, _stacked: bool = False):
    """The reference's ``fsdp_param_pspecs`` on the port's trees: the last
    free dim of each leaf of at least 2^20 elements (counted over its
    stack of ``layers`` for a per-layer leaf) goes over ``dp_name`` where
    that axis divides it.  The reference never shards dim 0, its stack
    dim for a layer leaf: a per-layer leaf here has no stack, so every
    one of its dims may take the axis; a top-level leaf keeps dim 0."""
    if isinstance(specs, dict):
        return {k: fsdp_param_pspecs(specs[k], shapes[k], mesh, dp_name,
                                     layers, _stacked) for k in specs}
    if not D.is_spec(specs):
        return [fsdp_param_pspecs(s, t, mesh, dp_name, layers, True)
                for s, t in zip(specs, shapes, strict=True)]
    shape = tuple(shapes.shape)
    n = 1
    for dim in shape:
        n *= dim
    if n * (layers if _stacked else 1) < (1 << 20):
        return specs
    cand = _shard_last_free_dim(specs, len(shape), dp_name,
                                0 if _stacked else 1)
    size = D.axis_size(mesh, dp_name)
    for i, ax in enumerate(cand):
        if ax == dp_name and shape[i] % size:
            return specs
    return cand


def fit_tree(specs, shapes, mesh):
    """``specs`` retargeted to ``mesh`` (``data`` -> its data axes) and
    fitted to each leaf's shape: the reference's ``retarget_tree`` after
    ``validate_divisibility``."""
    if isinstance(specs, dict):
        return {k: fit_tree(specs[k], shapes[k], mesh) for k in specs}
    if not D.is_spec(specs):
        return [fit_tree(s, t, mesh) for s, t in zip(specs, shapes,
                                                     strict=True)]
    return D.fit_spec(D.retarget_pspec(specs, mesh), shapes.shape, mesh)


# ---------------------------------------------------------------------------
# what a step does, per device
# ---------------------------------------------------------------------------

def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes per device of one collective over a ring of ``n``
    devices whose result holds ``nbytes`` (the reference's
    ``_wire_bytes_of_line``): an all-gather's result is the whole
    gathered tensor, a reduce-scatter's one shard."""
    if nbytes == 0:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return float(nbytes * (n - 1))
    return float(nbytes)                          # collective-permute


#: functional collectives -> (reference kind, the group's argument index
#: or name)
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _group_size(func, args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    schema = func._schema
    for i, a in enumerate(schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name == "group_size":
            return int(val)
        if a.name == "group_name":
            return _resolve_process_group(val).size()
    raise ValueError(f"no group in {func}")


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in
               (out if isinstance(out, (list, tuple)) else [out])
               if isinstance(t, torch.Tensor))


class Recorder:
    """Counts what one device does in a traced step: FLOPs of the local
    aten ops, functional collectives (kind, wire bytes, count) and the
    peak of live storage bytes.  Use as a context manager; :meth:`hold`
    adds tensors alive from the start (the arguments)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self.flops = 0
        self.wire = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.counts: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self._in_propagation = 0
        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented        # DTensor runs the local ops
                out = func(*args, **kwargs)
                if rec._in_propagation:
                    return out                   # a global-shape shadow op
                pk = func.overloadpacket
                if pk in flop_registry:
                    rec.flops += flop_registry[pk](*args, **kwargs,
                                                   out_val=out)
                if func.namespace == "_c10d_functional":
                    kind = _COLLECTIVES.get(pk.__name__)
                    if kind is not None:
                        n = _group_size(func, args, kwargs)
                        rec.wire[kind] += wire_bytes(kind, _nbytes(out), n)
                        rec.counts[kind] = rec.counts.get(kind, 0) + 1
                rec.hold(out)
                return out

        self._mode = _Mode()

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live from now until they are freed."""
        import weakref
        from torch.distributed.tensor import DTensor
        for t in leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        rec, orig = self, ShardingPropagator._propagate_tensor_meta_non_cached

        def counted(prop, op_schema):
            rec._in_propagation += 1
            try:
                return orig(prop, op_schema)
            finally:
                rec._in_propagation -= 1

        self._restore = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = counted
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        return False


    def totals(self) -> Dict[str, Any]:
        return {"flops": float(self.flops), "wire_bytes": dict(self.wire),
                "counts": dict(self.counts),
                "peak_memory_in_bytes": int(self.peak)}


@contextlib.contextmanager
def host_index_math():
    """DTensor's layout of a dim split over two mesh dims
    (``_StridedShard``) finds a shard's size from an index tensor it reads
    back on the host, which a fake tensor cannot give: that index tensor
    is made real (sizes only, no model data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


@contextlib.contextmanager
def counted_scan(rec: Recorder):
    """The plain RWKV-6 scan (``ref.rwkv6_scan_ref``) walks its tokens one
    at a time: 32,768 steps a layer in a ``prefill_32k`` cell, minutes
    each under fake tensors.  In a trace its outputs are made at once,
    and ``rec`` counts the FLOPs its loop's products would: 2 n h t d^2
    (a ``[n h, 1, d] x [n h, d, d]`` product a token)."""
    from repro_torch.kernels import ref
    orig = ref.rwkv6_scan_ref

    def at_once(r, k, v, w, u, state=None):
        n, h, t, d = r.shape
        rec.flops += 2 * n * h * t * d * d
        final = (torch.zeros((n, h, d, d), dtype=torch.float32,
                             device=r.device) if state is None
                 else state.float().clone())
        return torch.empty_like(r), final

    ref.rwkv6_scan_ref = at_once
    try:
        yield
    finally:
        ref.rwkv6_scan_ref = orig


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_inputs(cfg, shape: ShapeSpec) -> Dict[str, Any]:
    """Fake inputs of the cell's step (the reference's ``input_specs``),
    global, as every rank is given them: train and prefill token ids
    (and an enc-dec's frames, a VLM's vision prefix), decode one token a
    sequence (its cache is made from the config)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.zeros((b,), dtype=torch.long)}
    out: Dict[str, Any] = {}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                    dtype=cfg.dtype)
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.zeros((b, VISION_PREFIX, cfg.d_model),
                                           dtype=cfg.dtype)
        s -= VISION_PREFIX
    out["tokens"] = torch.zeros((b, s), dtype=torch.long)
    if shape.kind == "train":
        out["labels"] = torch.zeros((b, s), dtype=torch.long)
    return out


def build_cell(arch: str, shape: ShapeSpec, mesh, optimized: bool = True,
               cfg=None) -> Tuple[Callable[[], Any], list, Dict[str, Any]]:
    """(step, its arguments, meta) of one cell, every tensor fake; call
    under ``FakeTensorMode``
    with the mesh installed as the constraint mesh.  ``cfg`` replaces
    ``arch``'s published config (a reduced one, in tests)."""
    if arch == "sd35_vae":
        return build_vae_cell(shape, mesh)
    from repro_torch.models import encdec as E
    from repro_torch.models import lm as M
    cfg = cfg or RC.get_config(arch)
    plan = PLANS[arch]
    mod = E if cfg.family == "encdec" else M
    gen = torch.Generator()
    if cfg.family == "encdec":
        shapes = E.init_params(gen, cfg, 32768)
    else:
        shapes = M.init_params(gen, cfg)
    shapes = M.leaf_dtypes(shapes, cfg, lambda t, dt: t.to(dt))
    maxis = D.axis_size(mesh, "model")
    specs = mod.param_pspecs(cfg, maxis)
    if plan.fsdp:
        specs = fsdp_param_pspecs(specs, shapes, mesh, layers=cfg.n_layers)
    specs = fit_tree(specs, shapes, mesh)
    params = D.zeros_tree(shapes, specs, mesh)
    model = (E.EncDecLM if cfg.family == "encdec" else M.CausalLM)(
        cfg, device="cpu", params=params)
    params = model.params
    inputs = cell_inputs(cfg, shape)
    meta: Dict[str, Any] = {"plan": dataclasses.asdict(plan),
                            "plan_note": PLAN_NOTE}

    if shape.kind == "train":
        from repro_torch.train.optim import AdamW, AdamWConfig
        from repro_torch.train.train_step import make_train_step
        opt = AdamW(AdamWConfig(moment_dtype=plan.moment_dtype))
        ospecs = D.opt_state_pspecs(specs, zero1=plan.zero1)
        ospecs = D.OptStatePSpecs(m=fit_tree(ospecs.m, shapes, mesh),
                                  v=fit_tree(ospecs.v, shapes, mesh))
        state = opt.init(params, ospecs)
        grad_sh = None
        if optimized and plan.grad_accum == "local":
            grad_sh = D.map_specs(lambda sp: P(*[
                None if e is not None and set(
                    e if isinstance(e, tuple) else (e,)) & {"data", "pod"}
                else e for e in sp]), specs)
        elif optimized and plan.grad_accum == "sharded":
            grad_sh = specs
        step = make_train_step(model, opt, microbatches=plan.microbatches,
                               compress_grads=plan.compress_grads,
                               grad_dtype=getattr(torch, plan.grad_dtype),
                               grad_shardings=grad_sh,
                               param_gather_shardings=specs
                               if plan.gather_once and plan.fsdp else None)
        args = [params, state, inputs]
        return (lambda: step(params, state, None, inputs)), args, meta

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            fn = lambda: model.prefill(inputs["tokens"],  # noqa: E731
                                       inputs["frames"])
        else:
            fn = lambda: model.prefill(  # noqa: E731
                inputs["tokens"], embeds=inputs.get("vision_embeds"))
        return fn, [params, inputs], meta

    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        cache = E.init_cache(cfg, b, s, "cpu", mesh=mesh)
    else:
        cache = M.init_cache(cfg, b, s, "cpu", mesh=mesh)
    fn = lambda: model.decode_step(cache, inputs["tokens"])  # noqa: E731
    return fn, [params, cache, inputs], meta


def build_vae_cell(shape: ShapeSpec, mesh):
    """The SD3.5 VAE decode fleet (the paper's own architecture): the
    latent batch over the largest prefix of the mesh axes that divides
    it, the decoder's fp32 weights (the port's serving precision)
    replicated, each device decoding its rows."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.vae.model import (SD35_VAE, decode, init_decoder,
                                       with_phase_taps)
    cfg = SD35_VAE
    lat = shape.seq_len // cfg.spatial_factor
    b = shape.global_batch
    params = with_phase_taps(init_decoder(torch.Generator(), cfg))
    pl, ways = [], 1
    for i, a in enumerate(D.axis_names(mesh)):
        if len(pl) == i and b % (ways * mesh.size(i)) == 0:
            pl.append(Shard(0))
            ways *= mesh.size(i)
    pl += [Replicate()] * (mesh.ndim - len(pl))
    z = D.from_local(torch.empty((b // ways, lat, lat, cfg.latent_channels)),
                     mesh, pl, (b, lat, lat, cfg.latent_channels))

    def fn():
        with torch.no_grad():     # inference mode would bypass the Recorder
            return decode(params, z.to_local(), cfg)

    return fn, [params, z], {"plan": {"dp": "all-axes prefix",
                                      "data_parallel_ways": ways,
                                      "dtype": "float32"}}


def trace(arch: str, shape: ShapeSpec, mesh, optimized: bool = True,
          cfg=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Trace one cell: (its per-device counts, meta)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    D.set_constraint_mesh(mesh)
    try:
        with host_index_math(), FakeTensorMode(allow_non_fake_inputs=True):
            fn, args, meta = build_cell(arch, shape, mesh, optimized, cfg)
            rec = Recorder()
            rec.hold(args)
            held = rec.live
            with rec, counted_scan(rec):
                out = fn()
            del out
    finally:
        D.set_constraint_mesh(None)
    return dict(rec.totals(), argument_size_in_bytes=held), meta


# ---------------------------------------------------------------------------
# the world and one cell
# ---------------------------------------------------------------------------

MESH_WORLD = {"single": 256, "multi": 512}


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (made
    anew where this process has one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def fake_mesh(shape, names=("data", "model")):
    """A mesh of ``shape`` over a fake world of its size, device type
    ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = 1
    for n in shape:
        world *= n
    _fake_group(world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def fake_world(mesh_kind: str):
    """The production mesh of ``mesh_kind`` over a fake world of its
    size, device type ``"cpu"``."""
    from repro_torch.launch.mesh import make_production_mesh
    _fake_group(MESH_WORLD[mesh_kind])
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cpu")


def run_cell(arch: str, shape: ShapeSpec, mesh_kind: str,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             optimized: bool = True) -> Dict[str, Any]:
    mesh = fake_world(mesh_kind)
    n_dev = MESH_WORLD[mesh_kind]
    cell_id = f"{arch}__{shape.name}__{mesh_kind}"
    result: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                              "mesh": mesh_kind, "devices": n_dev,
                              "status": "ok"}
    t0 = time.time()
    try:
        if arch != "sd35_vae":
            ok, why = RC.cell_applicable(RC.get_config(arch), shape)
            if not ok:
                result.update(status="skipped", reason=why)
                _save(out_dir, cell_id, result)
                if verbose:
                    print(f"[dryrun] {cell_id}: SKIP ({why})")
                return result
        counts, meta = trace(arch, shape, mesh, optimized=optimized)
        if arch != "sd35_vae":
            result["layers"] = RC.get_config(arch).n_layers
        meta.setdefault("plan", {})["optimized"] = optimized
        result.update(meta)
        result["trace_s"] = round(time.time() - t0, 1)
        result["cost_analysis"] = {"flops": counts["flops"]}
        result["memory_analysis"] = {
            k: counts[k] for k in ("peak_memory_in_bytes",
                                   "argument_size_in_bytes")}
        wire = counts["wire_bytes"]
        result["collectives"] = {
            "wire_bytes": wire, "counts": counts["counts"],
            "total_wire_bytes": float(sum(wire.values())),
            "model": "ring: all-reduce 2 B (n-1)/n, all-gather and "
                     "all-to-all B (n-1)/n, reduce-scatter B (n-1), "
                     "B the result's bytes"}
        result["measured_on"] = "CPU trace over fake tensors: counts " \
                                "per device, no device time"
    except Exception as e:  # noqa: BLE001 - record and continue the matrix
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {cell_id}: ERROR {result['error']}")
    result["wall_s"] = round(time.time() - t0, 1)
    _save(out_dir, cell_id, result)
    if verbose and result["status"] == "ok":
        print(f"[dryrun] {cell_id}: OK (trace {result['trace_s']}s, "
              f"{result['cost_analysis']['flops'] / 1e12:.2f} TFLOP, "
              f"collective wire "
              f"{result['collectives']['total_wire_bytes'] / 1e9:.2f} GB, "
              f"peak {result['memory_analysis']['peak_memory_in_bytes'] / 2 ** 30:.1f} GiB"
              " per device)", flush=True)
    return result


def _save(out_dir: str, cell_id: str, result: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)


def all_cells():
    for arch in RC.ARCH_IDS:
        for shape in LM_SHAPES.values():
            yield arch, shape
    for shape in VAE_SHAPES.values():
        yield "sd35_vae", shape


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="no pinned gradient-accumulation layout (the "
                         "reference's baseline also drops the in-model "
                         "constraints, which the port always applies)")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        # one fake world a process: each mesh in a process of its own
        flags = ["--out", args.out]
        flags += ["--arch", args.arch] if args.arch else []
        flags += ["--shape", args.shape] if args.shape else []
        flags += [f for f, on in (("--all", args.all),
                                  ("--skip-existing", args.skip_existing),
                                  ("--baseline", args.baseline)) if on]
        rcs = [subprocess.call([sys.executable, "-m",
                                "repro_torch.launch.dryrun", "--mesh", m]
                               + flags) for m in ("single", "multi")]
        raise SystemExit(max(rcs))
    if args.all:
        cells = list(all_cells())
    else:
        if args.arch is None:
            ap.error("name --arch, or --all")
        shapes = VAE_SHAPES if args.arch == "sd35_vae" else LM_SHAPES
        pick = ([shapes[args.shape]] if args.shape
                else list(shapes.values()))
        cells = [(args.arch, s) for s in pick]

    torch.set_num_threads(min(torch.get_num_threads(), 4))
    failures = 0
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape.name}__{args.mesh}"
                            ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    continue
        r = run_cell(arch, shape, args.mesh, out_dir=args.out,
                     optimized=not args.baseline)
        failures += r["status"] == "error"
    print(f"[dryrun] done, {failures} failure(s)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

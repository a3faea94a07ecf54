"""The port's distribution layer (``repro_torch.dist.sharding``) on the
CPU against the JAX package's.

Held to the reference: the spec helpers (``tests/test_trace_dist.py``'s
``TestShardingHelpers`` and their neighbours, one parametrised test);
every architecture's ``param_pspecs`` and ``cache_pspecs`` at its
published config, model axis 1 and 16, leaf for leaf (a per-layer leaf's
spec is the reference's stacked spec without its leading ``None``); one
sharded train step (two microbatches, ZeRO-1 moments) on gloo ranks for
qwen2-7b, mixtral-8x7b (experts over "model"), rwkv6-7b and
whisper-large-v3 on a (2, 2) ("data", "model") mesh, qwen2-7b there
once more with FSDP-stored parameters gathered once a step, and on a
(1, 3) mesh, whose model axis divides no head count (the
sequence-parallel attention layout), each against the JAX package's
unsharded step on the same weights and batch; ``prefill`` on DTensor
parameters for every causal family and the enc-dec on (2, 2), and
qwen2-7b on (1, 3), against the JAX prefill (logits and every cache
leaf), and on a (1, 1) mesh in this process against the plain prefill
(and its decode steps against the plain ones); ``decode_step`` after a
prefill on DTensor parameters and cache for every causal family and the
enc-dec on (2, 2), and qwen2-7b and mixtral-8x7b on (1, 4) with the KV
slots split four ways, against the JAX package's unsharded chain; one
sharded VAE decode step on a (2, 2) mesh against the JAX decode.

Ranks are processes (``torch.multiprocessing``, spawn), one spawn per
case running all of its checks, rendezvous through a
``FileStore`` under ``tmp_path`` (no port), ``OMP_NUM_THREADS=1``, joined
with a deadline.  Rank 0 writes the gathered results; the parent holds
them to the reference.

Tolerances are ``tests/test_torch_train.py``'s: loss 1e-4 relative;
gradients, updated parameters and moments 1e-4 of each reference leaf's
max |value|; for gradients with a floor of a thousandth of the tree's
largest, as there, and for parameters and moments only on whisper's key
biases (:data:`KEY_BIAS`: with no RoPE their gradients are zero but for
rounding under the softmax's shift invariance, and so are their updates
and moments); pixels 1e-4 (``tests/test_torch_encode.py``'s float
decode).
"""

import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.dist import sharding as D
from repro_torch.dist.sharding import P

torch.set_num_threads(2)

#: the reference step's optimizer (``tests/test_torch_train.py``'s)
OPT = dict(lr=3e-3, warmup_steps=1, eps=1e-3)
#: seconds a spawn may take before its ranks are killed
DEADLINE = 150
#: widths that a model axis of 3 divides, at 4 heads (which it does not)
WIDTHS_3 = dict(d_model=96, d_ff=192, vocab_size=384)


@pytest.fixture
def world1():
    """A world-size-1 gloo group in this process (a ``HashStore``),
    destroyed afterwards."""
    import torch.distributed as dist
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield
    if made:
        dist.destroy_process_group()


def local_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# the spec helpers
# ---------------------------------------------------------------------------

def case_constrain_noop_without_mesh():
    import jax.numpy as jnp
    from repro.dist import sharding as JS
    JS.set_constraint_mesh(None)
    D.set_constraint_mesh(None)
    x, t = jnp.ones((4, 4)), torch.ones(4, 4)
    return JS.constrain(x, "data", None) is x, D.constrain(t, "data",
                                                          None) is t


def case_zero1_skips_fsdp_leaves():
    from jax.sharding import PartitionSpec as JP
    from repro.dist import sharding as JS
    want = JS.opt_state_pspecs({"w": JP(None, "data", "model"),
                                "b": JP(None, "model")}, zero1=True)
    got = D.opt_state_pspecs({"w": P(None, "data", "model"),
                              "b": P(None, "model")}, zero1=True)
    assert got.m["w"] == P(None, "data", "model")       # untouched
    assert got.m["b"] == P("data", "model")             # first free dim
    return (want.m, want.v), (got.m, got.v)


def case_opt_state_pspecs_without_zero1():
    from jax.sharding import PartitionSpec as JP
    from repro.dist import sharding as JS
    want = JS.opt_state_pspecs({"a": [JP(None, "model")], "b": JP(None)})
    got = D.opt_state_pspecs({"a": [P(None, "model")], "b": P(None)})
    return (want.m, want.v), (got.m, got.v)


def case_retarget_pspec_multipod():
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.dist import sharding as JS
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    tmesh = local_mesh((1, 1, 1), ("pod", "data", "model"))
    got = D.retarget_pspec(P("data", None), tmesh)
    assert got == P(("pod", "data"), None)
    return JS.retarget_pspec(JP("data", None), jmesh), got


def case_retarget_tree_and_dp_axes():
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.dist import sharding as JS
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    tmesh = local_mesh((1, 1, 1), ("pod", "data", "model"))
    jt = {"w": JP("data", "model"), "b": JP(None)}
    tt = {"w": P("data", "model"), "b": P(None)}
    return ((JS.retarget_tree(jt, jmesh), JS.dp_axes(jmesh)),
            (D.retarget_tree(tt, tmesh), D.dp_axes(tmesh)))


def case_batch_pspecs():
    import jax
    from repro.dist import sharding as JS
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = local_mesh((1, 1), ("data", "model"))
    batch = {"tokens": 0, "labels": 0}
    return ((JS.batch_pspec(jmesh, 3), JS.batch_pspecs_for(jmesh, batch),
             JS.dp_axes(jmesh)),
            (D.batch_pspec(tmesh, 3), D.batch_pspecs_for(tmesh, batch),
             D.dp_axes(tmesh)))


HELPER_CASES = {
    "constrain_noop_without_mesh": case_constrain_noop_without_mesh,
    "zero1_skips_fsdp_leaves": case_zero1_skips_fsdp_leaves,
    "opt_state_pspecs_without_zero1": case_opt_state_pspecs_without_zero1,
    "retarget_pspec_multipod": case_retarget_pspec_multipod,
    "retarget_tree_and_dp_axes": case_retarget_tree_and_dp_axes,
    "batch_pspecs": case_batch_pspecs,
}


@pytest.mark.parametrize("case", sorted(HELPER_CASES))
def test_sharding_helpers_match_the_reference(world1, case):
    want, got = HELPER_CASES[case]()
    assert got == want


def test_placements_and_uneven_shards(world1):
    """A spec's DTensor placements (a tuple entry over several mesh dims
    in the mesh's order), and the refusals: an unknown axis, an axis used
    twice, axes out of the mesh's order, a dim its axes do not divide."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = local_mesh((1, 1, 1), ("pod", "data", "model"))
    assert D.placements(P(("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert D.placements(P(None, "model"), mesh, (3, 4)) == \
        [Replicate(), Replicate(), Shard(1)]
    for spec, err in ((P("seq"), "lacks"), (P("data", "data"), "twice"),
                      (P(("data", "pod")), "order")):
        with pytest.raises(ValueError, match=err):
            D.placements(spec, mesh)
    mesh2 = local_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="does not split evenly"):
        # a (1, 1) mesh divides every dim: fake a 3-way axis
        D.placements(P("model"), _Sized(mesh2, {"model": 3}), (4,))
    with pytest.raises(ValueError, match="rank-1"):
        D.distribute_tree({"a": torch.zeros(4)}, {"a": P(None, None)},
                          mesh2)


#: (dims, the constraint's axes, its ``loose`` dims, the placements it
#: gives over a fake ("data", "model") = (2, 4) mesh, or None: it raises)
CONSTRAIN_CASES = {
    "even": ((4, 8, 6), ("data", "model", None), (), ["S(0)", "S(1)"]),
    "batch of one": ((1, 8, 6), ("data", "model", None), (), ["R", "S(1)"]),
    "one token": ((4, 1, 6), ("data", "model", None), (), ["S(0)", "R"]),
    "uneven batch": ((3, 8, 6), ("data", "model", None), (), None),
    "uneven prompt": ((4, 5, 6), ("data", "model", None), (), None),
    "uneven prompt, loose": ((4, 5, 6), ("data", "model", None), (1,),
                             ["S(0)", "R"]),
}

CONSTRAIN_CODE = """
import json, torch
from repro_torch.dist import sharding as D
from repro_torch.launch.dryrun import fake_mesh
from torch.distributed.tensor import Replicate
mesh = fake_mesh((2, 4))
D.set_constraint_mesh(mesh)
dims, axes, loose = {dims!r}, {axes!r}, {loose!r}
x = D.from_local(torch.zeros(dims), mesh, [Replicate(), Replicate()], dims)
try:
    got = [str(p).replace("Shard(dim=", "S(").replace("Replicate()", "R")
           for p in D.constrain(x, *axes, loose=loose).placements]
except ValueError as e:
    got = str(e)
print(json.dumps(got))
"""


@pytest.mark.parametrize("case", sorted(CONSTRAIN_CASES))
def test_constrain_fits_only_small_or_loose_dims(case):
    """``constrain`` on a fake (2, 4) world (a child process): an axis
    that does not divide its dim replicates it where the dim is smaller
    than the axis (a batch of one, one token) or the caller lists it as
    loose (a prompt's length), and raises otherwise."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    dims, axes, loose, want = CONSTRAIN_CASES[case]
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", CONSTRAIN_CODE.format(dims=dims, axes=axes,
                                                     loose=loose)],
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=str(root / "src")),
        cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if want is None:
        assert "does not split evenly" in got, got
    else:
        assert got == want


class _Sized:
    """A mesh stand-in with chosen axis extents (placements reads
    ``mesh_dim_names`` and ``size``)."""

    def __init__(self, mesh, sizes):
        self.mesh_dim_names = mesh.mesh_dim_names
        self._sizes = sizes

    def size(self, i):
        return self._sizes.get(self.mesh_dim_names[i], 1)


# ---------------------------------------------------------------------------
# the spec trees of every architecture
# ---------------------------------------------------------------------------

LAYER_KEYS = ("layers", "enc_layers", "dec_layers")


def _jax_specs(tree, path=()):
    """{path: spec} of a JAX spec tree (dicts; PartitionSpec leaves)."""
    from jax.sharding import PartitionSpec as JP
    if isinstance(tree, JP):
        return {path: tree}
    return {p: s for k, v in tree.items()
            for p, s in _jax_specs(v, path + (k,)).items()}


def _port_specs(tree, path=()):
    """{path: spec} of a port spec tree; a per-layer list's specs come
    back as the stacked reference's: ``P(None, *spec)``, the same for
    every layer."""
    if D.is_spec(tree):
        return {path: tree}
    if isinstance(tree, list):
        per = [_port_specs(t, path) for t in tree]
        assert all(p == per[0] for p in per[1:]), path
        return {k: P(None, *s) for k, s in per[0].items()}
    return {p: s for k, v in tree.items()
            for p, s in _port_specs(v, path + (k,)).items()}


def _arch_ids():
    import repro_torch.configs as TC
    return list(TC.ARCH_IDS)


@pytest.mark.parametrize("model_axis", [1, 16])
@pytest.mark.parametrize("arch", _arch_ids())
def test_spec_trees_match_the_reference(arch, model_axis):
    """``param_pspecs`` and ``cache_pspecs`` at the published config: the
    same leaves, each the reference's spec (stacked layer leaves through
    the one mapping above), and a list entry per layer."""
    import repro.configs as RC
    import repro_torch.configs as TC
    from repro_torch.models import encdec as TE
    from repro_torch.models import lm as TL
    jm = RC.build_model(RC.get_config(arch))
    cfg = TC.get_config(arch)
    mod = TE if cfg.family == "encdec" else TL
    tparams = mod.param_pspecs(cfg, model_axis)
    for key in LAYER_KEYS:
        if key in tparams:
            n = cfg.encoder_layers if key == "enc_layers" else cfg.n_layers
            assert len(tparams[key]) == n
    got, want = _port_specs(tparams), _jax_specs(jm.param_pspecs(model_axis))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    got, want = _port_specs(mod.cache_pspecs(cfg)), _jax_specs(
        jm.cache_pspecs())
    assert got == want


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store_path, out_path, *args)`` on ``world``
    spawned ranks; kill them all past :data:`DEADLINE`; return rank 0's
    pickled result (``tmp_path / 'out.pkl'``).  ``args`` go through a
    file: a spawn's arguments larger than a pipe's buffer would start
    the ranks one after another."""
    out, inputs = tmp_path / "out.pkl", tmp_path / "args.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(args, f)
    ctx = mp.start_processes(_rank_main, args=(fn, world, str(
        tmp_path / "store"), str(out), str(inputs)), nprocs=world,
        join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks still running after {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    with open(out, "rb") as f:
        return pickle.load(f)


def _rank_main(rank, fn, world, store, out, inputs):
    with open(inputs, "rb") as f:
        args = pickle.load(f)
    fn(rank, world, store, out, *args)


def _init(rank, world, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _train_rank(rank, world, store, out, shape, arch, widths, plan, tree,
                batch, compress, gather):
    """One sharded train step on this rank (ZeRO-1 moments, two
    microbatches); rank 0 writes loss, grad norm, the gradients the
    optimizer got, the parameters and first moments after the step (all
    gathered, in the reference's stacked layout), and what the layouts
    were.  With ``compress``, also a step with int8 error-feedback
    compression from the same weights, against the port's unsharded
    compressed step (parameters' worst relative error, the error-feedback
    buffers' worst absolute one).  With ``gather``, the parameters are
    stored FSDP-style (ZeRO-1's specs: also over "data") and the step
    gathers them once to ``param_pspecs`` (``param_gather_shardings``);
    rank 0 also writes whether the loss saw them in that layout."""
    import torch.distributed as dist
    import repro_torch.configs as TC
    from repro_torch.models import blocks as B
    from repro_torch.models import ssm as S
    from repro_torch.models.bridge import (encdec_from_numpy, lm_from_numpy,
                                           to_numpy)
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves, tree_map
    _init(rank, world, store)
    try:
        mesh = local_mesh(shape, ("data", "model"))
        cfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)),
                                  **widths)
        bridge = encdec_from_numpy if cfg.family == "encdec" else \
            lm_from_numpy
        tm = bridge(cfg, tree, device="cpu")
        specs = tm.param_pspecs(D.axis_size(mesh, "model"))
        ospecs = D.opt_state_pspecs(specs, zero1=True)
        stored = ospecs.m if gather else specs
        params = D.distribute_tree(tm.params, stored, mesh)
        placed = [p.placements for p in leaves(params)]
        model_only = [tuple(D.placements(sp, mesh))
                      for sp in D.spec_leaves(specs)]
        loss_fn = tm.loss

        def spy_loss(b, ps=None):
            seen["compute"] = [p.placements for p in leaves(ps)]
            return loss_fn(b, ps)

        tm.loss = spy_loss
        opt = O.AdamW(O.AdamWConfig(**OPT))
        state = opt.init(params, ospecs)
        seen, layouts = {}, set()
        update, flash, scan = opt.update, B._flash_attention, S._scan

        def spy_update(grads, st, ps):
            seen["grads"] = tree_map(lambda g: g.full_tensor().clone(),
                                     grads)   # update clips in place
            seen["grad_placements"] = {str(g.placements)
                                       for g in leaves(grads)}
            return update(grads, st, ps)

        def spy_flash(q, k, v, causal, window):
            if D.is_dtensor(q):
                layouts.add(str(q.placements))
            return flash(q, k, v, causal, window)

        def spy_scan(r, k, v, w, u, s):
            if D.is_dtensor(r):
                layouts.add(str(r.placements))
            return scan(r, k, v, w, u, s)

        opt.update, B._flash_attention, S._scan = (spy_update, spy_flash,
                                                   spy_scan)
        local = D.map_specs(lambda s: P(*[None if e == "data" else e
                                          for e in s]), specs)
        step = make_train_step(tm, opt, microbatches=2,
                               grad_shardings=local if plan == "local"
                               else ospecs.m,
                               param_gather_shardings=specs if gather
                               else None)
        D.set_constraint_mesh(mesh)
        params, state, _, met = step(params, state, None, batch)
        if compress:                        # against the same step unsharded
            tm2 = bridge(cfg, tree, device="cpu")
            dp2 = D.distribute_tree(tm2.params, specs, mesh)
            opt2 = O.AdamW(O.AdamWConfig(**OPT))
            cstep = make_train_step(tm2, opt2, microbatches=2,
                                    compress_grads=True, grad_shardings=local)
            dp2, _, ef, _ = cstep(dp2, opt2.init(dp2, ospecs), None, batch)
            D.set_constraint_mesh(None)
            plain = bridge(cfg, tree, device="cpu")
            opt3 = O.AdamW(O.AdamWConfig(**OPT))
            pp, _, pef, _ = make_train_step(plain, opt3, microbatches=2,
                                            compress_grads=True)(
                plain.params, opt3.init(plain.params), None, batch)
            D.set_constraint_mesh(mesh)
            compress = {"params": max(
                float((a.full_tensor() - b).abs().max() / b.abs().max())
                for a, b in zip(leaves(dp2), leaves(pp))), "ef": max(
                float((a.full_tensor() - b).abs().max())
                for a, b in zip(leaves(ef), leaves(pef)))}
        res = {"loss": float(met["loss"]), "compress": compress,
               "grad_norm": float(met["grad_norm"]),
               "grads": to_numpy(seen["grads"]),
               "params": to_numpy(tree_map(lambda t: t.full_tensor(),
                                           params)),
               "m": to_numpy(tree_map(lambda t: t.full_tensor(), state.m)),
               "kept": [p.placements for p in leaves(params)] == placed,
               "fsdp": placed != model_only,
               "computed_on": seen["compute"] == (model_only if gather
                                                  else placed),
               "moments": {str(m.placements) for m in leaves(state.m)},
               "grad_placements": seen["grad_placements"],
               "attention": layouts}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _check_tree(got, want, tol, floor=0.0, floored=None):
    """``tests/test_torch_train.py``'s ``check_tree``: every leaf within
    ``tol`` of max(its reference's max |value|, ``floor`` times the
    tree's largest), the floor only for the leaves named in ``floored``
    (their last key; every leaf where it is None).  Returns each leaf's
    error over its own max |value|."""
    import jax
    flat = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(want)[0]]
    top = max(float(np.abs(w).max()) for _, w in flat)
    worst = {}
    for key, w in flat:
        node = got
        names = key[2:-2].split("']['")
        for k in names:
            node = node[k]
        assert node.shape == w.shape, key
        own = float(np.abs(w).max())
        low = floor * top if floored is None or names[-1] in floored else 0.0
        scale = max(own, low, 1e-30)
        err = float(np.abs(node.astype(np.float64) - w).max())
        assert err <= tol * scale, (key, err, scale)
        worst[key] = err / max(own, 1e-30)
    return worst


STEP_CASES = [("qwen2-7b", (2, 2), "local", True, False),
              ("qwen2-7b", (2, 2), "local", False, True),
              ("mixtral-8x7b", (2, 2), "local", False, False),
              ("rwkv6-7b", (2, 2), "sharded", False, False),
              ("whisper-large-v3", (2, 2), "local", False, False),
              ("qwen2-7b", (1, 3), "local", False, False)]
#: compression's codes may round the other way on one side where a
#: corrected gradient sits within rounding of a half step
#: (``tests/test_torch_train.py``'s 2e-2)
COMPRESS_TOL = 2e-2
#: the key biases of an architecture without RoPE: a bias added to every
#: key shifts a query's scores alike, which the softmax cancels, so their
#: gradients are rounding noise and so are their updates and moments
#: (whisper-large-v3, (2, 2): gradients at most 5.3e-10 against the
#: tree's 8.1e-2; parameters at most 1.0e-9, 2.0e-9 apart; first moments
#: at most 3.4e-11, 6.6e-11 apart).  Only these leaves get the floor
#: outside the gradients.
KEY_BIAS = ("bk",)
NO_ROPE = ("whisper-large-v3",)


@pytest.mark.parametrize("arch,shape,plan,compress,gather", STEP_CASES)
def test_sharded_train_step_matches_jax(arch, shape, plan, compress, gather,
                                        tmp_path, monkeypatch):
    """One step of two microbatches on the mesh against the JAX package's
    unsharded step (jitted, ``microbatches=2``) and its gradient of the
    whole batch: loss, grad norm, every gradient leaf, updated parameter
    and first moment.  The parameters keep their layouts, the moments
    are ZeRO-1's (some sharded over "data"), and attention (RWKV-6's
    scan) ran in the layout the mesh calls for (heads over "model" on
    (2, 2), q's sequence over "model" on (1, 3)).  ``rwkv6-7b`` takes the "sharded"
    gradient plan (reduce-scattered into the moments' layout after each
    microbatch), the rest the "local" one.  qwen2-7b on (2, 2) also
    runs a compressed step (int8 error feedback, one scale per stacked
    leaf) against the port's unsharded one, at :data:`COMPRESS_TOL`.
    One qwen2-7b case stores the parameters FSDP-style (over "data" too)
    and gathers them once before the microbatches
    (``param_gather_shardings``): the loss runs on the gathered layout,
    and the update lands back in the stored one."""
    import jax
    import jax.numpy as jnp
    import repro.configs as RC
    from repro.train import optim as JO
    from repro.train.train_step import make_train_step as jax_train_step
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    widths = WIDTHS_3 if shape == (1, 3) else {}
    jcfg = dataclasses.replace(RC.reduced_config(RC.get_config(arch)),
                               **widths)
    jm = RC.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2))
    r = np.random.default_rng(0)
    toks = r.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if jcfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (4, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    jopt = JO.AdamW(JO.AdamWConfig(**OPT))
    jp, js, _, jmet = jax.jit(jax_train_step(jm, jopt, microbatches=2))(
        params, jopt.init(params), None, jb)
    tree = jax.tree_util.tree_map(np.asarray, params)
    res = _spawn(_train_rank, shape[0] * shape[1], tmp_path, shape, arch,
                 widths, plan, tree, batch, compress, gather)
    assert abs(res["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
    assert abs(res["loss"] - float(jmet["loss"])) <= \
        1e-4 * abs(float(jmet["loss"]))
    assert abs(res["grad_norm"] - float(jmet["grad_norm"])) <= \
        1e-4 * float(jmet["grad_norm"])
    _check_tree(res["grads"], grads, 1e-4, floor=1e-3)
    floored = KEY_BIAS if arch in NO_ROPE else ()
    _check_tree(res["params"], jp, 1e-4, floor=1e-3, floored=floored)
    _check_tree(res["m"], js.m, 1e-4, floor=1e-3, floored=floored)
    assert res["kept"] and res["computed_on"]
    assert res["fsdp"] == gather
    if compress:
        assert res["compress"]["params"] <= COMPRESS_TOL, res["compress"]
        assert res["compress"]["ef"] <= 1e-3, res["compress"]
    assert any(m.startswith("(Shard") for m in res["moments"]), \
        res["moments"]                          # over "data": ZeRO-1
    want = "Shard(dim=2)" if shape == (1, 3) else "Shard(dim=1)"
    assert res["attention"] and all(
        a.split(", ")[-1].startswith(want) for a in res["attention"]), \
        res["attention"]


#: the architectures whose prefill runs on each mesh: every causal family
#: (dense, MoE, RWKV-6 with its carried state, the Mamba-2 hybrid, the VLM
#: with a vision prefix) and the enc-dec on (2, 2), and on (1, 3) the
#: sequence-parallel attention layout
PREFILL_MESHES = {(2, 2): ["qwen2-7b", "mixtral-8x7b", "rwkv6-7b",
                           "zamba2-2.7b", "qwen2-vl-72b",
                           "whisper-large-v3"],
                  (1, 3): ["qwen2-7b"]}
#: prompt rows and tokens, vision-prefix rows, and cache slots: the
#: prompt outruns mixtral's reduced window of 16 (its ring buffer rolls),
#: and 30 slots split over 2 and over 3
PROMPT, PREFIX, MAX_LEN = (4, 24), 4, 30


def _prefill_inputs(cfg, seed):
    r = np.random.default_rng(seed)
    b, s = PROMPT
    inputs = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = r.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        inputs["embeds"] = r.standard_normal((b, PREFIX, cfg.d_model)) \
            .astype(np.float32)
    return inputs


def _walk(tree, fn, path=()):
    """``{path: fn(leaf)}`` over a tree of dicts."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _walk(v, fn, path + (k,)).items()}
    return {path: fn(tree)}


def _prefill_rank(rank, world, store, out, shape, cases):
    """Each case's prefill through the model's entry point on DTensor
    parameters; rank 0 writes the gathered logits and cache, and whether
    each leaf came back laid out by the model's ``cache_pspecs`` (fitted
    to its shape)."""
    import torch.distributed as dist
    import repro_torch.configs as TC
    from repro_torch.models.bridge import encdec_from_numpy, lm_from_numpy
    _init(rank, world, store)
    try:
        mesh = local_mesh(shape, ("data", "model"))
        res = {}
        for arch, widths, tree, inputs in cases:
            cfg = dataclasses.replace(
                TC.reduced_config(TC.get_config(arch)), **widths)
            enc = cfg.family == "encdec"
            tm = (encdec_from_numpy if enc else lm_from_numpy)(
                cfg, tree, device="cpu")
            tm.params = D.distribute_tree(
                tm.params, tm.param_pspecs(D.axis_size(mesh, "model")), mesh)
            D.set_constraint_mesh(mesh)
            if enc:
                lg, cache = tm.prefill(inputs["tokens"], inputs["frames"],
                                       max_len=MAX_LEN)
            else:
                lg, cache = tm.prefill(inputs["tokens"], max_len=MAX_LEN,
                                       embeds=inputs.get("embeds"))
            D.set_constraint_mesh(None)
            specs = _walk(tm.cache_pspecs(), lambda sp: sp)
            res[arch] = {
                "logits": lg.full_tensor().numpy(),
                "logits_placements": str(lg.placements),
                "cache": _walk(cache, lambda t: t.full_tensor().numpy()),
                "placements": _walk(cache, lambda t: str(t.placements)),
                "laid_out": all(
                    tuple(t.placements) == tuple(D.placements(D.fit_spec(
                        specs[p], t.shape, mesh), mesh))
                    for p, t in _walk(cache, lambda t: t).items())}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", sorted(PREFILL_MESHES))
def test_sharded_prefill_matches_jax(shape, tmp_path, monkeypatch):
    """``prefill`` on DTensor parameters (``param_pspecs``), one spawn
    per mesh running every architecture of :data:`PREFILL_MESHES`,
    against the JAX package's unsharded prefill on the same weights and
    inputs: the last position's logits and every cache leaf within 1e-4
    of max(1, the reference's max |value|) (``tests/test_torch_lm.py``'s
    tolerance), ``pos`` exactly.  The cache comes back laid out by
    ``cache_pspecs``: on (2, 2) the KV caches' rows over "data" and their
    slots over "model", the RWKV-6 and Mamba-2 states' heads over
    "model"; the logits' rows over "data" and vocab over "model"."""
    import jax
    import jax.numpy as jnp
    import repro.configs as RC
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    widths = WIDTHS_3 if shape == (1, 3) else {}
    cases, want = [], {}
    for i, arch in enumerate(PREFILL_MESHES[shape]):
        jcfg = dataclasses.replace(RC.reduced_config(RC.get_config(arch)),
                                   **widths)
        jm = RC.build_model(jcfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(2))
        inputs = _prefill_inputs(jcfg, i)
        ji = {k: jnp.asarray(v) for k, v in inputs.items()}
        if jcfg.family == "encdec":
            want[arch] = jm.prefill(params, ji["tokens"], ji["frames"],
                                    max_len=MAX_LEN)
        else:
            want[arch] = jm.prefill(params, ji["tokens"], ji.get("embeds"),
                                    max_len=MAX_LEN)
        cases.append((arch, widths, jax.tree_util.tree_map(np.asarray,
                                                           params), inputs))
    res = _spawn(_prefill_rank, shape[0] * shape[1], tmp_path, shape, cases)
    for arch, (jl, jc) in want.items():
        got = res[arch]
        _close(got["logits"], jl, arch)
        jleaves = _walk(jc, np.asarray)
        assert sorted(got["cache"]) == sorted(jleaves), arch
        for path, w in jleaves.items():
            if path == ("pos",):
                np.testing.assert_array_equal(got["cache"][path], w)
            else:
                _close(got["cache"][path], w, (arch, path))
        assert got["laid_out"], (arch, got["placements"])
        assert got["logits_placements"] == \
            "(Shard(dim=0), Shard(dim=1))", (arch, got["logits_placements"])
        if shape == (2, 2):
            for path, pl in got["placements"].items():
                if path[0] in ("k", "v", "shared_k", "shared_v"):
                    assert pl == "(Shard(dim=1), Shard(dim=3))", (arch, path)
                if path[-1] in ("s", "h"):
                    assert pl == "(Shard(dim=1), Shard(dim=2))", (arch, path)


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "whisper-large-v3"])
def test_prefill_on_a_one_by_one_mesh_is_the_plain_prefill(world1, arch):
    """On a (1, 1) mesh every redistribution is the identity: the mesh
    prefill's logits and cache equal the plain prefill's within 1e-5 of
    max(1, the plain one's max |value|) (``chip_smoke.py`` holds them bit
    for bit on the card; on the CPU the two runs' products round apart
    now and then, on copies at other addresses: rwkv6-7b's logits in 3 of
    62 runs, at most 1.6e-6 apart against a max of about 3.5), and so do
    the logits and cache of ``decode_step`` over the mesh after it,
    against the plain decode step on the plain prefill's cache."""
    import repro_torch.configs as TC
    cfg = TC.reduced_config(TC.get_config(arch))
    tm = TC.build_model(cfg, device="cpu", seed=3)
    inputs = _prefill_inputs(cfg, 5)
    args = (inputs["tokens"], inputs["frames"]) if "frames" in inputs \
        else (inputs["tokens"],)
    want_lg, want_c = tm.prefill(*args, max_len=MAX_LEN)
    mesh = local_mesh((1, 1), ("data", "model"))
    plain = tm.params
    tm.params = D.distribute_tree(plain, tm.param_pspecs(1), mesh)
    D.set_constraint_mesh(mesh)
    try:
        lg, cache = tm.prefill(*args, max_len=MAX_LEN)
        _close(lg.full_tensor().numpy(), want_lg, "logits", tol=1e-5)
        got, want = _walk(cache, lambda t: t.full_tensor()), _walk(
            want_c, lambda t: t)
        assert sorted(got) == sorted(want)
        for p in want:
            _close(got[p].float().numpy(), want[p].float().numpy(), p,
                   tol=1e-5)
        lg, cache = tm.decode_step(cache, inputs["tokens"][:, -1])
        tm.params = plain
        D.set_constraint_mesh(None)
        want_lg, want_c = tm.decode_step(want_c, inputs["tokens"][:, -1])
        _close(lg.full_tensor().numpy(), want_lg, "decode logits", tol=1e-5)
        got, want = _walk(cache, lambda t: t.full_tensor()), _walk(
            want_c, lambda t: t)
        for p in want:
            _close(got[p].float().numpy(), want[p].float().numpy(),
                   ("decode",) + p, tol=1e-5)
    finally:
        D.set_constraint_mesh(None)


#: the architectures whose decode steps run on each mesh, and the cache
#: slots there: on (2, 2) every causal family and the enc-dec, 14 slots
#: in two ranges of 7 (the 5-token prompt leaves the second empty, and
#: the second step crosses into it; the VLM's 4 embeds more); on (1, 4)
#: qwen2-7b in four ranges of 3 (two ranks start with no keys, the
#: steps cross from the second range into the third) and mixtral-8x7b's
#: ring buffer of 8 slots in four ranges of 2 (the last rank starts
#: empty, the fourth step wraps to slot 0)
DECODE_MESHES = {(2, 2): (["qwen2-7b", "mixtral-8x7b", "rwkv6-7b",
                           "zamba2-2.7b", "qwen2-vl-72b",
                           "whisper-large-v3"], 14),
                 (1, 4): (["qwen2-7b", "mixtral-8x7b"], {"qwen2-7b": 12,
                                                        "mixtral-8x7b": 8})}
#: prompt tokens before the decode steps, and the steps
DECODE_PROMPT, DECODE_STEPS = 5, 4


def _decode_max_len(shape, arch):
    slots = DECODE_MESHES[shape][1]
    return slots[arch] if isinstance(slots, dict) else slots


def _lm_decode_rank(rank, world, store, out, shape, cases):
    """Each case's prefill and then its decode steps through the model's
    entry points on DTensor parameters; rank 0 writes each step's
    gathered logits, the final cache, and whether every leaf kept the
    layout of ``cache_pspecs`` (fitted to its shape)."""
    import torch.distributed as dist
    import repro_torch.configs as TC
    from repro_torch.kernels import ops
    from repro_torch.models.bridge import encdec_from_numpy, lm_from_numpy
    _init(rank, world, store)
    try:
        mesh = local_mesh(shape, ("data", "model"))
        res = {}
        for arch, tree, inputs, steps, max_len in cases:
            cfg = TC.reduced_config(TC.get_config(arch))
            enc = cfg.family == "encdec"
            tm = (encdec_from_numpy if enc else lm_from_numpy)(
                cfg, tree, device="cpu")
            tm.params = D.distribute_tree(
                tm.params, tm.param_pspecs(D.axis_size(mesh, "model")), mesh)
            D.set_constraint_mesh(mesh)
            if enc:
                _, cache = tm.prefill(inputs["tokens"], inputs["frames"],
                                      max_len=max_len)
            else:
                _, cache = tm.prefill(inputs["tokens"], max_len=max_len,
                                      embeds=inputs.get("embeds"))
            partial, logits = ops.decode_attention_partial, []
            seen = {"partial": 0}

            def spy(*a, **k):
                seen["partial"] += 1
                return partial(*a, **k)

            ops.decode_attention_partial = spy
            try:
                for tok in steps:
                    lg, cache = tm.decode_step(cache, tok)
                    logits.append(lg.full_tensor().numpy())
            finally:
                ops.decode_attention_partial = partial
            D.set_constraint_mesh(None)
            specs = _walk(tm.cache_pspecs(), lambda sp: sp)
            res[arch] = {
                "logits": logits, "logits_placements": str(lg.placements),
                "partial_calls": seen["partial"],
                "cache": _walk(cache, lambda t: t.full_tensor().numpy()),
                "placements": _walk(cache, lambda t: str(t.placements)),
                "laid_out": all(
                    tuple(t.placements) == tuple(D.placements(D.fit_spec(
                        specs[p], t.shape, mesh), mesh))
                    for p, t in _walk(cache, lambda t: t).items())}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", sorted(DECODE_MESHES))
def test_sharded_decode_steps_match_jax(shape, tmp_path, monkeypatch):
    """``prefill`` of :data:`DECODE_PROMPT` tokens and then
    :data:`DECODE_STEPS` ``decode_step`` calls on DTensor parameters, one
    spawn per mesh, against the JAX package's unsharded prefill and
    decode steps on the same weights and tokens: every step's logits and
    the final cache's every leaf within 1e-4 of max(1, the reference's
    max |value|), ``pos`` exactly.  The cache keeps ``cache_pspecs``'s
    layout; where the slots split over "model" every attention layer's
    step went through the partial kernel's plain version (one call a
    layer a step), elsewhere through the plain decode attention."""
    import jax
    import jax.numpy as jnp
    import repro.configs as RC
    import repro_torch.configs as TC
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cases, want = [], {}
    for i, arch in enumerate(DECODE_MESHES[shape][0]):
        jcfg = RC.reduced_config(RC.get_config(arch))
        jm = RC.build_model(jcfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(4))
        r = np.random.default_rng(20 + i)
        inputs = _prefill_inputs(jcfg, 30 + i)
        inputs["tokens"] = inputs["tokens"][:, :DECODE_PROMPT]
        steps = [r.integers(0, jcfg.vocab_size, (PROMPT[0],)).astype(
            np.int32) for _ in range(DECODE_STEPS)]
        max_len = _decode_max_len(shape, arch)
        ji = {k: jnp.asarray(v) for k, v in inputs.items()}
        if jcfg.family == "encdec":
            _, cache = jm.prefill(params, ji["tokens"], ji["frames"],
                                  max_len=max_len)
        else:
            _, cache = jm.prefill(params, ji["tokens"], ji.get("embeds"),
                                  max_len=max_len)
        logits = []
        for tok in steps:
            lg, cache = jm.decode_step(params, cache, jnp.asarray(tok))
            logits.append(np.asarray(lg))
        want[arch] = (logits, cache)
        cases.append((arch, jax.tree_util.tree_map(np.asarray, params),
                      inputs, steps, max_len))
    res = _spawn(_lm_decode_rank, shape[0] * shape[1], tmp_path, shape,
                 cases)
    for arch, (jl, jc) in want.items():
        got = res[arch]
        for i, (g, w) in enumerate(zip(got["logits"], jl, strict=True)):
            _close(g, w, (arch, "step", i))
        jleaves = _walk(jc, np.asarray)
        assert sorted(got["cache"]) == sorted(jleaves), arch
        for path, w in jleaves.items():
            if path == ("pos",):
                np.testing.assert_array_equal(got["cache"][path], w)
            else:
                _close(got["cache"][path], w, (arch, path))
        assert got["laid_out"], (arch, got["placements"])
        assert got["logits_placements"] == \
            "(Shard(dim=0), Shard(dim=1))", (arch, got["logits_placements"])
        cfg = TC.reduced_config(TC.get_config(arch))
        if cfg.ssm_type == "rwkv6":
            layers = 0
        elif cfg.ssm_type:                   # the hybrid's shared block
            layers = cfg.n_layers // cfg.attn_every
        else:                                # the enc-dec's self-attention
            layers = cfg.n_layers
        assert got["partial_calls"] == layers * DECODE_STEPS, \
            (arch, got["partial_calls"])


def _decode_rank(rank, world, store, out, tree, z):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.vae import model as M
    from repro_torch.vae import serve as vserve
    from repro_torch.vae.bridge import vae_from_numpy
    _init(rank, world, store)
    try:
        mesh = local_mesh((2, 2), ("data", "model"))
        tv = vae_from_numpy(M.DEMO_VAE, tree, device="cpu")
        got = vserve.make_decode_step(M.DEMO_VAE, mesh, device="cpu")(
            tv.decoder, z)
        mine = vserve.make_decode_step(M.DEMO_VAE, device="cpu")(
            tv.decoder, z[rank:rank + 1])
        res = {"pixels": got.full_tensor().numpy(),
               "placements": list(got.placements),
               "local_equal": bool(torch.equal(got.to_local(), mine))}
        results = [None] * world
        dist.all_gather_object(results, res["local_equal"])
        res["local_equal"] = all(results)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_sharded_decode_step_matches_jax(tmp_path, monkeypatch):
    """``make_decode_step(cfg, mesh)`` on a (2, 2) mesh: the batch of 4
    one latent a rank (``Shard(0)`` on both mesh dims), each rank's rows
    bit-identical to the unsharded step on that latent alone, the
    gathered pixels within 1e-4 of the JAX package's decode."""
    import jax
    import jax.numpy as jnp
    from torch.distributed.tensor import Shard
    from repro.vae import model as JM
    from repro.vae import serve as jvserve
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jv = JM.VAE(JM.DEMO_VAE, seed=0)        # float pixels: no calibration
    z = np.random.default_rng(8).standard_normal((4, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(jvserve.make_decode_step(JM.DEMO_VAE)(
        jv.decoder, jnp.asarray(z)))
    res = _spawn(_decode_rank, 4, tmp_path,
                 jax.tree_util.tree_map(np.asarray, jv.decoder), z)
    assert res["placements"] == [Shard(0), Shard(0)]
    assert res["local_equal"]
    assert res["pixels"].shape == want.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(res["pixels"], want, atol=1e-4, rtol=1e-4)

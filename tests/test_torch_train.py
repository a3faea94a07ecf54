"""The port's training path on the CPU against the JAX package's.

Every tree comes from the JAX package's ``init`` through the bridge
(``lm_from_numpy`` / ``encdec_from_numpy``) at ``reduced_config`` (fp32),
and every batch from numpy with a seed, at ``tests/test_models.py``'s
shapes.  Held to the reference: ``cross_entropy_loss``; each
architecture's loss and every gradient leaf (``jax.value_and_grad``),
the leaves turned back into the stacked layout by ``bridge.to_numpy``;
AdamW's update and schedules; int8 error-feedback compression; three
microbatched train steps; the "loss falls" check of
``tests/test_models.py``.  Of the port alone: ``flash_attention_bwd_ref``
against autograd through ``flash_attention_ref`` (float64), remat bit
for bit against no remat, the grad guard of the CUDA wrappers, the
trainer's resume, and the launcher and the example as child processes.

Tolerances: loss and gradients 1e-4 of the reference leaf's max |value|
(fp32 with other summation orders; a leaf whose gradient is zero but for
rounding, a key bias without RoPE under the softmax's shift invariance,
is held at 1e-4 of a thousandth of the tree's largest gradient); an
AdamW update 1e-6 relative; a train step's parameters 1e-4 of each
leaf's max |value|, 2e-2 with compression (see
:func:`test_train_step_matches_jax`).
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models.common import cross_entropy_loss as jax_cross_entropy
from repro.train import grad_compress as JGC
from repro.train import optim as JO
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.kernels import build, ops, ref
from repro_torch.models.bridge import (encdec_from_numpy, lm_from_numpy,
                                       to_numpy)
from repro_torch.models.common import cross_entropy_loss
from repro_torch.train import grad_compress as GC
from repro_torch.train import optim as O
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.train.tree import (flatten_with_paths, leaves,
                                    map_with_paths, paths)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the four archs of ``tests/test_models.py``'s "loss falls" check
STEP_ARCHS = ["granite-8b", "mixtral-8x7b", "rwkv6-7b", "zamba2-2.7b"]


def make_batch(cfg, b=2, s=24, seed=0):
    """``tests/test_models.py``'s batch, as numpy from ``seed``."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["vision_embeds"] = r.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32)
    return batch


def pair(arch, seed=0, **kw):
    """(JAX model, its params, the port's model on the same weights)."""
    jcfg = dataclasses.replace(RC.reduced_config(RC.get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    jm = RC.build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    bridge = encdec_from_numpy if tcfg.family == "encdec" else lm_from_numpy
    return jm, params, bridge(tcfg, tree, device="cpu")


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_grads(model, batch, params=None):
    """(loss, gradient tree in the port's layout) by autograd."""
    params = model.params if params is None else params
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(batch, params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_path = dict(zip(paths(params), [torch.zeros_like(p) if g is None
                                       else g for p, g in zip(flat, grads)]))
    return loss.detach(), map_with_paths(lambda path, _: by_path[path],
                                         params)


def jax_leaves(tree):
    """[(keystr, numpy leaf)] of a JAX tree."""
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def at(tree, keystr):
    """The leaf of a nested dict (numpy layout) at a dict-only keystr."""
    node = tree
    for key in keystr[2:-2].split("']['"):
        node = node[key]
    return node


def check_tree(got_np, want_jax, tol, floor=0.0):
    """Every leaf of the port's (numpy, stacked) tree within ``tol`` of
    max(the reference leaf's max |value|, ``floor``)."""
    worst = {}
    for key, want in jax_leaves(want_jax):
        got = at(got_np, key)
        assert got.shape == want.shape, key
        scale = max(float(np.abs(want).max()), floor, 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= tol * scale, (key, err, scale)
        worst[key] = err / scale
    return worst


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ignored", ["none", "some", "all"])
def test_cross_entropy_loss_matches_the_reference(ignored):
    r = np.random.default_rng(3)
    logits = (r.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    if ignored == "some":
        labels[0, :3] = -1
        labels[2, 5] = -1
    elif ignored == "all":
        labels[:] = -1
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    if ignored == "all":
        assert got == 0.0


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_loss_and_gradients_match_jax(arch):
    jm, params, tm = pair(arch)
    batch = make_batch(jm.cfg)
    jl, jg = jax.value_and_grad(jm.loss)(params, jbatch(batch))
    tl, tg = port_grads(tm, batch)
    assert abs(float(tl) - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    gmax = max(float(np.abs(x).max()) for _, x in jax_leaves(jg))
    got = to_numpy(tg)
    check_tree(got, jg, 1e-4, floor=1e-3 * gmax)
    assert sorted(k for k, _ in jax_leaves(jg)) == \
        sorted(k for k, _ in jax_leaves(jax.tree_util.tree_map(
            jnp.asarray, got)))


def test_vlm_prefix_gets_no_loss():
    """The embeds prefix is unlabelled: the loss equals the mean NLL of
    the token positions' logits alone."""
    from repro_torch.models import lm
    _, _, tm = pair("qwen2-vl-72b")
    batch = tm.batch_on_device(make_batch(tm.cfg))
    with torch.no_grad():
        h = lm.hidden(tm.params, batch["tokens"], tm.cfg,
                      batch["vision_embeds"])
        want = cross_entropy_loss(lm.logits(tm.params, h, tm.cfg)[:, 8:],
                                  batch["labels"])
        assert torch.equal(tm.loss(batch), want)


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------

#: (n, hq, hkv, sq, skv, d, causal, window): causal, a window, GQA, a
#: cross shape (sq != skv), rows with no key left, more rows than a block
BWD_CASES = [(2, 4, 4, 37, 37, 16, True, None),
             (1, 4, 2, 40, 40, 8, True, 7),
             (2, 6, 2, 33, 33, 16, False, None),
             (1, 4, 1, 19, 51, 8, False, None),
             (1, 2, 2, 12, 30, 8, True, 9),
             (1, 2, 1, 20, 9, 8, True, None),
             (1, 2, 2, ref.BWD_BLOCK_ROWS + 37, ref.BWD_BLOCK_ROWS + 37, 4,
              True, 300)]


@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", BWD_CASES)
def test_flash_attention_bwd_ref_matches_autograd(n, hq, hkv, sq, skv, d,
                                                  causal, window):
    g = torch.Generator().manual_seed(sq * 31 + skv)
    q, k, v, do = (torch.randn(s, generator=g, dtype=torch.float64)
                   for s in ((n, hq, sq, d), (n, hkv, skv, d),
                             (n, hkv, skv, d), (n, hq, sq, d)))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), do, causal=causal,
                                      window=window)
    # flash_attention_ref works in fp32 whatever its inputs: autograd
    # through it carries fp32 rounding
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
    # through the op: FlashAttention's backward is flash_attention_bwd_ref
    qs, ks, vs = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, causal=causal, window=window)
    assert out.grad_fn is not None
    via_op = torch.autograd.grad(out, (qs, ks, vs), do.float())
    for a, b in zip(via_op, want):
        assert float((a.double() - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window",
                         [c for c in BWD_CASES
                          if not (c[6] and c[3] > c[4])])
def test_flash_attention_bwd_ref_matches_jax_grad(n, hq, hkv, sq, skv, d,
                                                  causal, window):
    """The plain backward against ``jax.grad`` of the JAX package's
    ``flash_attention_ref`` on the same seeded numpy inputs, fp32 on both
    sides: 1e-5 of each gradient's max.  (Rows with no key, where the JAX
    reference's softmax gives NaN, are left to the float64 case above.)"""
    from repro.kernels import ref as jref
    r = np.random.default_rng(sq * 31 + skv)
    q, k, v, do = (r.standard_normal(s).astype(np.float32)
                   for s in ((n, hq, sq, d), (n, hkv, skv, d),
                             (n, hkv, skv, d), (n, hq, sq, d)))

    def loss(q_, k_, v_):
        out = jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                       window=window)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, o, dot, causal=causal,
                                      window=window)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * float(
            np.abs(b).max())


def test_flash_attention_bwd_ref_keeps_each_dtype():
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 4, 10, 8), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 2, 10, 8), generator=g).to(torch.bfloat16)
    v = torch.randn((1, 2, 10, 8), generator=g).to(torch.bfloat16)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    grads = ref.flash_attention_bwd_ref(q, k, v, o, torch.ones_like(o),
                                        causal=True)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


# ---------------------------------------------------------------------------
# remat, and the grad guard of the CUDA wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b", "rwkv6-7b",
                                  "zamba2-2.7b", "qwen2-vl-72b",
                                  "whisper-large-v3"])
def test_remat_is_bit_identical_on_the_cpu(arch):
    _, _, plain = pair(arch)
    _, _, remat = pair(arch, remat=True)
    batch = make_batch(plain.cfg)
    l0, g0 = port_grads(plain, batch)
    l1, g1 = port_grads(remat, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_attention_forward():
    """Under remat each layer's attention forward runs again in the
    backward pass: twice per layer per step (on the card, the kernel's
    launches)."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    orig = fa._forward

    def counting(*a):
        calls.append(1)
        return orig(*a)

    fa._forward = counting
    try:
        for remat, want in ((False, 2), (True, 4)):
            _, _, tm = pair("qwen2-7b", remat=remat)
            calls.clear()
            port_grads(tm, make_batch(tm.cfg))
            assert len(calls) == want
    finally:
        fa._forward = orig


@pytest.mark.parametrize("kernel", ["conv3x3", "rwkv6_scan",
                                    "flash_attention"])
def test_cuda_wrappers_refuse_grad_before_launch(kernel):
    """``build.require`` (which every wrapper calls on its inputs before
    a launch) raises for an input that requires grad under grad mode,
    before any device check; serving modes pass."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match=kernel) as err:
        build.require(kernel, x=x)
    if kernel == "rwkv6_scan":
        assert "RWKV6Scan" in str(err.value)
    if kernel == "flash_attention":
        assert "FlashAttention" in str(err.value)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            with pytest.raises(ValueError, match="CUDA tensor"):
                build.require(kernel, x=x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        build.require(kernel, x=torch.zeros(2))


def test_rwkv6_trains_through_the_plain_scan_on_the_cpu():
    _, _, tm = pair("rwkv6-7b")
    loss, grads = port_grads(tm, make_batch(tm.cfg))
    mix = grads["layers"][0]["mix"]
    assert all(float(t.abs().max()) > 0 for t in leaves(mix))


# ---------------------------------------------------------------------------
# AdamW and compression
# ---------------------------------------------------------------------------

def adam_trees(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (4, 2, 3)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (r.standard_normal(s) * scale).astype(dtype), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
    return draw(0.5), draw(2.0)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moments, schedule, clip):
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=9, schedule=schedule,
               clip_norm=clip, moment_dtype=moments)
    jopt, topt = JO.AdamW(JO.AdamWConfig(**cfg)), O.AdamW(O.AdamWConfig(**cfg))
    p0, _ = adam_trees(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(6):                    # warmup, decay and the floor
        _, g = adam_trees(10 + step)
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp)
        tp, ts, tm = topt.update(jax.tree_util.tree_map(torch.from_numpy, g),
                                 ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        for key in ("lr",) + (("grad_norm",) if clip else ()):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-6 * abs(float(jm[key]))
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for (k, w), t in zip(jax_leaves(want), leaves(got)):
                assert str(t.dtype) == f"torch.{w.dtype}", k
                w = w.astype(np.float32)
                err = float(np.abs(t.float().numpy() - w).max())
                assert err <= 1e-6 * max(1.0, float(np.abs(w).max())), k


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_the_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, schedule=schedule)
    for step in (0, 1, 9, 10, 11, 30, 50, 70):
        want = float(JO.schedule_lr(JO.AdamWConfig(**kw), jnp.int32(step)))
        got = float(O.schedule_lr(O.AdamWConfig(**kw),
                                  torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1e-12)


def test_global_norm_and_clip_match_the_reference():
    g, _ = adam_trees(4)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    assert float(O.global_norm(tg)) == pytest.approx(
        float(JO.global_norm(jg)), rel=1e-6)
    for max_norm in (0.5, 1e3):
        (jc, jn), (tc, tn) = (JO.clip_by_global_norm(jg, max_norm),
                              O.clip_by_global_norm(tg, max_norm))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for (_, w), t in zip(jax_leaves(jc), leaves(tc)):
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=1e-7)


def test_grad_compress_codes_and_error_feedback_match_the_reference():
    jerr, terr = None, None
    for step in range(3):
        gs, _ = adam_trees(20 + step)
        gs["b"]["c"][:] = 0.0                # an all-zero leaf: scale 1e-12
        (jq, js), jerr = JGC.compress_tree(
            jax.tree_util.tree_map(jnp.asarray, gs), jerr)
        (tq, ts), terr = GC.compress_tree(
            jax.tree_util.tree_map(torch.from_numpy, gs), terr)
        for (k, w), t in zip(jax_leaves(jq), leaves(tq)):
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
        for (_, w), t in zip(jax_leaves(js), leaves(ts)):
            assert float(t) == pytest.approx(float(w), rel=1e-7)
        for (_, w), t in zip(jax_leaves(jerr), leaves(terr)):
            np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-6)
        for x, q, sc in zip(leaves(GC.decompress_tree(tq, ts)), leaves(tq),
                            leaves(ts)):
            assert torch.equal(x, q.float() * sc)
    # a half-way value rounds to even, as jnp.round does
    q, s = GC.quantize_int8(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5]))
    assert float(s) == 1.0 and q.tolist() == [127, 0, 2, 2, 0]


# ---------------------------------------------------------------------------
# the train step, the trainer, the entry points
# ---------------------------------------------------------------------------

def jax_leaf_at(jtree, path):
    """The JAX (stacked) tree's value at a port keystr path: dict keys
    walk the tree, list indices pick along the stacked leading axes."""
    node, index = jtree, []
    for key, i in re.findall(r"\['([^']*)'\]|\[(\d+)\]", path):
        if key:
            node = node[key]
        else:
            index.append(int(i))
    return np.asarray(node)[tuple(index)]


def load_from_jax(ttree, jtree):
    """Write the JAX tree's values into the port's tensors, in place."""
    with torch.no_grad():
        for path, t in flatten_with_paths(ttree):
            t.copy_(torch.from_numpy(np.array(jax_leaf_at(jtree, path),
                                              np.float32)).to(t.dtype))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_jax(arch, compress):
    """Three steps with microbatches=2 on the same batch, each from the
    reference's parameters, moments and error-feedback buffers of the
    step before (written into the port's tensors): the loss and grad
    norm within 1e-4, the parameters (updated in place) and moments
    within 1e-4 of each leaf's max |value|, or 2e-2 with compression.

    Each step starts from the reference's state because the trajectory
    itself is sensitive: from identical weights, RWKV-6's grad norm
    after two steps at this lr moved by 2e-3 on parameters 5e-6 apart,
    while its gradients at equal parameters agree within 3e-5.  AdamW's
    eps is 1e-3: at its default 1e-8 an element whose gradient is near
    1e-8 moves by an O(1) share of lr on a rounding difference.  With
    compression a code whose corrected gradient sits within rounding of
    a half step rounds the other way on one stack: its gradient moves by
    one code, 1/127 of the leaf's max |g|, and its moment by a tenth of
    that a step (RWKV-6's ``wg`` moment: 1.07e-2 of its max), its
    parameter by about lr times a code over eps."""
    jm, params, tm = pair(arch, seed=2)
    batch = make_batch(jm.cfg, b=4, s=16)
    cfg = dict(lr=3e-3, warmup_steps=1, eps=1e-3)
    jopt, topt = JO.AdamW(JO.AdamWConfig(**cfg)), O.AdamW(O.AdamWConfig(**cfg))
    jstep = jax.jit(jax_train_step(jm, jopt, microbatches=2,
                                   compress_grads=compress))
    tstep = make_train_step(tm, topt, microbatches=2, compress_grads=compress)
    js, ts = jopt.init(params), topt.init(tm.params)
    jef = tef = None
    jp, tp = params, tm.params
    tol = 2e-2 if compress else 1e-4
    for step in range(3):
        if step:                              # the reference's state
            load_from_jax(tp, jp)
            load_from_jax({"m": ts.m, "v": ts.v}, {"m": js.m, "v": js.v})
            if compress:
                load_from_jax(tef, jef)
        jp, js, jef, jmet = jstep(jp, js, jef, jbatch(batch))
        tp, ts, tef, tmet = tstep(tp, ts, tef, batch)
        for key in ("loss", "grad_norm"):
            assert abs(float(tmet[key]) - float(jmet[key])) <= \
                1e-4 * abs(float(jmet[key])), (step, key)
        assert tp is tm.params and int(ts.step) == step + 1
        check_tree(to_numpy(tp), jp, tol)
        check_tree(to_numpy(ts.m), js.m, tol)
    assert (tef is None) == (not compress)
    if compress:
        assert sorted(paths(tef)) == sorted(paths(tp))


def test_one_microbatch_keeps_the_parameter_dtype_and_eval_step():
    _, _, tm = pair("granite-8b")
    opt = O.AdamW(O.AdamWConfig(clip_norm=None))
    seen = []
    step = make_train_step(tm, opt)
    orig = opt.update

    def spy(grads, state, params):
        seen.extend(t.dtype for t in leaves(grads))
        return orig(grads, state, params)

    opt.update = spy
    batch = make_batch(tm.cfg)
    before = float(make_eval_step(tm)(tm.params, batch))
    _, _, _, met = step(tm.params, opt.init(tm.params), None, batch)
    assert set(seen) == {torch.float32} and "grad_norm" not in met
    assert float(met["loss"]) == pytest.approx(before, rel=1e-6)


def test_layouts_are_the_identity_on_plain_trees_and_batches_split_evenly():
    """``grad_shardings`` and ``param_gather_shardings`` pin layouts of
    DTensor trees (``tests/test_torch_dist.py``); on a plain tree, which
    has none, the step is the same bit for bit.  A batch that does not
    split into the microbatches raises."""
    from repro_torch.dist.sharding import P, map_specs
    steps = []
    for kw in ({}, {"grad_shardings": True, "param_gather_shardings": True}):
        _, _, tm = pair("granite-8b")
        specs = tm.param_pspecs(1)
        kw = {k: map_specs(lambda s: P(*s), specs) for k in kw}
        opt = O.AdamW()
        step = make_train_step(tm, opt, microbatches=2, **kw)
        params, _, _, met = step(tm.params, opt.init(tm.params), None,
                                 make_batch(tm.cfg, b=4))
        steps.append((float(met["loss"]), [t.clone() for t in
                                           leaves(params)]))
    assert steps[0][0] == steps[1][0]
    assert all(torch.equal(a, b) for a, b in zip(steps[0][1], steps[1][1]))
    opt = O.AdamW()
    step = make_train_step(tm, opt, microbatches=2)
    with pytest.raises(ValueError, match="2 microbatches"):
        step(tm.params, opt.init(tm.params), None, make_batch(tm.cfg, b=3))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_two_train_steps_reduce_loss_direction(arch):
    """``tests/test_models.py``'s check on the port: a few AdamW steps on
    a fixed batch reduce the loss."""
    cfg = TC.reduced_config(TC.get_config(arch))
    model = TC.build_model(cfg, device="cpu", seed=2)
    batch = make_batch(cfg, b=4, s=16)
    opt = O.AdamW(O.AdamWConfig(lr=3e-3, warmup_steps=1))
    step = make_train_step(model, opt, microbatches=2)
    state, ef, params, losses = opt.init(model.params), None, model.params, []
    for _ in range(3):
        params, state, ef, met = step(params, state, ef, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0]


def trainer_for(tmp_path, steps, **kw):
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = TC.reduced_config(TC.get_config("granite-8b"))
    model = TC.build_model(cfg, device="cpu", seed=0)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=4))
    opt = O.AdamW(O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
    return model, Trainer(model, opt, data, TrainerConfig(
        steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path), keep_last=2,
        microbatches=2, log_every=1, **kw))


def test_trainer_resumes_where_it_stopped(tmp_path, capsys):
    """Six steps straight against four, then a second trainer resuming
    at step 4 (the stateless data cursor): the same losses and the same
    parameters; checkpoints every 2 steps, 2 kept."""
    _, whole = trainer_for(tmp_path / "a", 6)
    p_whole, _ = whole.run()
    model, first = trainer_for(tmp_path / "b", 4)
    first.run()
    assert first.ckpt.all_steps() == [2, 4]
    _, second = trainer_for(tmp_path / "b", 6)
    p_res, _ = second.run()
    assert "[trainer] resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in second.history] == [4, 5]
    losses = [h["loss"] for h in whole.history]
    assert [h["loss"] for h in first.history] == losses[:4]
    assert [h["loss"] for h in second.history] == losses[4:]
    assert p_res is second.model.params
    for a, b in zip(leaves(p_res), leaves(p_whole)):
        assert torch.equal(a, b)
    assert second.ckpt.all_steps() == [4, 6]
    assert len(second.step_times) == 2 and second.stragglers == 0


def test_trainer_checkpoints_on_preemption(tmp_path):
    _, tr = trainer_for(tmp_path, 6)
    tr._preempted = True                      # as the signal handler sets it
    tr.run()
    assert [h["step"] for h in tr.history] == [0]
    assert tr.ckpt.latest_step() == 1


def test_trainer_loss_falls_with_compression(tmp_path):
    _, tr = trainer_for(tmp_path, 6, compress_grads=True)
    tr.run()
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


def run_child(*args):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src"),
                               "OMP_NUM_THREADS": "2"})


def test_launcher_on_the_cpu(tmp_path):
    out = run_child("-m", "repro_torch.launch.train", "--arch", "granite-8b",
                    "--reduced", "--steps", "4", "--batch", "4", "--seq",
                    "16", "--microbatches", "2", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "[trainer] step 0 loss" in out.stdout
    assert "[train] done on cpu; stragglers=" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000004"]
    vlm = run_child("-m", "repro_torch.launch.train", "--arch",
                    "qwen2-vl-72b", "--reduced", "--device", "cpu")
    assert vlm.returncode != 0
    assert "use examples/train_tiny_lm_torch.py" in vlm.stderr


def test_example_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_tiny_lm_torch.py"),
         "--steps", "6", "--arch", "granite-8b", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "2", "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[example] granite-8b loss ")
    assert last.endswith("over 6 steps on cpu")
    assert os.listdir(tmp_path / "repro_torch_tiny_ckpt") == [
        "step_000000006"]


def test_launcher_needs_cuda_by_default(monkeypatch):
    """Without ``--device`` the launcher builds on the card and raises
    where CUDA is absent, before any step."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-8b", "--reduced", "--steps", "1"])

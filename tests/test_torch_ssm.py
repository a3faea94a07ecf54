"""The port's SSM and hybrid LMs on the CPU against the JAX package's.

RWKV-6's recurrence: the port's plain ``rwkv6_scan_ref`` (what
``ops.rwkv6_scan`` runs for a CPU tensor) against the JAX Pallas kernel
in interpret mode and the JAX sequential ``ref.rwkv6_scan_ref``, at
``tests/test_kernels.py``'s shapes plus a given initial state and t = 1.
The blocks (``rwkv6_block``, ``mamba2_block``, with and without state)
and the whole models (``rwkv6-7b`` and ``zamba2-2.7b`` at
``reduced_config``, fp32, JAX weights bridged with ``lm_from_numpy``):
``prefill`` logits and cache, ``decode_step`` logits and cache,
``hidden``.  Tolerance: 1e-4 of the reference's max |value|, as
``tests/test_torch_lm.py``.  The JAX blocks run the chunked forms
(``rwkv6_chunked``, chunked SSD) and the port's RWKV-6 the sequential
recurrence; both are fp32 and differ only in summation order, which
stays far inside that bound at these sizes.  Also the port's own
prefill/decode consistency, and the dtype of the fp32 parameter leaves
through the bridge and the seeded init.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.models import ssm as JS
import repro_torch.configs as TC
from repro_torch.kernels import ops, ref
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS
from repro_torch.models.bridge import lm_from_numpy
from repro_torch.vae.bridge import params_from_numpy

torch.set_num_threads(2)

SSM_ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
FP32_LEAVES = {"rwkv6-7b": ("w0", "u"),
               "zamba2-2.7b": ("A_log", "D", "dt_bias")}


def close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def flat(tree, prefix=""):
    """A nested cache dict as {"ssm.s": leaf, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def close_caches(tc, jc):
    ft, fj = flat(tc), flat(jc)
    assert set(ft) == set(fj)
    for key, want in fj.items():
        if key == "pos":
            np.testing.assert_array_equal(ft[key].numpy(), np.asarray(want))
        else:
            close(ft[key], want)


def scan_inputs(n, h, t, d, seed, with_state):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.3 - 1.0
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.3
    s0 = (rng.standard_normal((n, h, d, d)).astype(np.float32) * 0.5
          if with_state else None)
    return r, k, v, w, u, s0


# the shapes of tests/test_kernels.py::test_rwkv6_scan, then a given
# initial state, and one token (a decode step)
SCAN_CASES = [(1, 2, 32, 16, 16, False), (2, 4, 64, 32, 32, False),
              (1, 1, 48, 8, 8, False), (2, 3, 40, 16, 8, True),
              (4, 2, 1, 32, 64, True)]


@pytest.mark.parametrize("n,h,t,d,chunk,with_state", SCAN_CASES)
def test_rwkv6_scan_ref_matches_jax(n, h, t, d, chunk, with_state):
    r, k, v, w, u, s0 = scan_inputs(n, h, t, d, 7 + t, with_state)
    jstate = None if s0 is None else jnp.asarray(s0)
    jo, js = jax_rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                            jstate, chunk=chunk, interpret=True)
    ro, rs = jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                 jstate)
    to, ts = ref.rwkv6_scan_ref(
        *(torch.from_numpy(a) for a in (r, k, v, w, u)),
        None if s0 is None else torch.from_numpy(s0))
    assert to.dtype == torch.float32 and ts.dtype == torch.float32
    for want_o, want_s in ((jo, js), (ro, rs)):
        close(to, want_o)
        close(ts, want_s)


# t a multiple of the 32-token chunk, t that halves it to 8 (40) and to 1
# (an odd 33), a given state, one token
CHUNKED_CASES = [(2, 3, 64, 16, True), (1, 2, 40, 8, False),
                 (1, 2, 33, 8, True), (2, 2, 1, 16, True)]


@pytest.mark.parametrize("n,h,t,d,with_state", CHUNKED_CASES)
def test_rwkv6_chunked_ref_and_its_gradients_match_jax(n, h, t, d,
                                                       with_state):
    """``ref.rwkv6_chunked_ref`` (what ``RWKV6Scan``'s backward
    differentiates) against the JAX package's ``rwkv6_chunked``: out and
    final state, and their vector-Jacobian product with seeded
    cotangents for r, k, v, w, u and the state.  1e-4 of each
    reference's max |value|."""
    r, k, v, w, u, s0 = scan_inputs(n, h, t, d, 11 + t, with_state)
    if s0 is None:
        s0 = np.zeros((n, h, d, d), np.float32)
    rng = np.random.default_rng(t)
    dout = rng.standard_normal((n, h, t, d)).astype(np.float32)
    dst = rng.standard_normal((n, h, d, d)).astype(np.float32)
    ins = (r, k, v, w, u, s0)
    (jo, js), vjp = jax.vjp(JS.rwkv6_chunked,
                            *(jnp.asarray(a) for a in ins))
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dst)))
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    to, ts = ref.rwkv6_chunked_ref(*tins)
    tgrads = torch.autograd.grad((to, ts), tins, (torch.from_numpy(dout),
                                                  torch.from_numpy(dst)))
    close(to.detach(), jo)
    close(ts.detach(), js)
    for got, want in zip(tgrads, jgrads):
        close(got, want)


def test_rwkv6_scan_on_cpu_updates_a_given_state_in_place():
    """``out_state=state`` (the decode step's in-place cache update) gives
    the same final state as a fresh one, written into the given tensor;
    a bf16 r keeps its dtype in the output."""
    r, k, v, w, u, s0 = scan_inputs(2, 3, 5, 16, 3, True)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    want_o, want_s = ops.rwkv6_scan(*t)
    state = t[5].clone()
    got_o, got_s = ops.rwkv6_scan(*t[:5], state, out_state=state)
    assert got_s is state
    assert torch.equal(state, want_s) and torch.equal(got_o, want_o)
    bf = [a.to(torch.bfloat16) for a in t[:3]]
    out, fin = ops.rwkv6_scan(*bf, t[3], t[4], t[5])
    assert out.dtype == torch.bfloat16 and fin.dtype == torch.float32
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*t[:4], t[4][:, :8], t[5])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def block_pair(arch, seed):
    """(JAX cfg, port cfg, JAX block params, the same as port tensors)."""
    jcfg = RC.reduced_config(RC.get_config(arch))
    tcfg = TC.reduced_config(TC.get_config(arch))
    init = JS.rwkv6_init if jcfg.ssm_type == "rwkv6" else JS.mamba2_init
    jp = init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def block_state(cfg, b, rng):
    """A random state of the block's shapes (numpy)."""
    init = (JS.rwkv6_state_init if cfg.ssm_type == "rwkv6"
            else JS.mamba2_state_init)
    return {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
            for k, v in init(cfg, b).items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_block_matches_jax(arch, with_state):
    jcfg, tcfg, jp, tp = block_pair(arch, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 19, tcfg.d_model)).astype(np.float32)
    st = block_state(jcfg, 2, rng) if with_state else None
    jblock = JS.rwkv6_block if jcfg.ssm_type == "rwkv6" else JS.mamba2_block
    tblock = TS.rwkv6_block if tcfg.ssm_type == "rwkv6" else TS.mamba2_block
    jo, jst = jblock(jp, jnp.asarray(x), jcfg,
                     None if st is None
                     else {k: jnp.asarray(v) for k, v in st.items()})
    tst = None if st is None else {k: torch.from_numpy(v.copy())
                                   for k, v in st.items()}
    views = dict(tst) if tst is not None else None
    with torch.inference_mode():
        to, tst2 = tblock(tp, torch.from_numpy(x), tcfg, tst)
    close(to, jo)
    if st is None:
        assert jst is None and tst2 is None
        return
    assert set(tst2) == set(jst)
    for key in jst:
        assert tst2[key] is views[key]          # written in place
        close(tst2[key], jst[key])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_block_decode_steps_continue_the_state(arch):
    """One block over 12 tokens equals the block over 9 then 3 single
    steps, each continuing from the state the last left (port only)."""
    _, tcfg, _, tp = block_pair(arch, seed=13)
    block = TS.rwkv6_block if tcfg.ssm_type == "rwkv6" else TS.mamba2_block
    init = (TS.rwkv6_state_init if tcfg.ssm_type == "rwkv6"
            else TS.mamba2_state_init)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        full, _ = block(tp, x, tcfg, init(tcfg, 2))
        state = init(tcfg, 2)
        parts = [block(tp, x[:, :9], tcfg, state)[0]]
        for t in range(9, 12):
            parts.append(block(tp, x[:, t:t + 1], tcfg, state)[0])
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(),
                               atol=1e-5)


def test_rwkv6_block_routes_the_recurrence_through_ops(monkeypatch):
    """The block's recurrence is ``ops.rwkv6_scan`` (the kernel's entry
    point): one call per block, with the block's state as both the
    initial and the final state."""
    _, tcfg, _, tp = block_pair("rwkv6-7b", seed=15)
    calls = []
    real = ops.rwkv6_scan

    def spy(*args, **kw):
        calls.append((args[5], kw.get("out_state")))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "rwkv6_scan", spy)
    state = TS.rwkv6_state_init(tcfg, 2)
    x = torch.zeros((2, 3, tcfg.d_model))
    with torch.inference_mode():
        TS.rwkv6_block(tp, x, tcfg, state)
        TS.rwkv6_block(tp, x, tcfg)
    assert len(calls) == 2
    assert calls[0][0] is state["s"] and calls[0][1] is state["s"]
    assert calls[1] == (None, None)


# ---------------------------------------------------------------------------
# the whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SSM_ARCHS)
def model_pair(request):
    arch = request.param
    jcfg = RC.reduced_config(RC.get_config(arch))
    tcfg = TC.reduced_config(TC.get_config(arch))
    jm = RC.build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(4))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, lm_from_numpy(tcfg, tree, device="cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_prefill_and_decode_match_jax(model_pair):
    """Prefill of 13 tokens into a 16-slot cache, then 3 decode steps:
    logits and every cache leaf (SSM states, shared-block k/v, pos)."""
    jm, params, tm = model_pair
    toks = tokens(tm.cfg, 2, 16, seed=5)
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :13]), max_len=16)
    tl, tc = tm.prefill(toks[:, :13], max_len=16)
    close(tl, jl)
    close_caches(tc, jc)
    for t in range(13, 16):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
        tl, tc = tm.decode_step(tc, toks[:, t])
        close(tl, jl)
        close_caches(tc, jc)


def test_hidden_and_logits_match_jax(model_pair):
    jm, params, tm = model_pair
    toks = tokens(tm.cfg, 2, 11, seed=6)
    jh = jm.hidden(params, jnp.asarray(toks))
    th = tm.hidden(toks)
    close(th, jh)
    close(tm.logits(th), jm.logits(params, jh))


def test_cache_layout_matches_jax(model_pair):
    jm, _, tm = model_pair
    jc = flat(jm.init_cache(3, 20))
    tc = flat(tm.init_cache(3, 20))
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for k, v in tc.items():
        assert str(v.dtype).split(".")[-1] == str(jc[k].dtype)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_decode_consistency(arch):
    """As ``tests/test_models.py``: the prefill's last logits and two
    decode steps' equal the full forward's at those positions."""
    cfg = TC.reduced_config(TC.get_config(arch))
    model = TC.build_model(cfg, device="cpu", seed=1)
    b, s = 2, 20
    toks = tokens(cfg, b, s, seed=4)
    full = model.logits(model.hidden(toks)).numpy()
    pl, cache = model.prefill(toks[:, :s - 2], max_len=s + 2)
    np.testing.assert_allclose(pl.numpy(), full[:, s - 3], atol=5e-3)
    for t in (s - 2, s - 1):
        dl, cache = model.decode_step(cache, toks[:, t])
        np.testing.assert_allclose(dl.numpy(), full[:, t], atol=5e-3)
    assert int(cache["pos"][0]) == s


def test_shared_block_runs_after_every_attn_every_th_layer():
    """zamba2 at reduced size (4 layers, attn_every 2): the shared block's
    k/v cache has one slot per application, and both are written."""
    cfg = TC.reduced_config(TC.get_config("zamba2-2.7b"))
    model = TC.build_model(cfg, device="cpu", seed=2)
    _, cache = model.prefill(tokens(cfg, 1, 6), max_len=8)
    napp = cfg.n_layers // cfg.attn_every
    assert cache["shared_k"].shape[0] == napp == 2
    for a in range(napp):
        assert float(cache["shared_k"][a, :, :, :6].abs().sum()) > 0
        assert float(cache["shared_k"][a, :, :, 6:].abs().sum()) == 0


# ---------------------------------------------------------------------------
# dtypes: fp32 leaves stay fp32 (the bridge and the seeded init)
# ---------------------------------------------------------------------------

def leaves_by_name(params):
    out = []

    def walk(tree, name):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, name)
        else:
            out.append((name, tree))
    walk(params, None)
    return out


def check_leaf_dtypes(params, fp32_names):
    seen = set()
    for name, t in leaves_by_name(params):
        if name in fp32_names:
            assert t.dtype == torch.float32, name
            seen.add(name)
        else:
            assert t.dtype == torch.bfloat16, name
    assert seen == set(fp32_names)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bridge_keeps_fp32_leaves_exact(arch):
    """A bf16 model: the JAX tree's fp32 leaves arrive fp32 and bit-exact
    (not rounded through bf16), the bf16 leaves bf16 and exact."""
    jcfg = dataclasses.replace(RC.reduced_config(RC.get_config(arch)),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)),
                               dtype=torch.bfloat16)
    params = RC.build_model(jcfg).init(jax.random.PRNGKey(8))
    # data-dependent fp32 values that bf16 cannot hold
    mix = params["layers"]["mix"]
    for name in FP32_LEAVES[arch]:
        mix[name] = mix[name] + jnp.float32(1.0 / 3.0)
        assert mix[name].dtype == jnp.float32
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = lm_from_numpy(tcfg, tree, device="cpu")
    check_leaf_dtypes(tm.params, FP32_LEAVES[arch])
    for name in FP32_LEAVES[arch]:
        want = np.asarray(mix[name])
        got = np.stack([p["mix"][name].numpy() for p in tm.params["layers"]])
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.params["embed"].float().numpy(),
        np.asarray(params["embed"], np.float32))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_seeded_init_keeps_fp32_leaves(arch):
    cfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)),
                              dtype=torch.bfloat16)
    model = TC.build_model(cfg, device="cpu", seed=0)
    check_leaf_dtypes(model.params, FP32_LEAVES[arch])
    logits, cache = model.prefill(tokens(cfg, 1, 5), max_len=7)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert cache["ssm"][("s" if arch == "rwkv6-7b" else "h")].dtype == \
        torch.float32


def test_full_width_configs():
    """The published widths: parameter counts by ``param_count`` (the
    projections and embeddings; the trees also hold lerps, LoRA, norms
    and the small SSM vectors) and the shapes the smoke run serves."""
    rw, zb = TC.get_config("rwkv6-7b"), TC.get_config("zamba2-2.7b")
    assert rw.param_count() == 6_979_321_856
    assert zb.param_count() == 2_338_897_920
    assert (rw.n_layers, rw.d_model, rw.d_model // rw.ssm_head_dim,
            rw.ssm_head_dim, rw.d_ff, rw.vocab_size, rw.tie_embeddings) == \
        (32, 4096, 64, 64, 14336, 65536, False)
    assert (zb.n_layers, zb.d_model, zb.ssm_expand * zb.d_model,
            zb.ssm_expand * zb.d_model // zb.ssm_head_dim, zb.ssm_state,
            zb.conv_width, zb.attn_every, zb.n_heads, zb.head_dim, zb.d_ff,
            zb.tie_embeddings) == \
        (54, 2560, 5120, 80, 64, 4, 6, 32, 80, 10240, True)
    assert set(TL.CAUSAL_FAMILIES) | {"encdec"} == \
        {TC.get_config(a).family for a in TC.ARCH_IDS}

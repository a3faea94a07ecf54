"""The port's dense causal LM on the CPU against the JAX package's.

For the four dense architectures at ``reduced_config`` (fp32), the JAX
``CausalLM.init`` tree is bridged into the port (``lm_from_numpy``) and
both stacks run the same numpy-seeded tokens: prefill logits and KV
cache, ``decode_step`` logits and ``hidden`` agree within 1e-4 of the
reference's max |value| (fp32 with other summation orders).  Also a
sliding window with a prompt longer than the window (the cache roll),
one case with the JAX side on its Pallas kernels in interpret mode, the
port's own prefill/decode consistency (atol 5e-3, as
``tests/test_models.py``), the config registry, and every other family
built as the JAX package builds it.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
from repro.kernels import ops as jops
import repro_torch.configs as TC
from repro_torch.models.bridge import lm_from_numpy

torch.set_num_threads(2)

DENSE = ["qwen2-7b", "qwen3-14b", "granite-8b", "phi4-mini-3.8b"]


def configs(arch, **kw):
    jcfg = dataclasses.replace(RC.reduced_config(RC.get_config(arch)), **kw)
    tcfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)), **kw)
    return jcfg, tcfg


def pair(arch, seed=0, **kw):
    jcfg, tcfg = configs(arch, **kw)
    jm = RC.build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, lm_from_numpy(tcfg, tree, device="cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def check_serving(jm, params, tm, toks, max_len, steps):
    """prefill on all but the last ``steps`` tokens, then ``steps`` decode
    steps: logits and caches of both stacks after each."""
    s = toks.shape[1] - steps
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :s]), max_len=max_len)
    tl, tc = tm.prefill(toks[:, :s], max_len=max_len)
    close(tl, jl)
    for key in ("k", "v"):
        close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for t in range(s, s + steps):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
        tl, tc = tm.decode_step(tc, toks[:, t])
        close(tl, jl)
        for key in ("k", "v"):
            close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    jm, params, tm = pair(arch)
    check_serving(jm, params, tm, tokens(tm.cfg, 2, 15), max_len=16,
                  steps=2)


@pytest.mark.parametrize("arch", DENSE)
def test_hidden_and_logits_match_jax(arch):
    jm, params, tm = pair(arch, seed=1)
    toks = tokens(tm.cfg, 2, 11, seed=1)
    jh = jm.hidden(params, jnp.asarray(toks))
    th = tm.hidden(toks)
    close(th, jh)
    close(tm.logits(th), jm.logits(params, jh))


def test_sliding_window_roll_matches_jax():
    """A prompt of 21 tokens against an 8-token window: the prefill keeps
    the last 8 positions rolled into their ring slots, and decode steps
    overwrite the oldest slot."""
    jm, params, tm = pair("qwen2-7b", seed=2, sliding_window=8)
    check_serving(jm, params, tm, tokens(tm.cfg, 2, 24, seed=2),
                  max_len=30, steps=3)


def test_against_jax_pallas_kernels_in_interpret_mode():
    jm, params, tm = pair("granite-8b", seed=3)
    jops.set_default_impl("pallas_interpret")
    try:
        check_serving(jm, params, tm, tokens(tm.cfg, 2, 12, seed=3),
                      max_len=16, steps=1)
    finally:
        jops.set_default_impl("xla")


@pytest.mark.parametrize("arch,window", [(a, None) for a in DENSE]
                         + [("phi4-mini-3.8b", 8)])
def test_prefill_decode_consistency(arch, window):
    """As ``tests/test_models.py``: the prefill's last logits and one
    decode step's equal the full forward's at those positions."""
    cfg = dataclasses.replace(TC.reduced_config(TC.get_config(arch)),
                              sliding_window=window)
    model = TC.build_model(cfg, device="cpu", seed=1)
    b, s = 2, 20
    toks = tokens(cfg, b, s, seed=4)
    full = model.logits(model.hidden(toks)).numpy()
    pl, cache = model.prefill(toks[:, :s - 1], max_len=s + 2)
    np.testing.assert_allclose(pl.numpy(), full[:, s - 2], atol=5e-3)
    dl, cache = model.decode_step(cache, toks[:, s - 1])
    np.testing.assert_allclose(dl.numpy(), full[:, s - 1], atol=5e-3)
    assert int(cache["pos"][0]) == s


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_match_the_reference(arch):
    jfull, tfull = RC.get_config(arch), TC.get_config(arch)
    assert tfull.param_count() == jfull.param_count()
    assert tfull.active_param_count() == jfull.active_param_count()
    assert tfull.dtype == torch.bfloat16
    jred, tred = configs(arch)
    jd, td = dataclasses.asdict(jred), dataclasses.asdict(tred)
    assert jd.pop("dtype") == jnp.float32 and td.pop("dtype") == torch.float32
    assert td == jd
    shape = RC.LM_SHAPES["long_500k"]
    assert TC.cell_applicable(tfull, TC.LM_SHAPES["long_500k"]) == \
        RC.cell_applicable(jfull, shape)


def test_qwen2_7b_full_width_parameter_count():
    cfg = TC.get_config("qwen2-7b")
    assert cfg.param_count() == 7_615_283_200
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064)


@pytest.mark.parametrize("arch", [a for a in RC.ARCH_IDS
                                  if RC.get_config(a).family != "dense"])
def test_other_families_wait_for_their_slice(arch):
    """Every family builds, as the JAX package's ``build_model`` builds
    it: an ``EncDecLM`` for enc-dec, a ``CausalLM`` for the rest
    (``tests/test_torch_{moe,ssm,encdec,vlm}.py`` hold them to the JAX
    package), with the reference's parameter count, and ``loss`` gives a
    finite scalar (``tests/test_torch_train.py`` holds it and its
    gradients to the JAX package)."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import CausalLM
    cfg = TC.reduced_config(TC.get_config(arch))
    model = TC.build_model(cfg, device="cpu")
    jm = RC.build_model(RC.reduced_config(RC.get_config(arch)))
    assert type(model).__name__ == type(jm).__name__
    assert isinstance(model, EncDecLM if cfg.family == "encdec"
                      else CausalLM)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))))
    assert model.n_params == want
    toks = tokens(cfg, 2, 6)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((2, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    loss = model.loss(batch)
    assert loss.shape == () and bool(torch.isfinite(loss))


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device, the LM, its bridge and the VAE bridge run on the
    card, and raise where CUDA is absent instead of falling back."""
    from repro_torch.vae.bridge import vae_from_numpy
    from repro_torch.vae.model import DEMO_VAE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.reduced_config(TC.get_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        vae_from_numpy(DEMO_VAE, {})

"""The port's MoE on the CPU against the JAX package's.

``blocks.moe`` alone on the same numpy-seeded inputs and the JAX
``moe_init`` weights: at the reduced configs' capacity factor 8.0 (no
entry dropped), at the published 1.25 with batches that drop entries
(a step of 4 tokens has capacity round(2.5) = 2, Python's round taking
halves to even, as the reference does), and with kimi-k2's many experts
and top-8 (E = 16, k = 8, capacity factor 1.0), within 1e-5 of the
reference's max |value|.  The whole models (mixtral-8x7b and
kimi-k2-1t-a32b at ``reduced_config``, fp32, JAX weights bridged with
``lm_from_numpy``): prefill and decode logits and KV caches within 1e-4
(``tests/test_torch_lm.py``'s ``check_serving``), also at the published
capacity, where the decode steps drop entries, and once with the JAX
side on its Pallas kernels in interpret mode.  Also the capacity rule,
the fp32 router in a bf16 model, and the port's own prefill/decode
consistency at a capacity that drops nothing.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.models import blocks as JB
import repro_torch.configs as TC
from repro_torch.models import blocks as TB
from test_torch_lm import check_serving, close, configs, pair, tokens

torch.set_num_threads(2)

MOE = ["mixtral-8x7b", "kimi-k2-1t-a32b"]


def dropped(x, router, cfg, cf):
    """The (token, choice) entries ranked at or past the capacity, by the
    rule spelled out in numpy: top-k of the softmax, ranks counted token
    by token and choice by choice."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1).astype(np.float64) @ router.astype(np.float64)
    idx = np.argsort(-logits, axis=-1,
                     kind="stable")[:, :cfg.experts_per_token]
    cap = max(1, round(t * cfg.experts_per_token / cfg.n_experts * cf))
    seen = np.zeros(cfg.n_experts, int)
    n = 0
    for e in idx.reshape(-1):
        n += seen[e] >= cap
        seen[e] += 1
    return int(n)


# (arch, config overrides, batch, seq, capacity factor, entries dropped)
MOE_CASES = [
    ("mixtral-8x7b", {}, 2, 9, None, False),
    ("mixtral-8x7b", {}, 4, 1, 1.25, True),      # a decode step: cap 2
    ("mixtral-8x7b", {}, 3, 5, 1.25, True),
    ("mixtral-8x7b", {}, 2, 6, 1.25, True),      # cap round(7.5) = 8
    ("kimi-k2-1t-a32b", dict(n_experts=16, experts_per_token=8,
                             capacity_factor=1.0), 2, 6, None, True),
    ("kimi-k2-1t-a32b", dict(n_experts=16, experts_per_token=8,
                             capacity_factor=1.0), 4, 1, None, True),
]


@pytest.mark.parametrize("arch,kw,b,s,cf,drops", MOE_CASES)
def test_moe_matches_jax(arch, kw, b, s, cf, drops):
    jcfg, tcfg = configs(arch, **kw)
    jp = JB.moe_init(jax.random.PRNGKey(b * 10 + s), jcfg)
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jp.items()}
    x = np.random.default_rng(s).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    n_drop = dropped(x, np.asarray(jp["router"]), tcfg,
                     cf or tcfg.capacity_factor)
    assert (n_drop > 0) == drops, n_drop
    want = JB.moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    got = TB.moe(tp, torch.from_numpy(x), tcfg, capacity_factor=cf)
    close(got, want, tol=1e-5)


@pytest.mark.parametrize("t,cf,cap", [(4, 1.25, 1), (8, 1.25, 2),
                                      (24, 1.25, 8), (1, 1.25, 1),
                                      (8192, 1.25, 2560), (4, 4.0, 4),
                                      (8196, 4.0, 8196)])
def test_capacity_is_the_references_rule(t, cf, cap):
    """Switch-style capacity at mixtral's E = 8, k = 2: a decode step of 4
    tokens has 1 slot per expert, halves round to even (2.5 -> 2, 7.5 ->
    8), at least 1; cap = T at capacity factor E / k."""
    cfg = TC.get_config("mixtral-8x7b")
    assert TB.moe_capacity(t, cfg, cf) == cap
    assert TB.moe_capacity(t, cfg) == TB.moe_capacity(t, cfg, 1.25)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch):
    jm, params, tm = pair(arch)
    check_serving(jm, params, tm, tokens(tm.cfg, 2, 15), max_len=16,
                  steps=2)


@pytest.mark.parametrize("arch", MOE)
def test_published_capacity_decode_drops_like_jax(arch):
    """At the published capacity factor each decode step of 4 tokens has
    cap 1 or 2 per expert and drops entries; both stacks drop the same
    ones."""
    jm, params, tm = pair(arch, seed=5, capacity_factor=1.25)
    check_serving(jm, params, tm, tokens(tm.cfg, 4, 13, seed=5), max_len=16,
                  steps=3)


def test_hidden_and_logits_match_jax():
    jm, params, tm = pair("kimi-k2-1t-a32b", seed=1)
    toks = tokens(tm.cfg, 2, 11, seed=1)
    jh = jm.hidden(params, jnp.asarray(toks))
    th = tm.hidden(toks)
    close(th, jh)
    close(tm.logits(th), jm.logits(params, jh))


def test_against_jax_pallas_kernels_in_interpret_mode():
    jm, params, tm = pair("mixtral-8x7b", seed=3)
    jops.set_default_impl("pallas_interpret")
    try:
        check_serving(jm, params, tm, tokens(tm.cfg, 2, 12, seed=3),
                      max_len=16, steps=1)
    finally:
        jops.set_default_impl("xla")


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency(arch):
    """The prefill's last logits and one decode step's equal the full
    forward's at those positions, at capacity factor E / k (cap = T:
    nothing drops)."""
    base = TC.reduced_config(TC.get_config(arch))
    cfg = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.experts_per_token)
    model = TC.build_model(cfg, device="cpu", seed=1)
    b, s = 2, 20
    toks = tokens(cfg, b, s, seed=4)
    full = model.logits(model.hidden(toks)).numpy()
    pl, cache = model.prefill(toks[:, :s - 1], max_len=s + 2)
    np.testing.assert_allclose(pl.numpy(), full[:, s - 2], atol=5e-3)
    dl, cache = model.decode_step(cache, toks[:, s - 1])
    np.testing.assert_allclose(dl.numpy(), full[:, s - 1], atol=5e-3)


def test_router_stays_fp32_in_a_bf16_model():
    cfg = dataclasses.replace(TC.reduced_config(TC.get_config("mixtral-8x7b")),
                              dtype=torch.bfloat16)
    model = TC.build_model(cfg, device="cpu", seed=2)
    for layer in model.params["layers"]:
        assert layer["moe"]["router"].dtype == torch.float32
        assert {layer["moe"][k].dtype for k in ("w_gate", "w_up", "w_down")} \
            == {torch.bfloat16}
        assert tuple(layer["moe"]["w_down"].shape) == \
            (cfg.n_experts, cfg.d_ff, cfg.d_model)
    logits, cache = model.prefill(tokens(cfg, 2, 7), max_len=9)
    logits, cache = model.decode_step(cache, tokens(cfg, 2, 1)[:, 0])
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())

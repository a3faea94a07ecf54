"""The port's VLM (M-RoPE, a vision-embeds prefix) on the CPU against the
JAX package's.

``apply_mrope`` against the reference's with distinct t, h and w
position streams (the model's text path broadcasts one stream, which
makes M-RoPE equal RoPE value for value, so only distinct streams test
the sections), at the reduced sections (4, 6, 6) and qwen2-vl-72b's
published (16, 24, 24).  qwen2-vl-72b at ``reduced_config`` (fp32, JAX
weights bridged with ``lm_from_numpy``) on the same numpy-seeded embeds
and tokens: ``hidden`` with the prefix (and with embeds alone), prefill
with the prefix and decode steps, logits and KV caches within 1e-4 of
the reference's max |value| (as ``tests/test_torch_lm.py``), once with
the JAX side on its Pallas kernels in interpret mode.  Also the port's
own decode-after-prefill consistency with the prefix.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.models import common as JC
import repro_torch.configs as TC
from repro_torch.models import common as TCm
from test_torch_lm import close, pair, tokens

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"


def embeds(cfg, b, p, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, p, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("sections,heads,seq", [((4, 6, 6), 4, 9),
                                                ((16, 24, 24), 2, 5),
                                                ((1, 2, 5), 3, 4)])
def test_apply_mrope_matches_jax_with_distinct_streams(sections, heads, seq):
    d = 2 * sum(sections)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, seq, heads, d)).astype(np.float32)
    # t, h and w ids that differ from each other and from the token index
    pos3 = np.stack([rng.integers(0, 50, (2, seq)) for _ in range(3)])
    assert len({tuple(p.reshape(-1)) for p in pos3}) == 3
    want = JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = TCm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                          sections)
    close(got, want, tol=1e-5)
    # each section follows its own stream: not RoPE of any one of them
    for s in range(3):
        rope = TCm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[s]),
                              1e6)
        assert float((rope - got).abs().max()) > 1e-3


def test_apply_mrope_with_one_stream_is_rope():
    x = torch.randn(2, 6, 4, 32)
    pos = torch.arange(6)[None].expand(2, 6)
    got = TCm.apply_mrope(x, pos[None].expand(3, 2, 6), 1e4, (4, 6, 6))
    torch.testing.assert_close(got, TCm.apply_rope(x, pos, 1e4))


def test_hidden_with_the_prefix_matches_jax():
    jm, params, tm = pair(ARCH, seed=1)
    emb, toks = embeds(tm.cfg, 2, 5, seed=1), tokens(tm.cfg, 2, 7, seed=1)
    jh = jm.hidden(params, jnp.asarray(toks), jnp.asarray(emb))
    th = tm.hidden(toks, embeds=emb)
    assert tuple(th.shape) == (2, 12, tm.cfg.d_model)
    close(th, jh)
    close(tm.logits(th), jm.logits(params, jh))
    close(tm.hidden(embeds=emb), jm.hidden(params, None, jnp.asarray(emb)))


def check_serving(jm, params, tm, emb, toks, max_len, steps):
    """prefill on the prefix and all but the last ``steps`` tokens, then
    ``steps`` decode steps: logits and caches of both stacks after each;
    ``pos`` counts the prefix."""
    s = toks.shape[1] - steps
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :s]),
                        embeds=jnp.asarray(emb), max_len=max_len)
    tl, tc = tm.prefill(toks[:, :s], max_len=max_len, embeds=emb)
    assert tc["pos"].tolist() == [emb.shape[1] + s] * toks.shape[0]
    for t in range(s, s + steps + 1):
        close(tl, jl)
        for key in ("k", "v"):
            close(tc[key], jc[key])
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        if t < s + steps:
            jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
            tl, tc = tm.decode_step(tc, toks[:, t])


def test_prefill_with_the_prefix_and_decode_match_jax():
    jm, params, tm = pair(ARCH)
    check_serving(jm, params, tm, embeds(tm.cfg, 2, 6), tokens(tm.cfg, 2, 9),
                  max_len=20, steps=3)


def test_against_jax_pallas_kernels_in_interpret_mode():
    jm, params, tm = pair(ARCH, seed=3)
    jops.set_default_impl("pallas_interpret")
    try:
        check_serving(jm, params, tm, embeds(tm.cfg, 2, 4, seed=3),
                      tokens(tm.cfg, 2, 6, seed=3), max_len=12, steps=1)
    finally:
        jops.set_default_impl("xla")


def test_prefill_decode_consistency_with_the_prefix():
    """decode_step on x after prefill(embeds, p) gives the last logits of
    prefill(embeds, p + [x]), and the full forward's at every position."""
    cfg = TC.reduced_config(TC.get_config(ARCH))
    model = TC.build_model(cfg, device="cpu", seed=1)
    emb, toks = embeds(cfg, 2, 5, seed=4), tokens(cfg, 2, 10, seed=4)
    full = model.logits(model.hidden(toks, embeds=emb)).numpy()
    pl, cache = model.prefill(toks[:, :9], max_len=16, embeds=emb)
    np.testing.assert_allclose(pl.numpy(), full[:, -2], atol=5e-3)
    dl, cache = model.decode_step(cache, toks[:, 9])
    np.testing.assert_allclose(dl.numpy(), full[:, -1], atol=5e-3)
    assert cache["pos"].tolist() == [15, 15]


def test_embeds_are_cast_to_the_model_dtype():
    import dataclasses
    cfg = dataclasses.replace(TC.reduced_config(TC.get_config(ARCH)),
                              dtype=torch.bfloat16)
    model = TC.build_model(cfg, device="cpu", seed=2)
    logits, cache = model.prefill(tokens(cfg, 1, 3), max_len=8,
                                  embeds=embeds(cfg, 1, 2).astype(np.float64))
    assert logits.dtype == torch.bfloat16 and cache["k"].dtype == \
        torch.bfloat16
    assert cache["pos"].tolist() == [5]

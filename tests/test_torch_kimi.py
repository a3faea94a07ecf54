"""kimi-k2-1t-a32b's own geometry on the CPU: the port against the JAX
package.

The MoE families' other tests run kimi-k2 at ``reduced_config`` (16
experts, head_dim 32).  Here it keeps what its serving phase on the card
gives the kernels and the router: head_dim 112 (8 q heads over 1 kv
head, so d_model 896), 384 experts, top-8 and the published capacity
factor 1.25, narrow elsewhere (d_ff 32, vocab 512), fp32, the JAX init
bridged with ``lm_from_numpy``:

- ``blocks.moe`` alone at T = 4 (cap 1, a decode step) and T = 64 (cap
  2), each dropping the entries ``tests/test_torch_moe.py``'s
  ``dropped`` rule counts, within 1e-5 of the reference's max |value|;
- a prefill of 2 x 24 tokens and 3 decode steps at 1 and 2 layers,
  logits and KV caches within 1e-4 (``check_serving``), once with the
  JAX side on its Pallas kernels in interpret mode (``flash_attention``
  and ``decode_attention`` at d 112); also the narrow fp32 twin that
  ``chip_smoke.py``'s crossdevice phase holds the card to
  (``CROSS_LMS``), so that twin is itself held to the JAX package;
- the fp32 per-token reference of the kimi phase's MoE check
  (``chip_smoke.moe_token_reference``) against ``blocks.moe`` in fp32 at
  384 experts: at capacity factor E / k (nothing drops) and at 1.25 (the
  rule's entries dropped, counted as ``dropped`` counts them), within
  1e-5, so a broken check shows here.
"""

import importlib.util
from pathlib import Path

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
from test_torch_moe import dropped

torch.set_num_threads(2)

ARCH = "kimi-k2-1t-a32b"
#: kimi-k2's head_dim, experts, top-k and capacity factor; narrow widths
GEOMETRY = dict(d_model=896, n_heads=8, n_kv_heads=1, n_experts=384,
                experts_per_token=8, capacity_factor=1.25, d_ff=32,
                vocab_size=512)


def smoke():
    """``chip_smoke.py`` as a module (it imports nothing heavy at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_geometry_is_kimis():
    _, tcfg = configs(ARCH, **GEOMETRY)
    assert tcfg.head_dim == 112 and tcfg.n_heads // tcfg.n_kv_heads == 8
    full = smoke().serve_config(TC.get_config, "kimi")
    assert (full.head_dim, full.n_heads // full.n_kv_heads) == (112, 8)
    assert (full.n_experts, full.experts_per_token, full.capacity_factor) \
        == (tcfg.n_experts, tcfg.experts_per_token, tcfg.capacity_factor)
    assert full.n_layers == 1 and full.d_model == 7168


# a decode step of 4 tokens has 32 entries over 384 experts at cap 1: it
# drops only where two tokens share an expert, as seed 2's do (3 entries)
@pytest.mark.parametrize("b,s,cap,seed", [(4, 1, 1, 2), (4, 16, 2, 1),
                                          (2, 32, 2, 2)])
def test_moe_matches_jax(b, s, cap, seed):
    jcfg, tcfg = configs(ARCH, **GEOMETRY)
    assert TB.moe_capacity(b * s, tcfg) == cap
    jp = JB.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    assert dropped(x, np.asarray(jp["router"]), tcfg,
                   tcfg.capacity_factor) > 0
    want = JB.moe(jp, jnp.asarray(x), jcfg)
    got = TB.moe(tp, torch.from_numpy(x), tcfg)
    close(got, want, tol=1e-5)


def narrow_twin():
    """The crossdevice phase's narrow fp32 kimi-k2: ``CROSS_LMS``'s widths
    over the published config, so its experts, top-k and capacity factor
    are kimi-k2's."""
    pub = TC.get_config(ARCH)
    return dict(smoke().CROSS_LMS[ARCH], n_experts=pub.n_experts,
                experts_per_token=pub.experts_per_token,
                capacity_factor=pub.capacity_factor)


@pytest.mark.parametrize("kw", [dict(GEOMETRY, n_layers=1),
                                dict(GEOMETRY, n_layers=2), "twin"],
                         ids=["1_layer", "2_layers", "crossdevice_twin"])
def test_prefill_and_decode_match_jax(kw):
    if kw == "twin":
        kw = narrow_twin()
    jm, params, tm = pair(ARCH, seed=3, **kw)
    assert tm.cfg.head_dim == 112 and tm.cfg.n_experts == 384
    check_serving(jm, params, tm, tokens(tm.cfg, 2, 27, seed=3), max_len=30,
                  steps=3)


def test_against_jax_pallas_kernels_in_interpret_mode():
    jm, params, tm = pair(ARCH, seed=4, **dict(GEOMETRY, n_layers=2))
    jops.set_default_impl("pallas_interpret")
    try:
        check_serving(jm, params, tm, tokens(tm.cfg, 2, 27, seed=4),
                      max_len=30, steps=3)
    finally:
        jops.set_default_impl("xla")


@pytest.mark.parametrize("factor", ["e_over_k", "published"])
def test_moe_token_reference_matches_moe(factor):
    """``chip_smoke.moe_token_reference`` (fp32, one token at a time)
    equals ``blocks.moe`` in fp32 at 384 experts and top-8; at the
    published capacity factor it keeps exactly the entries the capacity
    rule keeps."""
    _, cfg = configs(ARCH, **GEOMETRY)
    cf = (cfg.n_experts / cfg.experts_per_token if factor == "e_over_k"
          else cfg.capacity_factor)
    gen = torch.Generator().manual_seed(5)
    params = TB.moe_init(gen, cfg)
    x = torch.randn((4, 16, cfg.d_model), generator=gen)
    cap = TB.moe_capacity(64, cfg, cf)
    want, idx, kept = smoke().moe_token_reference(torch, params, x, cfg, cap)
    assert tuple(idx.shape) == tuple(kept.shape) == (64, 8)
    n_drop = dropped(x.numpy(), params["router"].numpy(), cfg, cf)
    assert int((~kept).sum()) == n_drop
    assert (n_drop > 0) == (factor == "published")
    got = TB.moe(params, x, cfg, capacity_factor=cf)
    close(got, want.numpy(), tol=1e-5)

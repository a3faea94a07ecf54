"""The port's enc-dec LM on the CPU against the JAX package's.

``layer_norm`` and ``sinusoidal_positions`` against the reference's;
whisper-large-v3 at ``reduced_config`` (fp32, JAX ``EncDecLM.init``
weights bridged with ``encdec_from_numpy``) on the same numpy-seeded
frames and tokens: ``encode``, then prefill and decode-step logits and
the ``k``/``v``/``xk``/``xv`` caches within 1e-4 of the reference's max
|value| (as ``tests/test_torch_lm.py``), once with the JAX side on its
Pallas kernels in interpret mode, and with ``pos_embed`` shorter than
the decode runs (its index clamped at the last row).  Also the port's
own decode-after-prefill consistency, ``build_model`` and the entry
points' CUDA default, and ``loss`` naming the training item.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
from repro.kernels import ops as jops
from repro.models import common as JC
from repro.models.encdec import EncDecLM as JEncDec
import repro_torch.configs as TC
from repro_torch.models import common as TCm
from repro_torch.models.bridge import encdec_from_numpy
from repro_torch.models.encdec import EncDecLM
from test_torch_lm import close, configs, tokens

torch.set_num_threads(2)

ARCH = "whisper-large-v3"


def frames(cfg, b, seed=0, se=None):
    return np.random.default_rng(seed).standard_normal(
        (b, se or cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def pair(seed=0, max_pos=32768, **kw):
    jcfg, tcfg = configs(ARCH, **kw)
    jm = JEncDec(jcfg, max_target_positions=max_pos)
    params = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, encdec_from_numpy(tcfg, tree, device="cpu")


def check_serving(jm, params, tm, fr, toks, max_len, steps):
    """prefill on all but the last ``steps`` tokens, then ``steps`` decode
    steps: logits and all four caches of both stacks after each."""
    s = toks.shape[1] - steps
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :s]), jnp.asarray(fr),
                        max_len=max_len)
    tl, tc = tm.prefill(toks[:, :s], fr, max_len=max_len)
    for t in range(s, s + steps + 1):
        close(tl, jl)
        for key in ("k", "v", "xk", "xv"):
            close(tc[key], jc[key])
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        if t < s + steps:
            jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
            tl, tc = tm.decode_step(tc, toks[:, t])


@pytest.mark.parametrize("shape", [(2, 7, 128), (3, 1280), (1, 1, 4, 64)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32)
                   for _ in range(2))
    want = JC.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 1e-5)
    got = TCm.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 1e-5)
    close(got, want, tol=1e-5)


def test_layer_norm_keeps_the_input_dtype():
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    got = TCm.layer_norm(x, torch.ones(64), torch.zeros(64))
    assert got.dtype == torch.bfloat16
    want = JC.layer_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                         jnp.ones(64), jnp.zeros(64))
    close(got, np.asarray(want, np.float32), tol=1e-2)


@pytest.mark.parametrize("length,dim", [(16, 128), (1500, 1280), (7, 10)])
def test_sinusoidal_positions_match_jax(length, dim):
    """Both compute the angles in fp32, and the two libraries' ``exp``
    can differ by an ulp in a frequency: the sines then differ by up to
    an ulp of the largest angle (1.2e-4 at position 1499).  Tolerance:
    two ulps of it."""
    got = TCm.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32
    close(got, JC.sinusoidal_positions(length, dim),
          tol=2 * float(np.spacing(np.float32(length - 1))))


def test_encode_matches_jax():
    jm, params, tm = pair(seed=1)
    fr = frames(tm.cfg, 2, seed=1)
    close(tm.encode(fr), jm.encode(params, jnp.asarray(fr)))


def test_prefill_and_decode_match_jax():
    jm, params, tm = pair()
    check_serving(jm, params, tm, frames(tm.cfg, 2),
                  tokens(tm.cfg, 2, 9), max_len=12, steps=3)


def test_frames_of_another_length_size_the_cross_cache():
    """The cross cache takes the frames' length, as the reference's
    (here 11 frames against the config's 16)."""
    jm, params, tm = pair(seed=2)
    fr = frames(tm.cfg, 2, seed=2, se=11)
    check_serving(jm, params, tm, fr, tokens(tm.cfg, 2, 6, seed=2),
                  max_len=8, steps=2)
    assert tm.prefill(tokens(tm.cfg, 2, 3), fr)[1]["xk"].shape[3] == 11


def test_pos_embed_index_is_clamped():
    """A ``pos_embed`` of 6 rows and decode steps to position 9: both
    stacks read row 5 from position 5 on."""
    jm, params, tm = pair(seed=3, max_pos=6)
    assert tm.max_pos == 6 and tuple(tm.params["pos_embed"].shape) == \
        (6, tm.cfg.d_model)
    check_serving(jm, params, tm, frames(tm.cfg, 2, seed=3),
                  tokens(tm.cfg, 2, 10, seed=3), max_len=10, steps=5)


def test_against_jax_pallas_kernels_in_interpret_mode():
    jm, params, tm = pair(seed=4)
    jops.set_default_impl("pallas_interpret")
    try:
        check_serving(jm, params, tm, frames(tm.cfg, 2, seed=4),
                      tokens(tm.cfg, 2, 7, seed=4), max_len=8, steps=1)
    finally:
        jops.set_default_impl("xla")


def test_prefill_decode_consistency():
    """decode_step on token x after prefill(p) gives the last logits of
    prefill(p + [x]), and the cross cache does not change."""
    cfg = TC.reduced_config(TC.get_config(ARCH))
    model = TC.build_model(cfg, device="cpu", seed=1)
    assert isinstance(model, EncDecLM)
    fr = frames(cfg, 2, seed=5)
    toks = tokens(cfg, 2, 9, seed=5)
    _, cache = model.prefill(toks[:, :8], fr, max_len=12)
    xk = cache["xk"].clone()
    dl, cache = model.decode_step(cache, toks[:, 8])
    fl, _ = model.prefill(toks, fr)
    np.testing.assert_allclose(dl.numpy(), fl.numpy(), atol=5e-3)
    assert torch.equal(cache["xk"], xk)
    assert cache["pos"].tolist() == [9, 9]


def leaves(tree, prefix=""):
    """{dotted path: (shape, dtype name)} of a tree; a JAX stack's
    ``*_layers`` leaves split per layer, as the port keeps them."""
    out = {}
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    dtype = str(tree.dtype).replace("torch.", "")
    top = prefix.split(".")[0]
    if top.endswith("_layers") and not prefix.split(".")[1].isdigit():
        for i in range(tree.shape[0]):
            path = prefix.replace(top, f"{top}.{i}", 1)[:-1]
            out[path] = (tuple(tree.shape[1:]), dtype)
        return out
    return {prefix[:-1]: (tuple(tree.shape), dtype)}


def test_init_matches_the_references_tree():
    """The seeded init has the reference's leaves, shapes and dtypes (the
    stacks as per-layer lists), in bf16."""
    jcfg, tcfg = configs(ARCH)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: JEncDec(jcfg).init(jax.random.PRNGKey(0)))
    got = leaves(EncDecLM(tcfg, device="cpu").params)
    assert got == leaves(want)
    assert got["pos_embed"] == ((32768, tcfg.d_model), "bfloat16")
    assert len(got) > 40


def test_loss_waits_for_training_and_families_are_checked():
    cfg = TC.reduced_config(TC.get_config(ARCH))
    model = EncDecLM(cfg, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        model.loss({})                    # the loss needs the frames
    with pytest.raises(ValueError, match="encdec"):
        EncDecLM(TC.reduced_config(TC.get_config("qwen2-7b")), device="cpu")
    from repro_torch.models.lm import CausalLM
    with pytest.raises(ValueError, match="EncDecLM"):
        CausalLM(cfg, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.reduced_config(TC.get_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EncDecLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        encdec_from_numpy(cfg, {})


def test_full_width_config():
    cfg = TC.get_config(ARCH)
    assert cfg.param_count() == RC.get_config(ARCH).param_count()
    assert (cfg.n_layers, cfg.encoder_layers, cfg.encoder_seq, cfg.d_model,
            cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act,
            cfg.qkv_bias, cfg.rope_theta) == \
        (32, 32, 1500, 1280, 20, 64, 5120, 51866, "gelu", True, 0.0)

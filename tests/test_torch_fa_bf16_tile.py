"""The arithmetic of ``flash_attention``'s ``bf16_tma`` route
(``csrc/flash_attention.cu``, namespace ``tma``), modelled on the CPU.

The kernel runs only on the card.  Its order of operations is repeated
here in float32 PyTorch:

* blocks of 128 query rows (a CTA: two consumer warpgroups of 64), each
  over key tiles of 128 from the block's first key, the window's first
  key rounded down to a tile, to its last (the causal diagonal or Skv);
* fp32 logits of the bf16 inputs, masked to -inf; the online softmax in
  base 2 with fp32 m and l: m's candidate the row's max logit times
  scale * log2(e) (both fp32), p = 2^(s scale log2(e) - m) with the
  product and the difference rounded once (the kernel's FFMA), no key
  kept yet giving p = 0 (m taken as 0);
* P rounded to bf16 before P V, O rescaled by the tile's factor before
  the tile's P V is added;
* the output O * (1 / l) rounded to bf16, 0 for a row with no key
  (ROADMAP C 2's settled half).

The tensor core's order inside one product and ex2.approx's last bits are
not modelled (fp32 matmuls stand for them).  The model is held to float64
and to the JAX package's Pallas kernel in interpret mode, both within
1e-2 of the output's max (the card's tolerance for bf16 attention: P and
the output rounded to bf16), at the head shapes of Qwen2-7B (7 q heads a
kv head, d 128), kimi-k2 (8 a kv head, d 112), zamba2-2.7b (d 80) and
whisper-large-v3 (d 64), narrow and a few hundred tokens long.
``tests/test_torch_tc_numerics.py`` keeps the 64-key model of the
``bf16_cp_async`` route.

``chip_smoke.py`` also holds each block of 128 query rows of the card's
output to 1e-2 of that block's own max (``flash_block_errors``).  Here
the model passes that check at model lengths (2048 tokens; whisper's
1500), and the check fails a fault in a long row that the global
tolerance lets through.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

torch.set_num_threads(2)

BQ = 128                     # query rows a CTA
BN = 128                     # keys a tile
LOG2E = 1.4426950408889634
TOL = 1e-2                   # of the output's max: bf16 P and output


def tile_model(q, k, v, causal=False, window=None, scale=None):
    """The ``bf16_tma`` kernel's arithmetic in float32: q [n, hq, sq, d],
    k/v [n, hkv, skv, d] bf16 -> [n, hq, sq, d] bf16."""
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.repeat_interleave(hq // hkv, dim=1).float()
    vf = v.repeat_interleave(hq // hkv, dim=1).float()
    scale = d ** -0.5 if scale is None else scale
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    off = skv - sq
    out = torch.zeros((n, hq, sq, d))
    for q0 in range(0, sq, BQ):
        rows = slice(q0, min(q0 + BQ, sq))
        qpos = torch.arange(rows.start, rows.stop)[:, None] + off
        kv_lo, kv_hi = 0, skv
        if causal:
            kv_hi = min(skv, min(q0 + BQ, sq) + off)
        if window is not None:
            kv_lo = max(0, q0 + off - window + 1) // BN * BN
        m = torch.full((n, hq, rows.stop - q0, 1), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros((n, hq, rows.stop - q0, d))
        for kv0 in range(kv_lo, kv_hi, BN):
            kt = slice(kv0, min(kv0 + BN, skv))
            x = qf[:, :, rows] @ kf[:, :, kt].transpose(-1, -2)
            kpos = torch.arange(kt.start, kt.stop)[None, :]
            keep = torch.ones((rows.stop - q0, kt.stop - kt.start),
                              dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            x = x.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True) * scale2)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            corr = torch.exp2(m - m_use)
            # fmaf(s, scale2, -m): the product exact in float64, one rounding
            p = torch.exp2((x.double() * scale2 - m_use.double()).float())
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vf[:, :, kt]
            m = m_new
        inv = torch.where(l > 0, 1.0 / l, 0.0)
        out[:, :, rows] = acc * inv
    return out.bfloat16()


def bf16_inputs(seed, n, hq, hkv, sq, skv, d):
    """q, k, v as bf16 tensors from seeded numpy normals."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            .bfloat16() for s in ((n, hq, sq, d), (n, hkv, skv, d),
                                  (n, hkv, skv, d))]


def float64_attention(q, k, v, causal=False, window=None):
    """Softmax attention in float64 on the bf16 inputs; a row with no key
    gives 0."""
    hq, hkv = q.shape[1], k.shape[1]
    q, k, v = (t.double() for t in (q, k, v))
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    logits = q @ k.transpose(-1, -2) * d ** -0.5
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    kpos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill(~keep, -math.inf), -1)
    return torch.nan_to_num(p, nan=0.0) @ v, keep.any(-1)


# (name, n, hq, hkv, sq, skv, d, causal, window): each model's group shape;
# a window under one tile; sq < skv and sq > skv (the first 128 rows keep
# no key); non-causal cross shapes; lengths that fill no tile
CASES = [
    ("qwen2-7b", 1, 7, 1, 384, 384, 128, True, None),
    ("qwen2-7b window 100", 1, 7, 1, 384, 384, 128, True, 100),
    ("kimi-k2", 1, 8, 1, 256, 256, 112, True, None),
    ("kimi-k2 sq < skv", 1, 8, 1, 128, 384, 112, True, None),
    ("zamba2-2.7b", 1, 2, 2, 320, 320, 80, True, None),
    ("zamba2-2.7b sq > skv", 1, 2, 2, 384, 256, 80, True, None),
    ("whisper encoder", 1, 2, 2, 320, 320, 64, False, None),
    ("whisper cross", 2, 2, 2, 192, 320, 64, False, None),
]


@pytest.mark.parametrize("name,n,hq,hkv,sq,skv,d,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_model_holds_bf16_tolerance(name, n, hq, hkv, sq, skv, d,
                                         causal, window):
    """The model within 1e-2 of the output's max of float64, of the JAX
    package's Pallas kernel in interpret mode and of the port's plain
    version; rows with no key 0 in the model and the plain version (the
    Pallas kernel gives them the mean of v, so it is compared on the rows
    that keep a key)."""
    q, k, v = bf16_inputs(sum(map(ord, name)), n, hq, hkv, sq, skv, d)
    got = tile_model(q, k, v, causal=causal, window=window).float()
    want, kept = float64_attention(q, k, v, causal=causal, window=window)
    tol = TOL * float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= tol
    if (~kept).any():
        assert not got[:, :, ~kept].abs().max()
    pallas = torch.from_numpy(np.array(pallas_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)),
        causal=causal, window=window, interpret=True).astype(jnp.float32)))
    assert float((got - pallas)[:, :, kept].abs().max()) <= tol
    plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                    window=window).float()
    assert float((got - plain).abs().max()) <= tol


def test_tile_model_rows_with_no_key_are_zero():
    """Causal, 384 queries over 256 keys: the first 128 rows keep no key
    and are 0, a whole CTA's block with no tile to load."""
    q, k, v = bf16_inputs(7, 1, 2, 1, 384, 256, 64)
    got = tile_model(q, k, v, causal=True)
    assert not got[:, :, :128].float().abs().max()
    assert got[:, :, 128:].float().abs().max() > 0


def test_route_on_the_cpu_is_the_plain_version():
    """A CPU tensor runs ``ref.flash_attention_ref``: ``route`` says so
    without building anything."""
    q, k, v = bf16_inputs(8, 1, 2, 1, 16, 16, 64)
    assert fa.route(q, k, v) == "plain"
    assert torch.equal(fa.flash_attention(q, k, v, causal=True),
                       ref.flash_attention_ref(q, k, v, causal=True))


def smoke():
    """``chip_smoke.py`` as a module (it imports nothing heavy at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (hq, hkv, s, d, causal): the model lengths of chip_smoke's LM cases, two
# q heads each
LONG = [(2, 1, 2048, 128, True), (2, 1, 2048, 112, True),
        (2, 2, 2048, 80, True), (2, 2, 1500, 64, False)]


@pytest.mark.parametrize("hq,hkv,s,d,causal", LONG,
                         ids=[f"d{c[3]}-{c[2]}" for c in LONG])
def test_model_passes_the_per_block_check(hq, hkv, s, d, causal):
    """The model against the port's plain version, each (sequence, head,
    128-row block) within 1e-2 of its own max, as ``chip_smoke.py`` holds
    the card: P's and the output's bf16 rounding fit every block."""
    q, k, v = bf16_inputs(s + d, 1, hq, hkv, s, s, d)
    got = tile_model(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    cs = smoke()
    worst = cs.flash_block_errors(torch, F, "model", got, want, TOL)
    assert worst["blocks"] == hq * -(-s // 128)
    assert worst["block_worst"]["max_abs_err"] <= worst["block_worst"]["tol"]


def test_per_block_check_finds_a_long_rows_fault():
    """The last block's first 64 rows (one consumer) normalised by an l
    that missed one of their 16 key tiles (output 16/15 too large): within
    1e-2 of the whole output's max, which the first rows set, but far over
    1e-2 of the block's own max."""
    q, k, v = bf16_inputs(33, 1, 2, 1, 2048, 2048, 128)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    bad = tile_model(q, k, v, causal=True)
    bad[:, :, 1920:1984] = (bad[:, :, 1920:1984].float() * 16 / 15).bfloat16()
    err = float((bad.float() - want.float()).abs().max())
    assert err <= TOL * float(want.float().abs().max())
    cs = smoke()
    with pytest.raises(cs.SmokeFailure, match="rows from 1920"):
        cs.flash_block_errors(torch, F, "fault", bad, want, TOL)

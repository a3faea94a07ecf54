"""The arithmetic of ``flash_attention``'s fp32 kernel above head dim 128
(``csrc/flash_attention.cu``, namespace ``wide``), modelled on the CPU.

The kernel runs only on the card.  Its order of operations is repeated
here in float32 PyTorch:

* every operand split into hi = tf32(x) and lo = tf32(x - hi), rounded as
  ``cvt.rna`` rounds, and a product summed as lo*hi + hi*lo + hi*hi;
* the head dim cut into 128-column slices, one per CTA of a cluster; each
  slice's part of S over a 64-key tile is one chain in a fresh
  accumulator, and the parts are summed in rank order (the cluster's
  reduce-scatter keeps that order for every unit);
* the online softmax over the kernel's 64-key tiles, in base 2 against
  the scale times log2(e), no key kept yet giving p = 0;
* P split into hi and lo, and O per 64-column output chain: each tile's
  chain in a fresh accumulator, added to O * corr with one rounding;
* the output O / l, 0 for a row with no key.

It is held to float64 and to the JAX package's Pallas kernel in interpret
mode at the VAE's d = 512, one head.  The rows with no key (ROADMAP C 2)
are shown in each package: the Pallas kernel gives the mean of v, the JAX
plain version NaN, the port 0.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro_torch.kernels import ref

torch.set_num_threads(2)

DS = 128                     # head-dim columns a CTA holds
BKV = 64                     # keys a tile
PV_COLS = 64                 # output columns of a P V chain
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna`` rounds: add half of the dropped 13 bits
    to the magnitude and clear them (ties away from zero)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits & 0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def chain(ah, al, bh, bl):
    """A 3xTF32 product of one chain: lo*hi + hi*lo + hi*hi in fp32."""
    return al @ bh + ah @ bl + ah @ bh


def wide_attention_model(q, k, v, causal=False, window=None, scale=None):
    """The wide kernel's arithmetic in float32 on the CPU: q [n, hq, sq, d],
    k/v [n, hkv, skv, d] (fp32 or bf16, widened) -> [n, hq, sq, d] in
    q's dtype.  The tensor core's order inside one chain is not modelled
    (an fp32 matmul stands for it), nor ex2.approx's last bits."""
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    cl = -(-d // DS)
    pad = (0, cl * DS - d)
    qh, ql = split(F.pad(q.float(), pad))
    kh, kl = split(F.pad(k.float(), pad))
    vh, vl = split(F.pad(v.float(), pad))
    scale = d ** -0.5 if scale is None else scale
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((n, hq, sq, 1), -math.inf)
    l = torch.zeros((n, hq, sq, 1))
    acc = torch.zeros((n, hq, sq, cl * DS))
    for k0 in range(0, skv, BKV):
        kt = slice(k0, min(k0 + BKV, skv))
        # the cluster's parts of S, one per 128-column slice, in rank order
        s = None
        for r in range(cl):
            c = slice(r * DS, (r + 1) * DS)
            part = chain(qh[..., c], ql[..., c], kh[..., kt, c].transpose(-1, -2),
                         kl[..., kt, c].transpose(-1, -2))
            s = part if s is None else s + part
        x = s * scale2
        if causal or window is not None:
            kpos = torch.arange(k0, kt.stop)[None, :]
            keep = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            x = x.masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        ph, pl = split(p)
        for c0 in range(0, cl * DS, PV_COLS):
            c = slice(c0, c0 + PV_COLS)
            pv = chain(ph, pl, vh[..., kt, c], vl[..., kt, c])
            # fmaf(acc, corr, pv): one rounding of the exact value
            acc[..., c] = (acc[..., c].double() * corr.double()
                           + pv.double()).float()
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (acc * inv)[..., :d].to(q.dtype)


def arrs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def float64_attention(q, k, v, causal=False, window=None):
    """Softmax attention in float64; every row must keep a key."""
    q, k, v = (torch.from_numpy(a).double() for a in (q, k, v))
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    logits = q @ k.transpose(-1, -2) * d ** -0.5
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    kpos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return torch.softmax(logits.masked_fill(~keep, -math.inf), -1) @ v


@pytest.mark.parametrize("tokens", [256, 1024])
def test_wide_model_holds_fp32_at_vae_width(tokens):
    """The VAE mid-block's one head at d = 512: the model within 2e-5 of
    float64, and within 2e-5 of the output's max of the Pallas kernel in
    interpret mode and of the port's plain version."""
    qn, kn, vn = arrs(80 + tokens, *[(1, 1, tokens, 512)] * 3)
    got = wide_attention_model(*(torch.from_numpy(a) for a in (qn, kn, vn)))
    want = float64_attention(qn, kn, vn)
    assert float((got.double() - want).abs().max()) <= 2e-5
    pallas = np.asarray(pallas_attention(jnp.asarray(qn), jnp.asarray(kn),
                                          jnp.asarray(vn), interpret=True))
    tol = 2e-5 * float(np.abs(pallas).max())
    assert float(np.abs(got.numpy() - pallas).max()) <= tol
    plain = ref.flash_attention_ref(*(torch.from_numpy(a)
                                      for a in (qn, kn, vn)))
    assert float((got - plain).abs().max()) <= tol


def test_wide_model_causal_window_sq_ne_skv():
    """Causal with a window, 200 queries aligned at the end of 320 keys,
    two heads over one kv head, d = 512 (every row keeps a key)."""
    qn, kn, vn = arrs(90, (1, 2, 200, 512), (1, 1, 320, 512),
                      (1, 1, 320, 512))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = wide_attention_model(q, k, v, causal=True, window=100)
    want = float64_attention(qn, np.repeat(kn, 2, 1), np.repeat(vn, 2, 1),
                             causal=True, window=100)
    assert float((got.double() - want).abs().max()) <= 2e-5
    pallas = np.asarray(pallas_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=True,
        window=100, interpret=True))
    assert float(np.abs(got.numpy() - pallas).max()) <= \
        2e-5 * float(np.abs(pallas).max())


def test_rows_with_no_key_in_each_package():
    """ROADMAP C 2, the flash_attention half: causal, 192 queries over 128
    keys at d = 512, so rows 0-63 keep no key.  The Pallas kernel in
    interpret mode gives the mean of v over all 128 keys (NEG_INF = -1e30
    makes every masked p 1), the JAX plain version NaN, the port 0: its
    plain version and the kernels' arithmetic (the wide path in fp32 and
    bf16).  The rows that keep keys agree in all of them."""
    qn, kn, vn = arrs(91, (1, 1, 192, 512), (1, 1, 128, 512),
                      (1, 1, 128, 512))
    empty = slice(0, 64)
    pallas = np.asarray(pallas_attention(jnp.asarray(qn), jnp.asarray(kn),
                                         jnp.asarray(vn), causal=True,
                                         interpret=True))
    np.testing.assert_allclose(
        pallas[0, 0, empty], np.broadcast_to(vn[0, 0].mean(0), (64, 512)),
        atol=1e-5)
    jax_plain = np.asarray(jref.flash_attention_ref(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=True))
    assert np.isnan(jax_plain[0, 0, empty]).all()
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    port = {"plain": ref.flash_attention_ref(q, k, v, causal=True),
            "wide fp32": wide_attention_model(q, k, v, causal=True),
            "wide bf16": wide_attention_model(
                q.bfloat16(), k.bfloat16(), v.bfloat16(),
                causal=True).float()}
    for name, out in port.items():
        assert not out[0, 0, empty].abs().max(), name
    keep = slice(64, 192)
    tol = 2e-5 * float(np.abs(pallas[0, 0, keep]).max())
    for name in ("plain", "wide fp32"):
        got = port[name][0, 0, keep].numpy()
        assert float(np.abs(got - pallas[0, 0, keep]).max()) <= tol, name
        assert float(np.abs(got - jax_plain[0, 0, keep]).max()) <= tol, name

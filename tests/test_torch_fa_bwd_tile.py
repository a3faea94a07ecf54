"""The arithmetic of ``flash_attention``'s backward kernels
(``csrc/flash_attention_bwd.cu``), modelled on the CPU.

The kernels run only on the card.  Their order of operations is repeated
here in float32 PyTorch:

* phase 1, blocks of 128 query rows (64 in fp32) over key tiles of 64
  from the window's first key rounded down to a tile: fp32 logits of the
  inputs, s * scale * log2(e) masked to -inf, the online log-sum-exp in
  base 2 (m, l; no key kept yet: m taken as 0), lse2 = m + log2(l), -inf
  for a row with no key; D = rowsum(dO * O) from the inputs' dO and O;
* phase 2, blocks of 128 keys (64 in fp32), each over the q heads of its
  kv head's group in order and their query tiles of 64 that the masks
  leave, dealt round-robin to ``parts`` blocks: P^T = 2^(S^T scale
  log2(e) - lse2) masked to 0, dS^T = P^T (dP^T - D) scale, P and dS
  rounded to bf16 before dV += P^T dO and dK += dS^T Q in bf16; the
  parts' fp32 sums added in part order, then rounded to the dtype;
* phase 3, blocks of 128 query rows (64 in fp32) over key tiles of 64:
  S, P, dP = dO V^T, dS (rounded to bf16 in bf16), dQ += dS K.

The tensor core's order inside one product and ex2.approx's last bits are
not modelled (fp32 matmuls stand for them).  The model is held to float64
autograd through softmax attention and to ``jax.grad`` of the JAX
package's ``repro.kernels.ref.flash_attention_ref`` on the same seeded
numpy inputs (the bf16 values widened to fp32), within 2e-2 of each
gradient's max in bf16 (P, dS and the gradients rounded to bf16) and
1e-5 in fp32, at the head shapes of Qwen2-7B (7 q heads a kv head, d
128), kimi-k2 (8 a kv head, d 112), zamba2-2.7b (d 80) and
whisper-large-v3 (d 64, non-causal, sq != skv), narrow and a few hundred
tokens long; also a window and rows with no key, whose gradients are 0.
At a training call's length (2,048 tokens) each 128-row block of dq and
each 128-key block of dk and dv is also held within that tolerance of
its own max (``chip_smoke.grad_block_errors``), and a fault of a few per
cent in the last block is shown to pass the whole-gradient check and
fail the block check.  ``tests/test_torch_cuda.py`` holds the kernels themselves to the plain
backward and to fp32 autograd on the card.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ref
from test_torch_fa_bf16_tile import smoke

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
KT = 64                          # keys a tile of phases 1 and 3
QT = 64                          # query rows a tile of phase 2
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def keep_mask(q0, q1, k0, k1, sq, skv, causal, window):
    """[q1 - q0, k1 - k0] of the forward's masks (positions aligned at the
    sequence end)."""
    qpos = torch.arange(q0, q1)[:, None] + (skv - sq)
    kpos = torch.arange(k0, k1)[None, :]
    keep = (torch.arange(q0, q1)[:, None] < sq) & (kpos < skv)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def padded(t, rows):
    """t [..., s, d] with zero rows appended up to ``rows``."""
    extra = rows - t.shape[-2]
    return torch.cat([t, t.new_zeros(t.shape[:-2] + (extra, t.shape[-1]))],
                     dim=-2) if extra > 0 else t


def backward_model(q, k, v, o, do, causal=False, window=None, parts=1):
    """The kernels' (dq, dk, dv) in their order, each in q's dtype."""
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    rb = 128 if bf16 else 64                 # query rows a block, phases 1, 3
    kb = 128 if bf16 else 64                 # keys a block, phase 2
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep, off = hq // hkv, skv - sq
    scale = d ** -0.5
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    sqp = -(-sq // rb) * rb
    qf, dof = padded(q.float(), sqp), padded(do.float(), sqp)
    kx = k.float().repeat_interleave(rep, dim=1)
    vx = v.float().repeat_interleave(rep, dim=1)

    def key_range(q0):
        lo = max(0, q0 + off - window + 1) // KT * KT if window else 0
        hi = min(skv, min(q0 + rb, sq) + off) if causal else skv
        return range(lo, hi, KT) if hi > lo else range(0)

    # -- phase 1: lse2 and D --------------------------------------------
    lse2 = torch.full((n, hq, sqp), math.inf)
    for q0 in range(0, sqp, rb):
        m = torch.full((n, hq, rb), -math.inf)
        l = torch.zeros((n, hq, rb))
        for kv0 in key_range(q0):
            kv1 = min(kv0 + KT, skv)
            x = (qf[:, :, q0:q0 + rb] @ kx[:, :, kv0:kv1].transpose(-1, -2)
                 ) * scale2
            x = x.masked_fill(~keep_mask(q0, q0 + rb, kv0, kv1, sq, skv,
                                         causal, window), -math.inf)
            m_new = torch.maximum(m, x.amax(-1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            l = l * torch.exp2(m - m_use) + torch.exp2(
                x - m_use[..., None]).sum(-1)
            m = m_new
        lse2[:, :, q0:q0 + rb] = torch.where(l > 0, m + torch.log2(l),
                                             -math.inf)
    lse2[:, :, sq:] = math.inf
    dd = padded((do.float() * o.float()).sum(-1, keepdim=True), sqp)[..., 0]

    def probs(x, lse, keep):
        """P from fp32 logits x and the rows' (or columns') lse2."""
        p = torch.exp2((x.double() * scale2 - lse.double()).float())
        return torch.where(keep, p, 0.0)

    # -- phase 2: dK, dV per kv head, the group's q heads in order ------
    dk = torch.zeros((parts, n, hkv, skv, d))
    dv = torch.zeros((parts, n, hkv, skv, d))
    for k0 in range(0, skv, kb):
        k1 = min(k0 + kb, skv)
        kmax = k1 - 1
        lo = max(0, k0 - off) if causal else 0
        hi = min(sq, kmax + window - off) if window else sq
        tiles = range(lo // QT, -(-hi // QT)) if hi > lo else range(0)
        order = [(h, t) for h in range(rep) for t in tiles]
        kt = k.float()[:, :, k0:k1]
        vt = v.float()[:, :, k0:k1]
        for idx, (h, t) in enumerate(order):
            part, q0 = idx % parts, t * QT
            heads = torch.arange(hkv) * rep + h
            qt = qf[:, heads, q0:q0 + QT]
            dot = dof[:, heads, q0:q0 + QT]
            keep = keep_mask(q0, q0 + QT, k0, k1, sq, skv, causal,
                             window).T
            pt = probs(kt @ qt.transpose(-1, -2),
                       lse2[:, heads, None, q0:q0 + QT], keep)
            dpt = vt @ dot.transpose(-1, -2)
            dst = pt * (dpt - dd[:, heads, None, q0:q0 + QT]) * scale
            dv[part, :, :, k0:k1] += rnd(pt) @ dot
            dk[part, :, :, k0:k1] += rnd(dst) @ qt
    dk, dv = dk.sum(0), dv.sum(0)          # the parts in order

    # -- phase 3: dQ ---------------------------------------------------
    dq = torch.zeros((n, hq, sqp, d))
    for q0 in range(0, sqp, rb):
        for kv0 in key_range(q0):
            kv1 = min(kv0 + KT, skv)
            keep = keep_mask(q0, q0 + rb, kv0, kv1, sq, skv, causal, window)
            kt, vt = kx[:, :, kv0:kv1], vx[:, :, kv0:kv1]
            p = probs(qf[:, :, q0:q0 + rb] @ kt.transpose(-1, -2),
                      lse2[:, :, q0:q0 + rb, None], keep)
            dp = dof[:, :, q0:q0 + rb] @ vt.transpose(-1, -2)
            ds = p * (dp - dd[:, :, q0:q0 + rb, None]) * scale
            dq[:, :, q0:q0 + rb] += rnd(ds) @ kt
    return dq[:, :, :sq].to(dt), dk.to(dt), dv.to(dt)


def inputs(seed, n, hq, hkv, sq, skv, d, dtype):
    """q, k, v, dO in ``dtype`` from seeded numpy normals."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d),
                      (n, hq, sq, d))]


def float64_grads(q, k, v, do, causal, window):
    """Autograd through softmax attention in float64 (a row with no key
    gives 0)."""
    hq, hkv = q.shape[1], k.shape[1]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    kk = leaves[1].repeat_interleave(hq // hkv, dim=1)
    vv = leaves[2].repeat_interleave(hq // hkv, dim=1)
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    logits = leaves[0] @ kk.transpose(-1, -2) * d ** -0.5
    keep = keep_mask(0, sq, 0, skv, sq, skv, causal, window)
    # a finite fill: a row with no key stays finite, then 0 (no NaN to
    # carry back through the softmax)
    p = torch.softmax(logits.masked_fill(~keep, -1e30), -1)
    p = torch.where(keep.any(-1, keepdim=True), p, 0.0)
    return torch.autograd.grad(p @ vv, leaves, do.double())


def jax_grads(q, k, v, do, causal, window):
    """``jax.grad`` of the JAX package's reference on fp32 copies of the
    same values, as float64 torch tensors."""
    arr = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]

    def loss(q_, k_, v_):
        out = jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                       window=window)
        return jnp.sum(out * arr[3])

    return [torch.from_numpy(np.asarray(g, dtype=np.float64))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*arr[:3])]


def rel_errs(got, want):
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


# (name, n, hq, hkv, sq, skv, d, causal, window, parts): each model's group
# shape; a window; sq < skv; sq > skv (the first rows keep no key);
# whisper's non-causal cross shape; two and three parts
CASES = [
    ("qwen2-7b", 1, 7, 1, 256, 256, 128, True, None, 1),
    ("qwen2-7b parts", 1, 7, 1, 256, 256, 128, True, None, 2),
    ("qwen2-7b window 100", 1, 7, 1, 320, 320, 128, True, 100, 1),
    ("kimi-k2", 1, 8, 1, 192, 192, 112, True, None, 3),
    ("kimi-k2 sq < skv", 1, 8, 1, 96, 256, 112, True, None, 1),
    ("zamba2-2.7b", 1, 2, 2, 200, 200, 80, True, None, 1),
    ("whisper cross", 2, 2, 2, 150, 300, 64, False, None, 2),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,n,hq,hkv,sq,skv,d,causal,window,parts", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_model_holds_tolerance(name, n, hq, hkv, sq, skv, d,
                                        causal, window, parts, dtype):
    """The model within 2e-2 (bf16) or 1e-5 (fp32) of each gradient's max
    of float64 autograd and of ``jax.grad`` of the JAX reference, with o
    from the port's plain forward in ``dtype``."""
    q, k, v, do = inputs(sum(map(ord, name)), n, hq, hkv, sq, skv, d, dtype)
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = backward_model(q, k, v, o, do, causal=causal, window=window,
                         parts=parts)
    assert [t.dtype for t in got] == [dtype] * 3
    for want in (float64_grads(q, k, v, do, causal, window),
                 jax_grads(q, k, v, do, causal, window)):
        errs = rel_errs(got, want)
        assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_rows_with_no_key_have_zero_gradients(dtype):
    """Causal, 200 queries over 72 keys: the first 128 rows keep no key
    (lse2 = -inf), so their dq is 0, and they add nothing to dk and dv: the
    model's dk and dv are those of the other rows alone."""
    q, k, v, do = inputs(5, 1, 4, 2, 200, 72, 64, dtype)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    dq, dk, dv = backward_model(q, k, v, o, do, causal=True)
    assert not dq[:, :, :128].float().abs().max()
    assert dq[:, :, 128:].float().abs().max() > 0
    tail = backward_model(q[:, :, 128:], k, v, o[:, :, 128:], do[:, :, 128:],
                          causal=True)
    assert torch.equal(dk, tail[1]) and torch.equal(dv, tail[2])
    want = float64_grads(q, k, v, do, True, None)
    assert max(rel_errs((dq, dk, dv), want)) <= TOL[dtype]


def test_parts_split_only_the_order_of_the_sum():
    """fp32: one part and four give dk and dv within fp32 rounding of each
    other, and dq bit for bit (phase 3 does not see the parts)."""
    q, k, v, do = inputs(9, 1, 4, 1, 160, 160, 32, torch.float32)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    one = backward_model(q, k, v, o, do, causal=True, parts=1)
    four = backward_model(q, k, v, o, do, causal=True, parts=4)
    assert torch.equal(one[0], four[0])
    for a, b in zip(one[1:], four[1:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("n,hkv,skv,dtype,sms,want", [
    (2, 4, 2048, torch.bfloat16, 132, 2),      # the training call: 128 blocks
    (4, 4, 2048, torch.bfloat16, 132, 1),      # 256 blocks fill the card
    (1, 1, 64, torch.float32, 132, 4),         # capped at 4
    (2, 4, 2048, torch.float32, 132, 1)])      # 64-key blocks: 256
def test_bwd_parts_keeps_twice_the_sms_in_the_grid(n, hkv, skv, dtype, sms,
                                                   want):
    assert fab.parts(n, hkv, skv, dtype, sms) == want


def test_backward_on_the_cpu_is_the_plain_version():
    """A CPU tensor's backward is ``ref.flash_attention_bwd_ref``, with no
    launch counted."""
    from repro_torch.kernels import ops
    q, k, v, do = inputs(3, 1, 4, 2, 40, 40, 16, torch.float32)
    o = ref.flash_attention_ref(q, k, v, causal=True, window=9)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = fab.flash_attention_bwd(q, k, v, o, do, True, 0.25, 9)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True,
                                       scale=0.25, window=9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["flash_attention_bwd"] == before


# (name, hq, hkv, d, dtype): one sequence of a training call's length,
# 2,048 tokens, causal, at a model's group shape
LONG = [("qwen2-7b bf16", 7, 1, 128, torch.bfloat16),
        ("qwen2-7b fp32", 7, 1, 128, torch.float32),
        ("kimi-k2 bf16", 8, 1, 112, torch.bfloat16)]


@functools.lru_cache(maxsize=None)
def long_call(hq, hkv, d, dtype):
    """The model's gradients and float64 autograd's for one causal
    2,048-token sequence (do not modify: cached)."""
    q, k, v, do = inputs(hq * d, 1, hq, hkv, 2048, 2048, d, dtype)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    got = backward_model(q, k, v, o, do, causal=True, parts=2)
    return got, float64_grads(q, k, v, do, True, None)


@pytest.mark.parametrize("name,hq,hkv,d,dtype", LONG,
                         ids=[c[0] for c in LONG])
def test_model_passes_the_per_block_check(name, hq, hkv, d, dtype):
    """Each (sequence, head, 128-row) block of dq and (sequence, kv head,
    128-key) block of dk and dv within the dtype's tolerance of that
    block's own max, as ``chip_smoke.py`` holds the card: the bf16
    roundings of P, dS and the gradients fit every block, although the
    last keys' and rows' gradients are a tenth to a fiftieth of the
    first ones'."""
    got, want = long_call(hq, hkv, d, dtype)
    cs = smoke()
    worst = cs.grad_block_errors(torch, F, "model", got, want, TOL[dtype])
    assert [w["blocks"] for w in worst.values()] == [hq * 16, hkv * 16,
                                                    hkv * 16]
    for w, g in zip(worst.values(), want):
        assert w["block_worst"]["max_abs_err"] <= w["block_worst"]["tol"]
        # the last block's max is far below the whole gradient's
        assert float(g[:, :, -128:].abs().max()) < 0.1 * float(g.abs().max())


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_per_block_check_finds_a_last_block_fault(which):
    """The last 128 rows of dq, or the last 128 keys of dk or dv, 5 % too
    large (as from a wrong scale or a dropped tile there): within 2e-2 of
    the whole gradient's max, which the first rows and keys set, but over
    2e-2 of the block's own max."""
    got, want = long_call(7, 1, 128, torch.bfloat16)
    bad = [g.clone() for g in got]
    bad[which][:, :, -128:] = (bad[which][:, :, -128:].float() * 1.05
                               ).bfloat16()
    tol = TOL[torch.bfloat16]
    assert max(rel_errs(bad, want)) <= tol
    name = ("dq", "dk", "dv")[which]
    cs = smoke()
    with pytest.raises(cs.SmokeFailure, match=f"fault {name}: .*rows from "
                                              f"1920"):
        cs.grad_block_errors(torch, F, "fault", bad, want, tol)

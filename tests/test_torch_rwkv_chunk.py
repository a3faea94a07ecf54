"""The arithmetic of the chunked RWKV-6 kernel (``csrc/rwkv6_scan.cu``,
``rwkv6_chunk_kernel``), modelled on the CPU.

The kernel walks the tokens in sub-chunks of 16 with the fp32 state S
resident.  Inside a sub-chunk every decay factor is a product of the
decays dec = exp(-exp(w)) between two of its tokens (each <= 1): D_t over
the tokens before t (``exp(Lp_t - L_start)`` of the JAX package's
``rwkv6_chunked``), the decay from s to the sub-chunk's end, and, pair by
pair, the decay strictly between s and t of the intra-chunk matrix A,
whose diagonal is the bonus r . (u (.) k).  Then

    y = (r (.) D) S + A v,      S <- D_16 (.)rows S + (k (.) decay to end)^T v

with the three products in 3xTF32 (operands rounded as
``cvt.rna.tf32.f32`` rounds, hi/lo splits).  Two warps share each 16
value columns, one per half of the keys: each adds one fresh fragment per
8 keys of its half and the intra term of its 8 tokens to its part of y,
and the two parts are added when the output is stored; the state takes
one fresh fragment per 8 keys over the 16 tokens, added to the decayed S
with one rounding.  A bf16 v is exact in TF32 and takes two products.
These tests repeat that in PyTorch and hold it to the port's plain
``ref.rwkv6_scan_ref``, the JAX package's ``rwkv6_chunked`` and its Pallas
``rwkv6_scan`` in interpret mode, on the same seeded numpy inputs: t at the
sub-chunk's edges, d from 3 to 128, with and without a state, and decays
from w = -10 (dec = 1 - 4.5e-5) to w = 4 (a log-decay of -54.6 a token).
Tolerances: 2e-5 of the output's max in fp32, 1e-4 of the state's max.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.models.ssm import rwkv6_chunked
from repro_torch.kernels import ref
from test_torch_tc_numerics import split, tf32

torch.set_num_threads(2)

C = 16        # tokens per sub-chunk
SLICE = 8     # depth of one m16n8k8 product


def three(a, b, exact_b=False):
    """a @ b in 3xTF32 over one 8-deep slice: lo*hi + hi*lo + hi*hi in
    fp32; a ``b`` exact in TF32 has a zero lo half and takes two."""
    ah, al = split(a)
    if exact_b:
        return al @ b + ah @ b
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def fma(a, b, c):
    """fp32 a * b + c with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def pairwise(rc, kc, dc, u):
    """A [.., t, s] of one sub-chunk: t > s: sum_i r_ti k_si prod_{s<m<t}
    dec_mi, as a running product per s; t == s: sum_i r_ti u_i k_ti.  The
    sum over i as the kernel takes it: each of 32 lanes sums d / 32
    consecutive columns (at least one), then the lanes in halves (lane bit
    16 first, as the shuffles go)."""
    *lead, c, d = rc.shape
    a = torch.zeros((*lead, c, c), dtype=torch.float32)
    cpl = max(1, d // 32)

    def colsum(x):                        # [.., d] -> [..]
        parts = x.reshape(*x.shape[:-1], d // cpl, cpl).sum(-1)
        parts = torch.nn.functional.pad(parts, (0, 32 - d // cpl))
        while parts.shape[-1] > 1:
            n = parts.shape[-1] // 2
            parts = parts[..., :n] + parts[..., n:]
        return parts[..., 0]

    for s in range(c):
        a[..., s, s] = colsum(rc[..., s, :] * u * kc[..., s, :])
        kp = kc[..., s, :].clone()
        for t in range(s + 1, c):
            a[..., t, s] = colsum(rc[..., t, :] * kp)
            kp = kp * dc[..., t, :]
    return a


def chunk_model(r, k, v, w, u, state=None, exact_v=False, passes=3):
    """The kernel's algorithm: r, k, v, w [n, h, t, d], u [h, d], state
    [n, h, d, d] (zeros if None) -> (out fp32 [n, h, t, d], state).
    ``passes=1`` takes one TF32 product in place of three (for the test
    that shows why three are needed)."""
    n, h, t, d = r.shape
    nc = -(-t // C)
    dp = max(16, 1 << (d - 1).bit_length())   # the kernel's padded head
    pad = (0, dp - d, 0, nc * C - t)
    rf, kf, vf = (torch.nn.functional.pad(x.float(), pad) for x in (r, k, v))
    dec = torch.exp(-torch.exp(w.float()))
    dec = torch.nn.functional.pad(dec, pad, value=1.0)
    uf = torch.nn.functional.pad(u.float(), (0, dp - d))[None]
    s = torch.zeros((n, h, dp, dp))
    if state is not None:
        s[..., :d, :d] = state.float()

    def mm(a, b, exact_b=False):
        if passes == 1:
            return tf32(a) @ tf32(b)
        return three(a, b, exact_b)

    outs = []
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, dc = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], dec[:, :, sl]
        x, rd = torch.ones((n, h, dp)), []
        for tt in range(C):               # r_t (.) prod_{m<t} dec_m
            rd.append(rc[:, :, tt] * x)
            x = x * dc[:, :, tt]
        rd, d16 = torch.stack(rd, 2), x
        x, kr = torch.ones((n, h, dp)), [None] * C
        for tt in reversed(range(C)):     # k_s (.) prod_{m>s} dec_m
            kr[tt] = kc[:, :, tt] * x
            x = x * dc[:, :, tt]
        kr = torch.stack(kr, 2)
        a = pairwise(rc, kc, dc, uf)
        halves = []                       # two warps per column tile
        for hw in range(2):
            y = torch.zeros((n, h, C, dp))
            for q in range(hw * dp // 2, (hw + 1) * dp // 2, SLICE):
                y = y + mm(rd[..., q:q + SLICE], s[:, :, q:q + SLICE])
            q = hw * SLICE                # intra: this half's 8 tokens s
            y = y + mm(a[..., q:q + SLICE], vc[:, :, q:q + SLICE], exact_v)
            halves.append(y)
        outs.append(halves[0] + halves[1])
        ds = None                         # state: one chain over 16 tokens
        for q in range(0, C, SLICE):
            p = mm(kr[:, :, q:q + SLICE].transpose(-1, -2),
                   vc[:, :, q:q + SLICE], exact_v)
            ds = p if ds is None else ds + p
        s = fma(d16[..., None], s, ds)
    out = torch.cat(outs, 2)[:, :, :t, :d]
    return out, s[..., :d, :d]


def inputs(seed, n, h, t, d, with_state, w_range=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if w_range is None:
        w = rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.6 - 1.0
    else:
        w = rng.uniform(*w_range, (n, h, t, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((n, h, d, d)).astype(np.float32) * 0.5
          if with_state else None)
    return r, k, v, w, u, s0


def references(r, k, v, w, u, s0):
    """(out, state) of the port's plain version, the JAX package's
    ``rwkv6_chunked`` and its Pallas kernel in interpret mode."""
    n, h, t, d = r.shape
    tor = ref.rwkv6_scan_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                             None if s0 is None else torch.from_numpy(s0))
    js = (jnp.zeros((n, h, d, d), jnp.float32) if s0 is None
          else jnp.asarray(s0))
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    chunked = rwkv6_chunked(*jargs, js)
    pallas = jax_rwkv6_scan(*jargs, None if s0 is None else js,
                            interpret=True)
    return {"ref": tor, "rwkv6_chunked": chunked, "pallas": pallas}


def assert_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max error {err} > {bound}"


def check(r, k, v, w, u, s0):
    out, st = chunk_model(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                          None if s0 is None else torch.from_numpy(s0))
    for name, (want_o, want_s) in references(r, k, v, w, u, s0).items():
        assert_close(out, want_o, 2e-5, f"output vs {name}")
        assert_close(st, want_s, 1e-4, f"state vs {name}")


# t at the sub-chunk's edges (d = 64, the rwkv6-7b head), then d from 3 to
# 128 at t = 17 (one full sub-chunk and one token)
EDGES = [(t, 64) for t in (1, 15, 16, 17, 45)]
WIDTHS = [(17, d) for d in (3, 8, 80, 128)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,d", EDGES + WIDTHS)
def test_chunk_model_matches_references(t, d, with_state):
    check(*inputs(t * 131 + d, 2, 2, t, d, with_state))


@pytest.mark.parametrize("w_range", [(-10.0, -10.0), (4.0, 4.0),
                                     (-10.0, 4.0)])
@pytest.mark.parametrize("t,d", [(45, 64), (17, 80)])
def test_chunk_model_extreme_decay(t, d, w_range):
    """dec = 1 - 4.5e-5 to dec = 1.9e-24 (a product of two underflows):
    finite, and within the same tolerances."""
    args = inputs(7 + t, 2, 2, t, d, True, w_range)
    check(*args)


def test_pairwise_decays_stay_at_most_one_and_underflow_cleanly():
    """At w = 4 every factor of A is a product of decays of 1.9e-24: the
    factors two tokens apart underflow to 0 (as the true product does),
    none is above 1, nothing is inf or nan."""
    dec = torch.exp(-torch.exp(torch.full((1, C, 8), 4.0)))
    ones = torch.ones((1, C, 8))
    a = pairwise(ones, ones, dec, torch.zeros(8))
    lower = torch.tril(a[0], -1)
    assert torch.isfinite(a).all()
    assert float(lower.max()) <= 8.0            # 8 columns of factor <= 1
    assert torch.equal(torch.diagonal(a[0], -1), torch.full((C - 1,), 8.0))
    assert float(torch.tril(a[0], -3).abs().max()) == 0.0


def test_one_tf32_pass_misses_the_fp32_tolerance():
    """Why the products take 3xTF32: one TF32 product each breaks the 2e-5
    output tolerance at the rwkv6-7b head width, three keep it."""
    r, k, v, w, u, s0 = inputs(3, 2, 2, 45, 64, True)
    want, _ = ref.rwkv6_scan_ref(*(torch.from_numpy(a)
                                   for a in (r, k, v, w, u, s0)))
    bound = 2e-5 * float(want.abs().max())
    errs = {}
    for passes in (1, 3):
        out, _ = chunk_model(*(torch.from_numpy(a)
                               for a in (r, k, v, w, u, s0)), passes=passes)
        errs[passes] = float((out - want).abs().max())
    assert errs[3] <= bound < errs[1], errs


def test_bf16_operands_take_two_products_and_hold_the_bf16_tolerance():
    """bf16 r, k, v (the model's dtype): v exact in TF32 (two products of
    three), the output rounded to bf16 against the plain version's, 1e-2
    of the max as on the card."""
    r, k, v, w, u, s0 = inputs(5, 2, 2, 45, 64, True)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    rest = [torch.from_numpy(a) for a in (w, u, s0)]
    want, want_s = ref.rwkv6_scan_ref(*bf, *rest)
    out, st = chunk_model(*bf, *rest, exact_v=True)
    out = out.to(torch.bfloat16)
    err = float((out.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())
    assert float((st - want_s).abs().max()) <= 1e-4 * float(
        want_s.abs().max())
    exact, _ = split(bf[2].float())
    assert torch.equal(exact, bf[2].float())

"""The backward of the RWKV-6 recurrence on the CPU.

``ref.rwkv6_scan_bwd_ref`` (what ``RWKV6Scan``'s backward runs for a CPU
tensor, and what ``chip_smoke.py`` holds the card's kernel to) gives the
gradients of ``rwkv6_scan`` in closed form, chunked as
``csrc/rwkv6_scan_bwd.cu`` walks it: 16-token sub-chunks, the pairwise
decays, and the dw carry restarted from rowsum(S (.) dS) at each
sub-chunk's end.  These tests hold it to ``jax.vjp`` of the JAX package's
``rwkv6_chunked`` (the form its RWKV-6 block differentiates) on seeded
numpy inputs, at 1e-4 of each gradient's max |value|: t of 1, 16, 33, 37
and 64, d from 3 to 128, with and without an initial state, with one
cotangent None, and decays from w = -10 (dec = 1 - 4.5e-5) to w = 4 (a
log-decay of -54.6 a token); and to autograd through the sequential
``ref.rwkv6_scan_ref`` in float64 at 1e-10.

Where the true dw vanishes, every fp32 implementation returns the
rounding of its own sums: at w = 4 everywhere (every decay 1.9e-24, dw
below 1e-21) JAX's differs from float64 by 2.6e-5 and the plain backward
by 3.9e-5, each about eps32 |lw| (54.6) times the terms r (.) dr^ and k
(.) dk^ that the dw carry sums; at one token with no initial state (dw
exactly 0) the plain backward gives 9e-7.  There dw is held to 1e-4 of
max |dr| in absolute value, the scale of those terms; every other
gradient, and dw elsewhere, keeps 1e-4 of its own max.

Then a model of the kernel's reverse walk: operands rounded as
``cvt.rna.tf32.f32`` rounds and split hi/lo, the four d^2 products in
3xTF32 (a bf16 dO or v exact in TF32, two products), each 8-deep chain
added to its fp32 sum; A and B over the lanes as the kernel sums them;
the pairwise sums of dr^ and dk^, the u terms, du and the dw carry in
the kernel's order with its fused multiply-adds; Phi over each warp's 16
columns by the lane butterfly, then over the column warps; value-column
tiles of 32 above d 64, their parts summed in tile order.  It is held to
the plain backward at 2e-5 of each gradient's max in fp32 (the plain
form's exp(L) decays against the kernel's products of decays, 3xTF32
against fp32 products; measured 6.4e-7 at most) and to JAX at 1e-4; at
the extreme decays to both at 1e-4 (the plain form's exp of differences
of L down to -873 is off float64 by up to 2.2e-5 there, the model by
1.7e-5 in dw, its carry's rounding, and 2e-7 elsewhere); and in bf16
(operands and dr, dk, dv rounded to bf16) to the plain backward on the
same bf16 inputs at 1e-2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.models.ssm import rwkv6_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan_bwd as krb
from test_torch_rwkv_chunk import C, SLICE, fma, pairwise
from test_torch_tc_numerics import split

torch.set_num_threads(2)

NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def inputs(seed, n, h, t, d, with_state=True, w_range=None, dout=True,
           dstate=True):
    """Seeded numpy (r, k, v, w, u, state, dout, dstate); an absent state
    or cotangent is None."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if w_range is None:
        w = rng.standard_normal((n, h, t, d)).astype(np.float32) * 0.6 - 1.0
    else:
        w = rng.uniform(*w_range, (n, h, t, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((n, h, d, d)).astype(np.float32) * 0.5
    do = rng.standard_normal((n, h, t, d)).astype(np.float32)
    ds = rng.standard_normal((n, h, d, d)).astype(np.float32)
    return (r, k, v, w, u, s0 if with_state else None, do if dout else None,
            ds if dstate else None)


def torch_args(args, dtype=None):
    out = [None if a is None else torch.from_numpy(a) for a in args]
    if dtype is not None:
        out[:3] = [a.to(dtype) for a in out[:3]]
        out[6] = None if out[6] is None else out[6].to(dtype)
    return out


def jax_grads(r, k, v, w, u, s0, do, ds):
    """The six gradients by ``jax.vjp`` of ``rwkv6_chunked`` (which takes
    a state: zeros where there is none; absent cotangents are zeros)."""
    n, h, t, d = r.shape
    s0 = np.zeros((n, h, d, d), np.float32) if s0 is None else s0
    do = np.zeros_like(r) if do is None else do
    ds = np.zeros((n, h, d, d), np.float32) if ds is None else ds
    _, vjp = jax.vjp(rwkv6_chunked,
                     *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(ds)))]


def check(got, want, names, tol, scales=None):
    """Each gradient within ``tol`` of its scale (default: its own max
    |value|)."""
    for name, g, wv in zip(names, got, want):
        if wv is None:
            continue
        g = g.double().numpy() if isinstance(g, torch.Tensor) else g
        wv = wv.double().numpy() if isinstance(wv, torch.Tensor) else \
            np.asarray(wv, np.float64)
        assert g.shape == wv.shape, name
        assert np.isfinite(g).all(), name
        scale = (scales or {}).get(name, float(np.abs(wv).max()))
        err = float(np.abs(g - wv).max())
        assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


def dw_scales(want, vanishes):
    """dw's scale: its own max, or max |dr| where the true dw vanishes."""
    if vanishes:
        dr = want[0]
        return {"dw": float(dr.abs().max() if isinstance(dr, torch.Tensor)
                            else np.abs(dr).max())}
    return None


def plain(args):
    return ref.rwkv6_scan_bwd_ref(*torch_args(args))


# t at the sub-chunk's edges (d = 64, the rwkv6-7b head), then d from 3 to
# 128 at t = 37 (two full sub-chunks and five tokens)
SHAPES = [(t, 64) for t in (1, 16, 33, 37, 64)] + \
    [(37, d) for d in (3, 8, 80, 128)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,d", SHAPES)
def test_plain_backward_matches_jax(t, d, with_state):
    args = inputs(t * 131 + d, 2, 2, t, d, with_state)
    want = jax_grads(*args)
    check(plain(args), want, NAMES[:5] + (("dstate0",) if with_state
                                          else ()), 1e-4,
          dw_scales(want, t == 1 and not with_state))


@pytest.mark.parametrize("which", ["dout", "dstate"])
@pytest.mark.parametrize("t,d", [(37, 16), (33, 80)])
def test_plain_backward_with_one_cotangent_none(t, d, which):
    """A cotangent None is zero: the gradients of the other alone."""
    args = inputs(t + d, 2, 3, t, d, True, dout=which != "dout",
                  dstate=which != "dstate")
    got = plain(args)
    check(got, jax_grads(*args), NAMES, 1e-4)
    zeros = list(args)
    zeros[6 if which == "dout" else 7] = np.zeros_like(
        args[0] if which == "dout" else args[5])
    for a, b in zip(got, plain(zeros)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w_range", [(-10.0, 4.0), (-10.0, -10.0),
                                     (4.0, 4.0)])
@pytest.mark.parametrize("t,d", [(64, 16), (37, 64)])
def test_plain_backward_extreme_decay(t, d, w_range):
    args = inputs(7 + t, 2, 2, t, d, True, w_range)
    want = jax_grads(*args)
    check(plain(args), want, NAMES, 1e-4,
          dw_scales(want, w_range == (4.0, 4.0)))


# float64: the closed form against autograd through the sequential scan
F64 = [(1, 8, True, True, True), (16, 8, False, True, True),
       (37, 5, True, True, True), (33, 16, True, False, True),
       (20, 16, True, True, False), (45, 32, False, True, True)]


@pytest.mark.parametrize("t,d,with_state,dout,dstate", F64)
def test_plain_backward_is_the_gradient_in_float64(t, d, with_state, dout,
                                                   dstate):
    args = [None if a is None else torch.from_numpy(a).double()
            for a in inputs(t * 7 + d, 2, 2, t, d, with_state, (-3.0, 1.0),
                            dout, dstate)]
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    s0 = None if args[5] is None else args[5].clone().requires_grad_(True)
    out, final = ref.rwkv6_scan_ref(*leaves, s0)
    assert out.dtype == torch.float64 and final.dtype == torch.float64
    loss = out.sum() * 0.0
    if args[6] is not None:
        loss = loss + (out * args[6]).sum()
    if args[7] is not None:
        loss = loss + (final * args[7]).sum()
    want = torch.autograd.grad(loss, leaves + ([s0] if s0 is not None
                                               else []))
    got = ref.rwkv6_scan_bwd_ref(*args)
    assert all(g.dtype == torch.float64 for g in got)
    check(got, want, NAMES[:len(want)], 1e-10)


# ---------------------------------------------------------------------------
# the kernel's reverse walk, modelled
# ---------------------------------------------------------------------------

def prod(a, b, exact_a=False, exact_b=False):
    """a @ b over one 8-deep slice in 3xTF32 (a fresh fragment): lo*hi +
    hi*lo + hi*hi; an operand exact in TF32 (a bf16 value) has a zero lo
    half, and two products remain."""
    if exact_a:
        bh, bl = split(b)
        return a @ bl + a @ bh
    ah, al = split(a)
    if exact_b:
        return al @ b + ah @ b
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def chain(a, b, **kw):
    """a [.., m, K] @ b [.., K, n] as the kernel sums it: one fresh
    fragment per 8 of K, each added to the fp32 sum in order."""
    out = None
    for q in range(0, a.shape[-1], SLICE):
        p = prod(a[..., q:q + SLICE], b[..., q:q + SLICE, :], **kw)
        out = p if out is None else out + p
    return out


def phi_parts(s, ds):
    """rowsum(s (.) ds) [.., keys] over the tile's columns as the kernel
    takes it: per 16 columns (a warp) the pair (j, j + 8) of a thread by
    one fma, the 8 lanes g by a butterfly over lane bits 4, 8, 16; then
    the warps in order."""
    *lead, dp, nt = s.shape
    sg = s.reshape(*lead, dp, nt // 16, 2, 8)
    dg = ds.reshape(*lead, dp, nt // 16, 2, 8)
    p = fma(sg[..., 1, :], dg[..., 1, :], sg[..., 0, :] * dg[..., 0, :])
    for bit in (1, 2, 4):
        p = p + p[..., [g ^ bit for g in range(8)]]
    out = torch.zeros_like(p[..., 0, 0])
    for wq in range(nt // 16):
        out = out + p[..., wq, 0]
    return out


def bwd_model(r, k, v, w, u, state=None, dout=None, dstate=None,
              exact=False):
    """The kernel's algorithm: r, k, v, w, dout [n, h, t, d], u [h, d],
    state and dstate [n, h, d, d] (zeros if None) -> (dr, dk, dv, dw, du,
    dstate0) in fp32; ``exact``: v and dO are exact in TF32 (bf16)."""
    n, h, t, d = r.shape
    nc = -(-t // C)
    dp = max(16, 1 << (d - 1).bit_length())      # the kernel's padded head
    nt = dp if dp <= 64 else 32                   # value columns a tile
    tiles = krb.tiles(d)
    pad = (0, dp - d, 0, nc * C - t)
    dout = torch.zeros_like(r) if dout is None else dout
    rf, kf, vf, of = (F.pad(x.float(), pad) for x in (r, k, v, dout))
    dec = F.pad(torch.exp(-torch.exp(w.float())), pad, value=1.0)
    lw = -torch.exp(w.float())
    uf = F.pad(u.float(), (0, dp - d))[None]
    sq = torch.zeros((n, h, dp, dp))
    if state is not None:
        sq[..., :d, :d] = state.float()
    dsT = torch.zeros((n, h, dp, dp))
    if dstate is not None:
        dsT[..., :d, :d] = dstate.float()

    def scans(dc, rc, kc):
        x, rd = torch.ones((n, h, dp)), []
        for tt in range(C):
            rd.append(rc[:, :, tt] * x)
            x = x * dc[:, :, tt]
        d16, x, kr = x, torch.ones((n, h, dp)), [None] * C
        for tt in reversed(range(C)):
            kr[tt] = kc[:, :, tt] * x
            x = x * dc[:, :, tt]
        return torch.stack(rd, 2), d16, torch.stack(kr, 2)

    # the forward's states (its own walk: one chain over the 16 tokens, one
    # fma onto the decayed state a sub-chunk)
    starts = []
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        starts.append(sq)
        _, d16, kr = scans(dec[:, :, sl], rf[:, :, sl], kf[:, :, sl])
        sq = fma(d16[..., None], sq, chain(kr.transpose(-1, -2),
                                           vf[:, :, sl], exact_b=exact))
    starts.append(sq)

    parts = torch.zeros((3, tiles, n, h, nc * C, dp))
    du_parts = torch.zeros((tiles, n, h, dp))
    dv = torch.zeros((n, h, nc * C, dp))
    ds0 = torch.zeros((n, h, dp, dp))
    for tile in range(tiles):
        cs = slice(tile * nt, (tile + 1) * nt)
        dS = dsT[..., cs].clone()                 # [n, h, keys, tile cols]
        phi = phi_parts(starts[nc][..., cs], dS)
        du_acc = torch.zeros((n, h, dp))
        for c in reversed(range(nc)):
            sl = slice(c * C, (c + 1) * C)
            rc, kc, dc = rf[:, :, sl], kf[:, :, sl], dec[:, :, sl]
            vc, oc = vf[:, :, sl, cs], of[:, :, sl, cs]
            rd, d16, kr = scans(dc, rc, kc)
            a = pairwise(rc, kc, dc, uf)          # the forward's A
            b = pairwise(oc, vc, torch.ones_like(oc), torch.ones((1, nt)))
            x = chain(oc, starts[c][..., cs].transpose(-1, -2), exact_a=exact)
            y = chain(vc, dS.transpose(-1, -2), exact_a=exact)
            halves = []                           # dv, per key half
            for hw in range(2):
                yh = None
                for q in range(hw * dp // 2, (hw + 1) * dp // 2, SLICE):
                    p = prod(kr[..., q:q + SLICE], dS[:, :, q:q + SLICE])
                    yh = p if yh is None else yh + p
                m = slice(hw * SLICE, (hw + 1) * SLICE)
                yh = yh + prod(a[..., m, :].transpose(-1, -2), oc[:, :, m],
                               exact_b=exact)
                halves.append(yh)
            dv[:, :, sl, cs] = halves[0] + halves[1]
            dS = fma(d16[..., None], dS, chain(rd.transpose(-1, -2), oc,
                                               exact_b=exact))
            # dr^ and dk^: the pairs inside the sub-chunk (dr^ over s
            # ascending, dk^ over m descending), then the decayed inter term
            acc = [torch.zeros((n, h, dp)) for _ in range(C)]
            for s in range(C - 1):
                kp = kc[:, :, s]
                for tt in range(s + 1, C):
                    acc[tt] = fma(b[:, :, tt, s, None], kp, acc[tt])
                    kp = kp * dc[:, :, tt]
            drh, xd = [], torch.ones((n, h, dp))
            for tt in range(C):
                drh.append(fma(xd, x[:, :, tt], acc[tt]))
                xd = xd * dc[:, :, tt]
            acc = [torch.zeros((n, h, dp)) for _ in range(C)]
            for mm in range(C - 1, 0, -1):
                rp = rc[:, :, mm]
                for tt in range(mm - 1, -1, -1):
                    acc[tt] = fma(b[:, :, mm, tt, None], rp, acc[tt])
                    rp = rp * dc[:, :, tt]
            dkh, xd = [None] * C, torch.ones((n, h, dp))
            for tt in reversed(range(C)):
                dkh[tt] = fma(xd, y[:, :, tt], acc[tt])
                xd = xd * dc[:, :, tt]
            # the u terms, du, and dlw from Phi back over the tokens
            xr = phi
            for tt in reversed(range(C)):
                cc = b[:, :, tt, tt, None]
                xr = fma(-kc[:, :, tt], dkh[tt], xr)
                at = c * C + tt
                parts[2, tile, :, :, at] = xr
                xr = fma(rc[:, :, tt], drh[tt], xr)
                parts[0, tile, :, :, at] = fma(uf * kc[:, :, tt], cc, drh[tt])
                parts[1, tile, :, :, at] = fma(uf * rc[:, :, tt], cc, dkh[tt])
                du_acc = fma(rc[:, :, tt] * kc[:, :, tt], cc, du_acc)
            if c > 0:
                phi = phi_parts(starts[c][..., cs], dS)
        ds0[..., cs] = dS
        du_parts[tile] = du_acc
    sums = torch.zeros((3, n, h, nc * C, dp))
    for tile in range(tiles):
        sums = sums + parts[:, tile]
    du = torch.zeros((h, dp))
    for i in range(n):
        for tile in range(tiles):
            du = du + du_parts[tile, i]
    cut = (slice(None), slice(None), slice(0, t), slice(0, d))
    return (sums[0][cut], sums[1][cut], dv[cut], sums[2][cut] * lw,
            du[:, :d], ds0[..., :d, :d])


MODEL_SHAPES = [(t, 64) for t in (1, 15, 16, 17, 45)] + \
    [(37, d) for d in (3, 8, 80, 128)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,d", MODEL_SHAPES)
def test_kernel_model_matches_plain_and_jax(t, d, with_state):
    args = inputs(t * 17 + d, 2, 2, t, d, with_state)
    got = bwd_model(*torch_args(args))
    names = NAMES if with_state else NAMES[:5]
    vanishes = t == 1 and not with_state
    want = plain(args)
    check(got, want, names, 2e-5, dw_scales(want, vanishes))
    want = jax_grads(*args)
    check(got, want, names, 1e-4, dw_scales(want, vanishes))


@pytest.mark.parametrize("w_range", [(-10.0, 4.0), (-10.0, -10.0),
                                     (4.0, 4.0)])
def test_kernel_model_extreme_decay(w_range):
    args = inputs(11, 2, 2, 45, 64, True, w_range)
    got = bwd_model(*torch_args(args))
    for want in (jax_grads(*args), plain(args)):
        check(got, want, NAMES, 1e-4, dw_scales(want, w_range == (4.0, 4.0)))


def test_kernel_model_in_bf16():
    """bf16 r, k, v, dO (the model's dtype): v and dO exact in TF32 (two
    products of three), dr, dk, dv rounded to bf16 against the plain
    backward's on the same bf16 inputs, 1e-2 of each max; dw, du and
    dstate0 fp32 at 1e-4."""
    args = torch_args(inputs(5, 2, 2, 45, 64, True), torch.bfloat16)
    got = list(bwd_model(*args, exact=True))
    got[:3] = [g.to(torch.bfloat16) for g in got[:3]]
    want = ref.rwkv6_scan_bwd_ref(*args)
    assert [g.dtype for g in want[:3]] == [torch.bfloat16] * 3
    check(got[:3], want[:3], NAMES[:3], 1e-2)
    check(got[3:], want[3:], NAMES[3:], 1e-4)
    for x in (args[2], args[6]):
        hi, _ = split(x.float())
        assert torch.equal(hi, x.float())


# ---------------------------------------------------------------------------
# the autograd path on the CPU
# ---------------------------------------------------------------------------

def test_rwkv6_scan_backward_on_the_cpu_is_the_plain_one(monkeypatch):
    """``RWKV6Scan`` on CPU tensors: its backward is
    ``ref.rwkv6_scan_bwd_ref`` (no launch counted), the gradients of each
    input that requires grad (the state's too), None for the others, and
    a final state left unused gives a None cotangent."""
    args = torch_args(inputs(3, 2, 3, 21, 16, True))
    calls = []
    plain_bwd = ref.rwkv6_scan_bwd_ref

    def counting(*a, **kw):
        calls.append(a[7] is None)
        return plain_bwd(*a, **kw)

    monkeypatch.setattr(ref, "rwkv6_scan_bwd_ref", counting)
    ops.reset_launch_counts()
    leaves = [a.clone().requires_grad_(i in (0, 3, 5))
              for i, a in enumerate(args[:6])]
    out, _ = ops.rwkv6_scan(*leaves)
    got = torch.autograd.grad(out, [leaves[i] for i in (0, 3, 5)], args[6])
    assert calls == [True]
    assert sum(ops.launch_counts().values()) == 0
    want = plain_bwd(*args[:7], None)
    for g, wv in zip(got, (want[0], want[3], want[5])):
        assert torch.equal(g, wv)

"""Plain PyTorch versions of every kernel of the port (the
counterparts of the JAX package's ``kernels/ref.py``).

They compute the same functions as the Hopper kernels, in full fp32,
with ordinary tensor operations: the CPU path runs them, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds each
kernel against them on the card.  Conv weights stored in bf16 or int8
are read exactly in fp32, and an int8 filter's per-output-channel scale
multiplies the fp32 sum before the bias, as in the JAX kernels.  The
convolutions are written as nine shifted channel matmuls (the kernels'
own arithmetic) rather than a library convolution, and attention as an
explicit softmax.  Layouts are the JAX package's: NHWC activations,
HWIO weights, ``[n, h, s, d]`` attention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gn_stats_ref(x: torch.Tensor, groups: int, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, group) mean and ``rsqrt(var + eps)`` over (H, W, C/G)."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    var = xf.var(dim=(1, 3), correction=0)
    return mean, torch.rsqrt(var + eps)


def group_norm_silu_ref(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int = 32,
                        eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm (fp32 stats) + SiLU, NHWC."""
    n, h, w, c = x.shape
    mean, rstd = gn_stats_ref(x, groups, eps)
    xf = x.float().reshape(n, h * w, groups, c // groups)
    xf = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    xf = xf.reshape(n, h, w, c) * scale.float() + bias.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _scale_bias(acc, w_scale, b):
    """The JAX kernels' epilogue order: the fp32 sum times the per-Cout
    dequant scale (int8 storage), then the bias."""
    if w_scale is not None:
        acc = acc * w_scale.float()
    if b is not None:
        acc = acc + b.to(acc.dtype)
    return acc


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME conv, NHWC x HWIO -> NHWC, as nine shifted matmuls.  ``w``
    is fp32, bf16 or int8 (then with its per-Cout ``w_scale``); each tap
    is read in fp32, which holds bf16 and int8 values exactly."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, wd, cout), dtype=x.dtype, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + torch.matmul(xp[:, dy:dy + h, dx:dx + wd, :],
                                     w[dy, dx].to(x.dtype))
    return _scale_bias(acc, w_scale, b)


def gn_silu_conv3x3_ref(x, scale, bias, w, b=None, groups: int = 32,
                        eps: float = 1e-6, w_scale=None) -> torch.Tensor:
    """``conv3x3(silu(group_norm(x)))``."""
    return conv3x3_ref(group_norm_silu_ref(x, scale, bias, groups, eps), w, b,
                       w_scale)


_PHASE_TAPS = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """Collapse a ``[3, 3, Cin, Cout]`` filter into the ``[2, 2, 2, 2,
    Cin, Cout]`` per-phase 2x2 filters (index order ``[pi, pj, a, b]``):
    output pixel ``(2i+pi, 2j+pj)`` of ``conv3x3(upsample2x(x))`` is
    ``sum_ab x[i+pi+a-1, j+pj+b-1] @ out[pi, pj, a, b]``.

    The taps are added in ``w``'s own dtype, left to right from 0 as
    Python's ``sum`` does, like the JAX package's ``phase_weights``: an
    int16 filter (int8 codes widened) sums exactly (|sum| <= 4 * 127); a
    bf16 filter rounds to bf16 after each add, as the reference does."""
    rows = []
    for pi in (0, 1):
        cols = []
        for pj in (0, 1):
            taps_a = []
            for dys in _PHASE_TAPS[pi]:
                taps_a.append(torch.stack([
                    sum(w[dy, dx] for dy in dys for dx in dxs)
                    for dxs in _PHASE_TAPS[pj]]))
            cols.append(torch.stack(taps_a))
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def storage_phase_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`phase_weights` of a stored filter: int8 codes collapse in
    int16, fp32 and bf16 filters in their own dtype."""
    return phase_weights(w.to(torch.int16) if w.dtype == torch.int8 else w)


def upsample_conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None,
                         w_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``conv3x3(nearest_upsample_2x(x))``.

    An fp32 or int8 filter convolves the upsampled tensor: its phase
    collapse is exact up to fp32 rounding.  A bf16 filter's collapse
    rounds (see :func:`phase_weights`), so the function of bf16 storage
    is the phase form with the collapsed bf16 taps, which this computes:
    four 2x2 convs of the pre-upsample tensor, interleaved."""
    if w.dtype != torch.bfloat16:
        x2 = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv3x3_ref(x2, w, b, w_scale)
    return upsample_conv3x3_phase_ref(x, phase_weights(w), b, w_scale)


def upsample_conv3x3_phase_ref(x: torch.Tensor, wc: torch.Tensor,
                               b: Optional[torch.Tensor] = None,
                               w_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The upsampler's phase form from taps already collapsed by
    :func:`storage_phase_weights` (``wc [2, 2, 2, 2, Cin, Cout]``, fp32,
    bf16, or int16 codes with ``w_scale``): four 2x2 convs of the
    pre-upsample tensor, interleaved into ``[N, 2H, 2W, Cout]``."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty((n, 2 * h, 2 * wd, wc.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for pi in (0, 1):
        for pj in (0, 1):
            acc = torch.zeros((n, h, wd, wc.shape[-1]), dtype=x.dtype,
                              device=x.device)
            for a in (0, 1):
                for c in (0, 1):
                    acc = acc + torch.matmul(
                        xp[:, pi + a:pi + a + h, pj + c:pj + c + wd, :],
                        wc[pi, pj, a, c].to(x.dtype))
            out[:, pi::2, pj::2, :] = _scale_bias(acc, w_scale, b)
    return out


def quantize_u8_ref(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float image -> uint8 display bytes.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    yf = torch.clamp(y.float(), -1.0, 1.0)
    return torch.round((yf + 1.0) * 127.5).to(torch.uint8)


def output_epilogue_ref(x, scale, bias, w, b=None, groups: int = 32,
                        eps: float = 1e-6, w_scale=None) -> torch.Tensor:
    """``quantize_u8(conv3x3(silu(group_norm(x))))``."""
    return quantize_u8_ref(gn_silu_conv3x3_ref(x, scale, bias, w, b,
                                               groups, eps, w_scale))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention.  q: [n, hq, sq, d]; k, v: [n, hkv, skv, d];
    hq a multiple of hkv (GQA broadcast: q head h reads kv head
    ``h // (hq // hkv)``); causal/window masks align q and k at the
    sequence end.  A row with no key left (sq > skv under ``causal``)
    gives 0."""
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal or window is not None:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1).masked_fill(
            ~mask.any(dim=-1, keepdim=True), 0.0)
    else:
        p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


#: query rows per block of :func:`flash_attention_bwd_ref`: at the
#: Qwen2-7B training shape (28 heads, 2048 keys, batch 2) a block's fp32
#: scores are 2 x 28 x 512 x 2048 x 4 bytes = 235 MB, a quarter of the
#: whole call's
BWD_BLOCK_ROWS = 512


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = False,
                            scale: Optional[float] = None,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradient of :func:`flash_attention_ref` at (q, k, v), given its
    output ``o`` and the output's gradient ``do``: (dq, dk, dv), each in
    its input's dtype.

    It works in fp32 (fp64 inputs in fp64) on blocks of
    :data:`BWD_BLOCK_ROWS` query rows, recomputing each block's
    probabilities P from q and k under the forward's masks (causal and
    window aligned at the sequence end, a row with no key gives 0), so
    no ``[n, hq, sq, skv]`` tensor of the whole call is held; a block
    reads only the keys its masks leave.  With dP = dO V^T and D the
    row sums of dO * O (FlashAttention-2's identity for the row sums of
    P * dP), dS = P (dP - D) * scale, dq = dS k, dk = dS^T q and dv =
    P^T dO; dk and dv sum each group of ``hq // hkv`` query heads (GQA).
    """
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    ct = torch.promote_types(q.dtype, torch.float32)
    kx, vx = k.to(ct), v.to(ct)
    if rep > 1:
        kx = kx.repeat_interleave(rep, dim=1)
        vx = vx.repeat_interleave(rep, dim=1)
    dq = torch.zeros((n, hq, sq, d), dtype=ct, device=q.device)
    dk = torch.zeros((n, hq, skv, d), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    shift = skv - sq                      # query i sits at position i + shift
    for r0 in range(0, sq, BWD_BLOCK_ROWS):
        r1 = min(sq, r0 + BWD_BLOCK_ROWS)
        k0, k1 = 0, skv
        if causal:
            k1 = min(skv, r1 + shift)
        if window is not None:
            k0 = max(0, r0 + shift - window + 1)
        if k1 <= k0:                      # no key left: P = 0
            continue
        qb = q[:, :, r0:r1].to(ct)
        dob = do[:, :, r0:r1].to(ct)
        kb, vb = kx[:, :, k0:k1], vx[:, :, k0:k1]
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        if causal or window is not None:
            qpos = torch.arange(r0, r1, device=q.device)[:, None] + shift
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            mask = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            p = p.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
        else:
            p = torch.softmax(s, dim=-1)
        dv[:, :, k0:k1] += torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        rows = (dob * o[:, :, r0:r1].to(ct)).sum(dim=-1, keepdim=True)
        ds = p * (dp - rows) * scale
        dq[:, :, r0:r1] = torch.matmul(ds, kb)
        dk[:, :, k0:k1] += torch.matmul(ds.transpose(-1, -2), qb)
    if rep > 1:
        dk = dk.reshape(n, hkv, rep, skv, d).sum(dim=2)
        dv = dv.reshape(n, hkv, rep, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against a KV cache.  q: [n, hq, d];
    k_cache/v_cache: [n, hkv, S, d]; lengths: [n] valid prefix lengths
    (a sequence of length 0 gives 0).  Returns [n, hq, d]."""
    return decode_attention_partial_ref(q, k_cache, v_cache, lengths,
                                        scale)[0].to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 lengths: torch.Tensor,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_ref` before its output is rounded: (o
    [n, hq, d] fp32, normalised over the row's keys, and lse [n, hq]
    fp32, the log-sum-exp of its scaled scores; o = 0 and lse = -inf on a
    row of length 0)."""
    n, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    if rep > 1:
        k_cache = k_cache.repeat_interleave(rep, dim=1)
        v_cache = v_cache.repeat_interleave(rep, dim=1)
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("nhd,nhsd->nhs", q.float(), k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, :]       # [n, 1, S]
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = p.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
    return (torch.einsum("nhs,nhsd->nhd", p, v_cache.float()),
            torch.logsumexp(logits, dim=-1))


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 linear-attention recurrence (per head), fp32 state, one token
    at a time.  r, k, v, w: [n, h, t, d]; u: [h, d]; state [n, h, d, d]
    (zeros if None)::

        out_t = r_t . (S + u (x) (k_t (x) v_t))
        S     = diag(exp(-exp(w_t))) S + k_t (x) v_t

    Returns (out [n, h, t, d] in r's dtype, final state fp32).  float64
    inputs are computed, and their state returned, in float64 (the
    tests' exact reference for the backward)."""
    n, h, t, d = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    s = (torch.zeros((n, h, d, d), dtype=ct, device=r.device)
         if state is None else state.to(ct))
    rf, kf, vf = r.to(ct), k.to(ct), v.to(ct)
    decay = torch.exp(-torch.exp(w.to(ct)))
    uf = u.to(ct)[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]        # [n,h,d,d]
        outs.append(torch.einsum("nhd,nhde->nhe", rf[:, :, i], s + uf * kv))
        s = decay[:, :, i, :, None] * s + kv
    return torch.stack(outs, dim=2).to(r.dtype), s


def rwkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor,
                      state: Optional[torch.Tensor] = None,
                      chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`rwkv6_scan_ref` in the JAX package's
    chunked form (``models/ssm.py``'s ``rwkv6_chunked``, the form its
    RWKV-6 block differentiates): per chunk of ``chunk`` tokens (halved
    until it divides t) the inter-chunk term from the carried state, the
    intra-chunk pairs and the diagonal bonus, then the state update.  The
    pairwise decays are ``exp(min(L_t - L_s, 0))`` on the masked lower
    triangle, never ``exp(+L) * exp(-L)``, so no ``exp`` overflows, in
    the forward or in its gradient.  Same arguments and results as
    :func:`rwkv6_scan_ref`.  Only the d x d state crosses chunks: every
    other term is computed for all chunks in one batched op each, and a
    Python loop of two ops a chunk carries the state where JAX scans.  No
    path of the port calls it (``RWKV6Scan``'s backward is
    :func:`rwkv6_scan_bwd_ref` on the CPU): it is the JAX form's
    counterpart for the tests."""
    b, h, t, d = r.shape
    chunk = min(chunk, t)
    while t % chunk:
        chunk //= 2
    nc = t // chunk
    f32 = torch.float32
    logw = -torch.exp(w.to(f32))                             # <= 0
    rs = r.to(f32).reshape(b, h, nc, chunk, d)
    ks = k.to(f32).reshape(b, h, nc, chunk, d)
    vs = v.to(f32).reshape(b, h, nc, chunk, d)
    lw = logw.reshape(b, h, nc, chunk, d)
    L = torch.cumsum(lw, dim=3)                              # inclusive
    Lp = L - lw                                              # L_{t-1}
    uf = u.to(f32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    # every chunk at once: the intra-chunk pairs (t > s), exp(Lp_t - L_s)
    # <= 1 on the mask, the diagonal bonus (r_t * u) . k_t v_t, and each
    # chunk's own part of the state after it
    expo = Lp[:, :, :, :, None, :] - L[:, :, :, None, :, :]
    dec = torch.exp(torch.clamp(expo, max=0.0)) * mask[:, :, None]
    A = torch.einsum("bhntd,bhnsd,bhntsd->bhnts", rs, ks, dec)
    y_intra = torch.einsum("bhnts,bhnse->bhnte", A, vs)
    sdiag = torch.einsum("bhntd,hd,bhntd->bhnt", rs, uf, ks)
    Llast = L[:, :, :, -1:, :]
    kd = ks * torch.exp(torch.clamp(Llast - L, max=0.0))
    kv = torch.einsum("bhnsd,bhnse->bhnde", kd, vs)
    carry = torch.exp(Llast[:, :, :, 0])[..., None]
    # only the state crosses chunks: each chunk's carry-in
    S = (torch.zeros((b, h, d, d), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = carry[:, :, c] * S + kv[:, :, c]
    y_inter = torch.einsum("bhncd,bhnde->bhnce", rs * torch.exp(Lp),
                           torch.stack(starts, dim=2))
    ys = y_inter + y_intra + sdiag[..., None] * vs
    out = ys.reshape(b, h, t, d)
    return out.to(r.dtype), S


#: tokens per sub-chunk of the RWKV-6 kernels (``C`` in
#: ``csrc/rwkv6_chunk.cuh``), the backward's unit of work
RWKV_CHUNK = 16


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       state: Optional[torch.Tensor] = None,
                       dout: Optional[torch.Tensor] = None,
                       dstate: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du, dstate0) of
    :func:`rwkv6_scan_ref` at (r, k, v, w, u, state) against the
    cotangents ``dout`` of its output and ``dstate`` of its final state
    (either None: zero), in closed form with no autograd, chunked as
    ``csrc/rwkv6_scan_bwd.cu`` walks it.  With S_t the state after token
    t, dec = exp(lw), lw = -exp(w), and dS_t the cotangent of S_t
    (dS_T = dstate)::

        dS_{t-1} = diag(dec_t) dS_t + r_t dO_t^T        (dS_0: dstate0)
        dr^_t = S_{t-1} dO_t,   dk^_t = dS_t v_t,   c_t = dO_t . v_t
        dr_t = dr^_t + u (.) k_t c_t,   dk_t = dk^_t + u (.) r_t c_t
        dv_t = dS_t^T k_t + dO_t (r_t . (u (.) k_t))
        du   = sum over n, t of r_t (.) k_t c_t
        dlw_t = Phi + sum_{m>t} r_m (.) dr^_m - sum_{m>=t} k_m (.) dk^_m
        dw_t = dlw_t (.) lw_t

    where, per sub-chunk of ``RWKV_CHUNK`` tokens (t padded with r = k =
    v = dO = 0 and dec = 1), Phi = rowsum(S (.) dS) at the sub-chunk's
    end and the sums run over its tokens: the dw carry restarts from the
    state at each sub-chunk's end, so no running sum spans more than 16
    tokens.  Inside a sub-chunk S_{t-1} and dS_t are the carried states
    decayed by exp(Lp_t) and exp(L_last - L_t) (Lp, L: exclusive and
    inclusive sums of lw over the sub-chunk) plus the pairs between its
    tokens, decayed by exp(min(Lp_t - L_s, 0)) <= 1, as in
    :func:`rwkv6_chunked_ref`.  dr, dk, dv come back in r's dtype, dw,
    du and dstate0 in fp32 (float64 for float64 inputs)."""
    n, h, t, d = r.shape
    C = RWKV_CHUNK
    nc = -(-t // C)
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    dev = r.device

    def chunks(x):                        # [n, h, t, d] -> [n, h, nc, C, d]
        x = F.pad(x.to(ct), (0, 0, 0, nc * C - t))
        return x.reshape(n, h, nc, C, x.shape[-1])

    lw = -torch.exp(w.to(ct))
    rs, ks, vs, lws = (chunks(x) for x in (r, k, v, lw))
    dos = (torch.zeros_like(rs) if dout is None else chunks(dout))
    L = torch.cumsum(lws, dim=3)                          # inclusive
    Lp = L - lws
    Llast = L[:, :, :, -1:, :]
    dec_start = torch.exp(Lp)                             # D_t
    dec_end = torch.exp(torch.clamp(Llast - L, max=0.0))  # E_t
    d16 = torch.exp(Llast[:, :, :, 0])                    # [n, h, nc, d]
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev),
                       diagonal=-1)
    pair = torch.exp(torch.clamp(Lp[:, :, :, :, None, :]
                                 - L[:, :, :, None, :, :], max=0.0))
    pair = pair * lower[:, :, None]                       # [.., t, s, d]
    kr = ks * dec_end
    rd = rs * dec_start
    # the states at each sub-chunk's start (and S_T), then the cotangents
    # at each sub-chunk's end, walking back from dS_T
    kv = torch.einsum("bhnsi,bhnsj->bhnij", kr, vs)
    S = (torch.zeros((n, h, d, d), dtype=ct, device=dev) if state is None
         else state.to(ct))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = d16[:, :, c, :, None] * S + kv[:, :, c]
    s_end = torch.stack(starts[1:] + [S], dim=2)
    s_start = torch.stack(starts, dim=2)
    rdo = torch.einsum("bhnti,bhntj->bhnij", rd, dos)
    dS = (torch.zeros((n, h, d, d), dtype=ct, device=dev) if dstate is None
          else dstate.to(ct))
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = d16[:, :, c, :, None] * dS + rdo[:, :, c]
    ds_end = torch.stack(ends, dim=2)
    # every sub-chunk at once: B_ts = dO_t . v_s, A_ts of the forward
    B = torch.einsum("bhntj,bhnsj->bhnts", dos, vs)
    cdiag = torch.diagonal(B, dim1=-2, dim2=-1)           # c_t
    bl = B * lower
    drh = dec_start * torch.einsum("bhntj,bhnij->bhnti", dos, s_start) \
        + torch.einsum("bhnts,bhnsi,bhntsi->bhnti", bl, ks, pair)
    dkh = dec_end * torch.einsum("bhntj,bhnij->bhnti", vs, ds_end) \
        + torch.einsum("bhnts,bhnti,bhntsi->bhnsi", bl, rs, pair)
    uf = u.to(ct)[None, :, None, None, :]
    A = torch.einsum("bhnti,bhnsi,bhntsi->bhnts", rs, ks, pair) \
        + torch.diag_embed((rs * uf * ks).sum(-1))
    dv = torch.einsum("bhnti,bhnij->bhntj", kr, ds_end) \
        + torch.einsum("bhnmt,bhnmj->bhntj", A, dos)
    bonus = cdiag[..., None]
    dr = drh + uf * ks * bonus
    dk = dkh + uf * rs * bonus
    du = (rs * ks * bonus).sum(dim=(0, 2, 3))
    phi = (s_end * ds_end).sum(-1)                        # [n, h, nc, d]
    a, b = rs * drh, ks * dkh
    tail_a = torch.flip(torch.cumsum(torch.flip(a, [3]), 3), [3]) - a
    tail_b = torch.flip(torch.cumsum(torch.flip(b, [3]), 3), [3])
    dw = (phi[:, :, :, None] + tail_a - tail_b) * lws

    def unchunk(x, dtype):
        return x.reshape(n, h, nc * C, d)[:, :, :t].to(dtype)

    out_t = ct if r.dtype == torch.float64 else r.dtype
    return (unchunk(dr, out_t), unchunk(dk, out_t), unchunk(dv, out_t),
            unchunk(dw, ct), du, dS)

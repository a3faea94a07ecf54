"""The GroupNorm statistics pass of the port (``csrc/gn_stats.cu``),
modelled on the CPU, and the facade's unported entry points.

The kernel runs only on the card, so :func:`stats_model` repeats its
arithmetic in float32 PyTorch, rounding for rounding: each thread folds
batches of four loads (sixteen values on the float4 path, four on the
scalar one) into a running (count, mean, M2) by a shifted sum about its
running mean, one reciprocal per batch; the block merges its threads with
Chan's formula in a fixed tree over each group's slots; the second pass
merges the slices of each (image, group) in the kernel's order (128
threads in slice order, the warps' shuffle trees, then warps 0..3).  The
model is held against float64 at offsets where E[x^2] - E[x]^2 in
float32 cancels, and its GroupNorm + SiLU against the JAX package's
Pallas kernel (``group_norm_silu``, interpret mode) at 1, 2, 4 and 16
channels per group and ragged pixel counts.  ``tests/test_torch_cuda.py``
holds the kernel to the model bit for bit on the card.

The facade cases: the port's ``LatentBox.engine`` takes the reference's
keywords and builds a sharded box where the reference does (until
ROADMAP A 6 ported it, it raised); ``simulated`` and ``open`` (A 6 and
A 5) build their boxes; ``serve_stream`` still names A 6; ``flush``,
``close`` and the context manager work on an in-memory box.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gn_silu_conv import stats_slices

torch.set_num_threads(2)

THREADS, BATCH, FIN_THREADS = 256, 4, 128


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def fma32(a, b, c):
    """``fmaf`` on float32 tensors: a * b + c rounded once.  The product
    is exact in float64; the float64 sum's error is recovered (TwoSum) to
    settle a float64 result that lands exactly between two floats."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    fd = f.double()
    inf = torch.full_like(f, float("inf"))
    nb = torch.nextafter(f, torch.where(s > fd, inf, -inf))
    tie = (s != fd) & ((s - fd) * 2 == nb.double() - fd)
    away = tie & (err != 0) & ((err > 0) == (nb.double() > fd))
    return torch.where(away, nb, f)


def rcp(t):
    """``__frcp_rn``: 1 / t rounded once (float64, then float32: double
    rounding is harmless for a quotient or a root of float32 values)."""
    return (1.0 / t.double()).float()


def chan(a, b):
    """Chan's merge of (count, mean, M2) triples, as ``gn_stats.cu``."""
    n = a[0] + b[0]
    f = b[0] * rcp(n)
    d = b[1] - a[1]
    t = (d * d) * a[0]
    merged = (n, fma32(d, f, a[1]), fma32(t, f, a[2] + b[2]))
    return tuple(torch.where(b[0] == 0, x, torch.where(a[0] == 0, y, z))
                 for x, y, z in zip(a, b, merged))


def fold(acc, vals, m):
    """Fold m (per thread) values of ``vals [..., M]`` into acc, summed
    about the running mean (the first value for the first batch)."""
    mean = torch.where(acc[0] == 0, vals[..., 0], acc[1])
    s1 = torch.zeros_like(mean)
    s2 = torch.zeros_like(mean)
    for i in range(vals.shape[-1]):
        d = vals[..., i] - mean
        s1 = torch.where(i < m, s1 + d, s1)
        s2 = torch.where(i < m, fma32(d, d, s2), s2)
    n = acc[0] + m.float()
    e = s1 * rcp(n)
    new = (n, mean + e, acc[2] + fma32(-s1, e, s2))
    return tuple(torch.where(m > 0, y, x) for x, y in zip(acc, new))


def tree(a, width):
    """The kernel's fixed pairwise tree over the last axis (slot s takes
    slot s + w where s % 2w == 0); returns slot 0."""
    a = [t.clone() for t in a]
    w = 1
    while w < width:
        lo = torch.arange(0, width, 2 * w)
        lo = lo[lo + w < width]
        m = chan(tuple(t[..., lo] for t in a), tuple(t[..., lo + w] for t in a))
        for t, v in zip(a, m):
            t[..., lo] = v
        w *= 2
    return tuple(t[..., 0] for t in a)


def partial_model(x, groups, slices):
    """Pass 1: [N, G, S] (count, mean, M2) of x [N, HW, C] fp32."""
    n, hw, c = x.shape
    cpg = c // groups
    vw = 4 if c % 4 == 0 and cpg % 4 == 0 else 1
    ug = cpg // vw
    gpb = 1 if ug >= THREADS else min(groups, THREADS // ug)
    p = -(-hw // slices)
    s = torch.arange(slices)
    p0 = torch.clamp(s * p, max=hw)
    np_ = torch.clamp(p0 + p, max=hw) - p0
    t = torch.arange(THREADS)
    xf = x.reshape(n, -1)
    out = [torch.zeros((n, groups, slices)) for _ in range(3)]
    for g0 in range(0, groups, gpb):
        ng = min(gpb, groups - g0)
        units = ng * ug
        if units <= THREADS:
            ppi = THREADS // units
            u, pofs = t % units, t // units
            k = torch.arange(-(-p // ppi))
            pix = pofs[:, None] + k[None, :] * ppi
            valid = (pofs < ppi)[None, :, None] & (pix[None] < np_[:, None, None])
            off = (p0[:, None, None] + pix[None]) * c + (u * vw)[None, :, None]
            nslots = ppi * ug
            table = torch.stack([(sl // ug) * units + gl * ug + sl % ug
                                 for gl in range(ng)
                                 for sl in [torch.arange(nslots)]])
        else:
            k = torch.arange(-(-p * units // THREADS))
            i = t[:, None] + k[None, :] * THREADS
            valid = i[None] < (np_ * units)[:, None, None]
            off = ((p0[:, None, None] + (i // units)[None]) * c
                   + ((i % units) * vw)[None])
            nslots = THREADS
            table = torch.arange(THREADS)[None]
        off = torch.where(valid, off + g0 * cpg, 0)
        idx = (off[..., None] + torch.arange(vw)).reshape(-1)
        vals = xf[:, idx].reshape(n, slices, THREADS, -1, vw)
        cnt = valid.sum(-1)
        acc = tuple(torch.zeros((n, slices, THREADS)) for _ in range(3))
        for k0 in range(0, vals.shape[3], BATCH):
            v = vals[:, :, :, k0:k0 + BATCH].reshape(n, slices, THREADS, -1)
            m = torch.clamp(cnt - k0, 0, BATCH) * vw
            acc = fold(acc, v, m)
        merged = tree(tuple(a[..., table] for a in acc), nslots)
        for o, v in zip(out, merged):
            o[:, g0:g0 + ng, :] = v.permute(0, 2, 1)
    return out


def finalize_model(part, eps):
    """Pass 2: [N, G, 2] (mean, rstd) from the [N, G, S] partials."""
    n, g, s = part[0].shape
    j = -(-s // FIN_THREADS)
    padded = [torch.nn.functional.pad(t, (0, j * FIN_THREADS - s))
              .reshape(n, g, j, FIN_THREADS) for t in part]
    acc = tuple(torch.zeros((n, g, FIN_THREADS)) for _ in range(3))
    for i in range(j):
        acc = chan(acc, tuple(t[:, :, i] for t in padded))
    acc = tuple(t.reshape(n, g, FIN_THREADS // 32, 32) for t in acc)
    for off in (16, 8, 4, 2, 1):
        acc = chan(tuple(t[..., :off] for t in acc),
                   tuple(t[..., off:2 * off] for t in acc))
    warps = tuple(t[..., 0] for t in acc)
    tot = tuple(t[..., 0] for t in warps)
    for w in range(1, FIN_THREADS // 32):
        tot = chan(tot, tuple(t[..., w] for t in warps))
    var = torch.where(tot[0] > 0, torch.clamp(
        (tot[2].double() / tot[0].double()).float(), min=0.0), 0.0)
    root = (var + torch.tensor(eps, dtype=torch.float32)).double().sqrt()
    return torch.stack([tot[1], rcp(root.float())], dim=-1)


def stats_model(x, groups, eps=1e-6, slices=None):
    """``csrc/gn_stats.cu`` on the CPU: x [N, H, W, C] fp32 -> [N, G, 2]
    (mean, rstd), with the wrapper's slice count unless ``slices`` is
    given."""
    n, h, w, c = x.shape
    slices = stats_slices(h * w, c) if slices is None else slices
    part = partial_model(x.float().reshape(n, h * w, c), groups, slices)
    return finalize_model(part, eps)


def float64_stats(x, groups, eps=1e-6):
    x64 = x.double().reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
    mean = x64.mean(dim=(1, 3))
    rstd = (x64.var(dim=(1, 3), correction=0) + eps).rsqrt()
    return mean, rstd


def inputs(seed, shape, offset, scale=1.0):
    r = np.random.default_rng(seed)
    return torch.from_numpy(
        (r.standard_normal(shape) * scale + offset).astype(np.float32))


# (n, h, w, c, groups): cpg 1, 2, 4 (C/4 odd and even), 16, a group of
# 65 float4s, and one of 258 scalars wider than the block; ragged H * W
SHAPES = [(2, 13, 11, 32, 32), (1, 9, 14, 16, 8), (2, 12, 10, 64, 16),
          (1, 7, 9, 12, 3), (1, 7, 9, 64, 4), (1, 5, 6, 260, 1),
          (1, 5, 6, 258, 1)]


# ---------------------------------------------------------------------------
# the model against float64 and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slices", [None, 3])
@pytest.mark.parametrize("n,h,w,c,groups", SHAPES)
def test_model_against_float64_where_the_squares_cancel(n, h, w, c, groups,
                                                        slices):
    """At an offset of 300 (std 1) the float32 E[x^2] - E[x]^2 loses the
    variance; the model keeps it, as the CUDA test at +300 holds the card
    (1e-4 on the mean, 1e-4 relative on rstd)."""
    x = inputs(1, (n, h, w, c), 300.0)
    got = stats_model(x, groups, slices=slices)
    mean, rstd = float64_stats(x, groups)
    assert float((got[..., 0].double() - mean).abs().max()) <= 1e-4
    assert float(((got[..., 1].double() - rstd) / rstd).abs().max()) <= 1e-4
    xf = x.reshape(n, -1, groups, c // groups)
    naive = (xf * xf).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)) ** 2
    assert float(((naive.double() + 1e-6).rsqrt() / rstd - 1).abs().max()
                 ) > 1e-3 or bool(torch.isnan((naive + 1e-6).rsqrt()).any())


@pytest.mark.parametrize("n,h,w,c,groups,offset", [
    (1, 128, 128, 128, 32, 30.0), (1, 96, 80, 512, 32, 300.0),
    (1, 64, 64, 256, 32, 300.0)])
def test_model_at_decoder_widths_against_float64(n, h, w, c, groups, offset):
    """The decoder's channel counts with about 65 k values per group: a
    slice is many batches long, and every merge level takes part."""
    x = inputs(2, (n, h, w, c), offset)
    got = stats_model(x, groups)
    mean, rstd = float64_stats(x, groups)
    assert float((got[..., 0].double() - mean).abs().max()) <= 1e-4
    assert float(((got[..., 1].double() - rstd) / rstd).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,h,w,c,groups", SHAPES[:5])
def test_model_group_norm_silu_against_the_pallas_kernel(n, h, w, c, groups):
    """GroupNorm + SiLU from the model's statistics against the JAX
    package's ``group_norm_silu`` (its ``_stats_kernel`` and
    ``_apply_kernel`` in interpret mode), at the offset and scale of the
    card's test (x * 3 + 1.5), within its 2e-5 of the output's max."""
    import jax.numpy as jnp
    from repro.kernels.gn_silu import group_norm_silu as jax_gn_silu
    x = inputs(3, (n, h, w, c), 1.5, scale=3.0)
    r = np.random.default_rng(4)
    scale = r.standard_normal(c).astype(np.float32)
    bias = r.standard_normal(c).astype(np.float32)
    st = stats_model(x, groups)
    xf = x.reshape(n, -1, groups, c // groups)
    y = ((xf - st[:, None, :, None, 0]) * st[:, None, :, None, 1]
         ).reshape(x.shape) * torch.from_numpy(scale) + torch.from_numpy(bias)
    got = y * torch.sigmoid(y)
    want = np.asarray(jax_gn_silu(jnp.asarray(x.numpy()), jnp.asarray(scale),
                                  jnp.asarray(bias), groups=groups,
                                  interpret=True))
    assert float(np.abs(got.numpy() - want).max()) <= \
        2e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("n,h,w,c,groups", SHAPES[:3])
def test_model_image_alone_equals_its_batch_row(n, h, w, c, groups):
    """Each image's statistics come from its own blocks in a fixed order,
    so image i of a batch has the bits it has alone."""
    x = inputs(5, (3, h, w, c), 0.5, scale=2.0)
    batch = stats_model(x, groups)
    for i in range(3):
        assert torch.equal(stats_model(x[i:i + 1], groups), batch[i:i + 1])


@pytest.mark.parametrize("hw,c", [(512 * 512, 128), (512 * 512, 256),
                                  (256 * 256, 512), (256 * 256, 256),
                                  (128 * 128, 512), (64 * 64, 512), (35, 16),
                                  (1, 4)])
def test_slices_cover_every_pixel_from_the_shape_alone(hw, c):
    s = stats_slices(hw, c)
    p = -(-hw // s)
    assert 1 <= s <= min(hw, 512)
    assert (s - 1) * p < hw <= s * p    # every pixel once, no slice past HW
    assert p <= -(-hw // min(hw, 132))  # a block per SM where it can


# ---------------------------------------------------------------------------
# the facade's entry points, ported by ROADMAP A 5 and A 6
# ---------------------------------------------------------------------------

def _cfg():
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.store import StoreConfig
    return StoreConfig(n_nodes=2, cache_bytes_per_node=2e4, image_bytes=768.0,
                       latent_bytes=6e2, promote_threshold=2,
                       tuner=TunerConfig(window=10**9))


def _box(**kw):
    from repro_torch.store import LatentBox
    return LatentBox.engine(device="cpu", config=_cfg(), **kw)


def _round_trip(box):
    z = np.random.default_rng(0).standard_normal((8, 8, 4))
    box.put(1, latent=z.astype(np.float16))
    r = box.get(1)
    assert r.hit_class == "full_miss"
    return r


def _fault_plan():
    from repro_torch.store.faults import FaultPlan
    return FaultPlan()


def _hedge():
    from repro_torch.store.replication import HedgeConfig
    return HedgeConfig()


@pytest.mark.parametrize("kw", [dict(shards=2), dict(replication=2),
                                dict(fault_plan=_fault_plan),
                                dict(shards=3, replication=2, hedge=_hedge)])
def test_engine_names_a6_where_the_reference_shards(kw):
    """Where the reference builds a ShardedLatentBox, so does the port
    (this raised naming ROADMAP A 6 until A 6 ported it)."""
    kw = {k: v() if callable(v) else v for k, v in kw.items()}
    box = _box(**kw)
    assert box.backend.name == "sharded"
    assert box.backend.n_shards == kw.get("shards", 1)
    assert box.backend.replication == kw.get("replication", 1)
    assert _round_trip(box).payload.shape == (16, 16, 3)


@pytest.mark.parametrize("kw", [dict(), dict(shards=1),
                                dict(replication=1), dict(hedge=5.0),
                                dict(shards=1, replication=None, hedge=None,
                                     fault_plan=None)])
def test_engine_takes_the_reference_keywords(kw):
    box = _box(**kw)
    assert box.summary() is not None


#: each constructor with the ROADMAP item that ported it (they raised
#: naming that item before)
@pytest.mark.parametrize("call,item", [
    (lambda LB, d: LB.simulated(), "ROADMAP A 6"),
    (lambda LB, d: LB.simulated(shards=2, replication=2), "ROADMAP A 6"),
    (lambda LB, d: LB.open(d / "box", config=_cfg(), device="cpu"),
     "ROADMAP A 5"),
    (lambda LB, d: LB.open(d / "box", mode="sim", shards=2), "ROADMAP A 5")])
def test_unported_constructors_name_their_item(call, item, tmp_path):
    from repro_torch.store import LatentBox
    box = call(LatentBox, tmp_path)
    r = _round_trip(box)
    assert (r.payload is None) == (box.backend.name != "engine")
    if item == "ROADMAP A 5":
        assert r.hit_class == "full_miss"
        box.close()
        reopened = call(LatentBox, tmp_path)
        assert 1 in reopened         # the put survived the close
        reopened.close()


def test_serve_stream_names_a6():
    """``serve_stream`` raised naming ROADMAP A 6 until A 6 ported the
    serving runtime: it now replays requests through it, with the
    service model derived from the box's ``StoreConfig``."""
    from repro_torch.serve.runtime import Request
    box = _box()
    _round_trip(box)
    rep = box.serve_stream([Request(oid=1, arrival_ms=0.0),
                            Request(oid=1, arrival_ms=5.0)], runtime_cfg=None)
    assert [h for h, _ in rep.outcomes] == ["latent_hit", "latent_hit"]
    assert rep.counters["served"] == 2
    assert box.serve_stream([]).outcomes == []


def test_lifecycle_on_an_in_memory_box():
    z = np.random.default_rng(0).standard_normal((8, 8, 4))
    with _box() as box:
        box.put(1, latent=z.astype(np.float16))
        box.flush()
        assert 1 in box
        r = box.get(1)
        assert r.payload.shape == (16, 16, 3)
    box.close()                    # idempotent on an in-memory box
    box.flush()

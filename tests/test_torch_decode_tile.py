"""The order of operations of ``decode_attention``'s kernel
(``csrc/decode_attention.cu``), modelled on the CPU.

The kernel runs only on the card.  Its order is repeated here in float32
PyTorch:

* the partition, from the length, the head dim, the dtype and rep alone:
  CTA r of a cluster of 8 (4 when rep is 1) takes rows [r span, (r + 1)
  span) below the length, span = ceil(len / cl) rounded up to 16; stage i
  of a CTA holds its rows [i tr, (i + 1) tr), consumer warp w of cw (4; 8
  for the CUDA-core p v of grouped heads with rows up to 512 bytes) takes
  rows [w wr, (w + 1) wr) of each stage (wr 16 when rep > 1 and a staged
  row is at most 256 bytes, else 8);
* each warp's online softmax over its blocks in order, in base 2: fp32
  scores of the inputs (bf16 widened exactly) times scale * log2(e), p =
  2^(s - m), m, l and the sums in fp32, the sums rescaled by 2^(m - m_new)
  before a block's p v;
* ``p v`` on the tensor cores (bf16, rep > 1, d % 16 == 0 up to 128: d
  112 and d 128 among the models): p split into three bf16 parts hi + lo
  + lo2, each rounded to nearest from what the earlier ones leave, the
  exact sum of p; hi and lo2 summed into one accumulator (lo2 first), lo
  into a second, the two added once at the end; elsewhere p v in fp32;
* the merge: the warps' parts inside the CTA, in warp order, then the
  cluster's CTA parts, each weighed by 2^(m - max m), a part with no rows
  0; the CTA parts' l summed pairwise (the kernel's butterfly), their
  sums in rank order; the output S (1 / l), 0 for a row with no key
  (ROADMAP C 2), and lse = m ln 2 + ln l (-inf there).

The tensor core's order inside one product, the order of each dot
product and ex2.approx's last bits are not modelled (fp32 matmuls and
``torch.exp2`` stand for them).  The model is held to the port's plain
version (fp32 o within 2e-5 of each row's max, lse within 1e-5) and to
the JAX package's Pallas kernel in interpret mode (rows with a key:
within 2e-5 in fp32, 1e-2 of the output's max in bf16, whose outputs are
rounded), at narrow head counts and S of a few hundred, the lengths on
the partition's edges: 0, 1, a span - 1, a span, a span + 1 and S.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import ref

torch.set_num_threads(2)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
        "kernels" / "csrc" / "decode_attention.cu")

CLUSTER = 8                  # CTAs a cluster...
REP1_CLUSTER = 4             # ...when rep is 1
HEADS = 8                    # q heads a pass
SPAN_ROUND = 16              # a CTA's span: whole boxes
BOX_ROWS = 16                # rows of a TMA box
TC_MAX = 128                 # widest head dim of the tensor-core p v
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def test_constants_are_the_kernels():
    """The model's constants are the ones the CUDA source declares."""
    text = CSRC.read_text()
    declared = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    for name in ("CLUSTER", "REP1_CLUSTER", "HEADS", "SPAN_ROUND",
                 "BOX_ROWS", "TC_MAX"):
        assert int(declared[name]) == globals()[name], name


def tc_pv(d, elt, rep):
    return elt == 2 and rep > 1 and d % 16 == 0 and d <= TC_MAX


def layout(d, elt, rep):
    """(cluster, consumer warps, warp rows, stage rows) from d, the element
    size and rep, as ``Layout`` and ``consumers`` give them."""
    ncb = -(-d * elt // 128)             # 128-byte boxes across a row
    wr = 16 if rep > 1 and ncb <= 2 else 8
    cw = 8 if rep > 1 and not tc_pv(d, elt, rep) and d * elt <= 512 else 4
    return (REP1_CLUSTER if rep == 1 else CLUSTER), cw, wr, cw * wr


def partition(length, d, elt, rep):
    """The kernel's blocks: [rank][warp] -> [(first row, rows)] in the
    order the warp takes them."""
    cl, cw, wr, tr = layout(d, elt, rep)
    span = -(-(-(-length // cl)) // SPAN_ROUND) * SPAN_ROUND
    ranks = []
    for r in range(cl):
        s0 = min(length, r * span)
        cnt = min(length, s0 + span) - s0
        warps = [[] for _ in range(cw)]
        for i in range(-(-cnt // tr)):
            for w in range(cw):
                first = i * tr + w * wr
                nv = min(wr, cnt - first)
                if nv > 0:
                    warps[w].append((s0 + first, nv))
        ranks.append(warps)
    return ranks


def split3(p):
    """fp32 p as three bf16 values (held in fp32), each rounded to nearest
    from what the earlier ones leave, as ``split3`` does."""
    parts, rest = [], p
    for _ in range(3):
        part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


def merge(parts, pairwise=False):
    """(m, l, sums) parts of a head set (m in base 2) merged in their
    order; ``pairwise``: l summed as the kernel's butterfly over the
    parts (a power of two of them) sums it."""
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    acc, ls = None, []
    for pm, pl, pacc in parts:
        f = torch.where(pm == -math.inf, torch.zeros_like(pm),
                        torch.exp2(pm - m))
        ls.append(pl * f)
        acc = pacc * f[:, None] if acc is None else acc + pacc * f[:, None]
    if pairwise:
        while len(ls) > 1:
            ls = [ls[i] + ls[i + 1] for i in range(0, len(ls), 2)]
        return m, ls[0], acc
    l = torch.zeros_like(m)
    for part in ls:
        l = l + part
    return m, l, acc


def warp_part(qh, k, v, blocks, scale2, split):
    """One consumer warp's online softmax over its blocks, in base 2: qh
    [H, d], k/v [S, d] fp32, scale2 = scale * log2(e) -> (m [H], l [H],
    sums [H, d]); ``split`` the parts of p that p v takes (None: p in
    fp32)."""
    h, d = qh.shape
    m = torch.full((h,), -math.inf)
    l = torch.zeros(h)
    acc = torch.zeros(h, d)
    acc_lo = torch.zeros(h, d)           # the lo parts' products (rows 8-15)
    for first, nv in blocks:
        s = (qh @ k[first:first + nv].T) * scale2
        m_new = torch.maximum(m, s.amax(1))
        p = torch.exp2(s - m_new[:, None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(1)
        acc = acc * corr[:, None]
        vb = v[first:first + nv]
        if split:
            hi, lo, lo2 = split(p)
            acc_lo = acc_lo * corr[:, None] + lo @ vb
            acc = acc + lo2 @ vb
            acc = acc + hi @ vb
        else:
            acc = acc + p @ vb
        m = m_new
    return m, l, acc + acc_lo


def tile_model(q, k_cache, v_cache, lengths, scale=None, split=split3):
    """The kernel's order on q [n, hq, d], caches [n, hkv, S, d] (fp32 or
    bf16) -> (o [n, hq, d] fp32 before the output's rounding, lse [n, hq]);
    ``split`` the parts of p on the tensor-core path."""
    n, hq, d = q.shape
    hkv = k_cache.shape[1]
    rep = hq // hkv
    elt = q.element_size()
    split = split if tc_pv(d, elt, rep) else None
    scale = d ** -0.5 if scale is None else scale
    scale2 = float(np.float32(scale) * LOG2E)
    o = torch.zeros(n, hq, d)
    lse = torch.full((n, hq), -math.inf)
    for b in range(n):
        ranks = partition(int(lengths[b]), d, elt, rep)
        for g in range(hkv):
            qh = q[b, g * rep:(g + 1) * rep].float()
            k, v = k_cache[b, g].float(), v_cache[b, g].float()
            ctas = [merge([warp_part(qh, k, v, blocks, scale2, split)
                           for blocks in warps]) for warps in ranks]
            m, l, acc = merge(ctas, pairwise=True)
            inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            o[b, g * rep:(g + 1) * rep] = acc * inv[:, None]
            lse[b, g * rep:(g + 1) * rep] = torch.where(
                l > 0, m * float(LN2) + torch.log(l),
                torch.full_like(l, -math.inf))
    return o, lse


@pytest.mark.parametrize("d,elt,rep", [(128, 2, 7), (112, 2, 8), (80, 2, 1),
                                       (64, 2, 1), (128, 4, 7), (64, 4, 1),
                                       (256, 4, 12), (40, 2, 2)])
def test_partition_takes_each_row_once(d, elt, rep):
    """Every row below the length in exactly one block, blocks in row
    order within a warp; the CTAs' spans whole boxes, so the boxes a CTA
    loads hold at most 15 rows past the length; a length's partition is
    the same whatever S or the batch (it is a function of the length, d,
    the dtype and rep alone)."""
    cl, cw, wr, tr = layout(d, elt, rep)
    for length in list(range(0, 300)) + [1023, 1024, 1025, 2049, 2080]:
        seen = np.zeros(length, int)
        loaded = 0
        for warps in partition(length, d, elt, rep):
            rows = 0
            for blocks in warps:
                firsts = [f for f, _ in blocks]
                assert firsts == sorted(firsts)
                for first, nv in blocks:
                    assert 0 < nv <= wr
                    seen[first:first + nv] += 1
                    rows += nv
            loaded += -(-rows // BOX_ROWS) * BOX_ROWS
        assert (seen == 1).all(), length
        assert loaded - length <= BOX_ROWS - 1, length


def test_split3_is_exact():
    """hi + lo + lo2 is p itself for every p the softmax gives (in (0, 1]),
    each part a bf16 value."""
    r = np.random.default_rng(0)
    p = torch.exp(-torch.from_numpy(
        r.exponential(4.0, 200_000).astype(np.float32)))
    p = torch.cat([p, torch.tensor([1.0, 2.0 ** -126, 1e-30, 0.0])])
    parts = split3(p)
    for part in parts:
        assert torch.equal(part, part.bfloat16().float())
    total = sum(part.double() for part in parts)
    assert torch.equal(total, p.double())


#: (name, n, hq, hkv, S, d, dtype, lengths): narrow heads of the models'
#: head shapes, lengths on the partition's edges (span 16 up to 128 rows
#: at a cluster of 8, 64 at 4)
CASES = [
    ("qwen2-7b", 6, 14, 2, 320, 128, torch.bfloat16,
     (0, 1, 127, 128, 129, 320)),
    ("kimi-k2", 6, 16, 2, 320, 112, torch.bfloat16,
     (320, 129, 128, 127, 1, 0)),
    ("zamba2-2.7b", 6, 4, 4, 320, 80, torch.bfloat16,
     (0, 1, 63, 64, 65, 320)),
    ("whisper", 3, 2, 2, 320, 64, torch.float32, (320, 65, 0)),
    ("qwen2-7b fp32", 6, 14, 2, 320, 128, torch.float32,
     (0, 1, 127, 128, 129, 320)),
    ("two passes", 3, 24, 2, 320, 64, torch.bfloat16, (129, 320, 7)),
]


def inputs(seed, n, hq, hkv, s, d, dtype):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((n, hq, d), (n, hkv, s, d),
                                     (n, hkv, s, d))]


@pytest.mark.parametrize("name,n,hq,hkv,s,d,dtype,lengths", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_model_against_plain_and_pallas(name, n, hq, hkv, s, d, dtype,
                                             lengths):
    q, kc, vc = inputs(11, n, hq, hkv, s, d, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    o, lse = tile_model(q, kc, vc, lens)
    want_o, want_lse = ref.decode_attention_partial_ref(q, kc, vc, lens)
    # the JAX kernel on the same values in the same dtype (bf16 rounds its
    # output)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(pallas_decode(
        *(jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, kc, vc)),
        jnp.asarray(lens.numpy()), interpret=True).astype(jnp.float32))
    out = o.to(dtype)
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert not o[i].abs().max() and torch.isneginf(lse[i]).all()
            continue
        big = float(want_o[i].abs().max())
        assert float((o[i] - want_o[i]).abs().max()) <= 2e-5 * big, i
        assert float((lse[i] - want_lse[i]).abs().max()) <= 1e-5 * max(
            1.0, float(want_lse[i].abs().max())), i
        if dtype == torch.float32:
            assert float(np.abs(o[i].numpy() - pallas[i]).max()) <= \
                2e-5 * big, i
        else:
            assert float(np.abs(out[i].float().numpy() - pallas[i])
                         .max()) <= 1e-2 * big, i
    rounded = ref.decode_attention_ref(q, kc, vc, lens)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert float((out.float() - rounded.float()).abs().max()) <= tol * float(
        want_o.abs().max())


@pytest.mark.parametrize("d", [112, 128])
def test_three_way_split_keeps_p_whole(d):
    """At bf16 d 112 and d 128 (rep 8): the model with p split in three
    against the same model with p v in fp32: both sum exact products, so
    they differ only in the sums' rounding (within 1e-6 of each row's
    max); rounding p to one bf16 part instead is far off (the split is
    what keeps p's 24 bits)."""
    n, hq, hkv, s = 2, 16, 2, 320
    q, kc, vc = inputs(12, n, hq, hkv, s, d, torch.bfloat16)
    lens = torch.tensor((320, 129), dtype=torch.int32)
    split, _ = tile_model(q, kc, vc, lens)
    whole, _ = tile_model(q, kc, vc, lens, split=lambda p: [
        p, torch.zeros_like(p), torch.zeros_like(p)])
    one_part, _ = tile_model(q, kc, vc, lens, split=lambda p: [
        p.bfloat16().float(), torch.zeros_like(p), torch.zeros_like(p)])
    big = float(whole.abs().max())
    assert float((split - whole).abs().max()) <= 1e-6 * big
    assert float((one_part - whole).abs().max()) > 1e-4 * big


def test_serving_lengths_each_sequence():
    """kimi-k2's head shape (8 q heads a kv head, d 112, bf16) at the
    serving run's lengths in a cache of 2112 slots: each sequence within
    2e-5 of its own largest output of the plain version's fp32 row."""
    n, hq, hkv, s, d = 4, 8, 1, 2112, 112
    q, kc, vc = inputs(13, n, hq, hkv, s, d, torch.bfloat16)
    lens = torch.tensor((2049, 2080, 1500, 7), dtype=torch.int32)
    o, _ = tile_model(q, kc, vc, lens)
    want, _ = ref.decode_attention_partial_ref(q, kc, vc, lens)
    for i in range(n):
        assert float((o[i] - want[i]).abs().max()) <= 2e-5 * float(
            want[i].abs().max()), i

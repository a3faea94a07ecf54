"""The arithmetic of the warpgroup conv tile (``csrc/wg_conv_tile.cuh``)
that ``gn_silu_conv3x3`` and ``upsample_conv3x3`` run on, modelled on the
CPU, its weight slots' layout, and the decoder's upsampler taps collapsed
once.

The kernel is an implicit GEMM in 3xTF32 on ``wgmma`` m64n128k8: K is
walked as (16-channel chunk, tap), one step each.  A chunk's chain is its
steps' products in tap order, each step's two 8-deep slices' lo*hi,
hi*lo, hi*hi, the first slice then the second, summed in one fresh
accumulator, which is then added to the fp32 sum with round-to-nearest.  Operands are rounded as
``cvt.rna.tf32.f32`` rounds.  A slice wholly past Cin adds exact zeros
(zero halo and weights), so summing it or not gives the same bits; a
weight that TF32 holds exactly (bf16, or an integer code of at most 11
bits) takes two products, a_lo b and a_hi b.  These tests repeat that in
PyTorch at the decoder's widths (the fused GN conv at Cin = Cout = 512,
the ragged Cin = 520 -> 264, the upsampler's phase form at 512 -> 512)
against float64 and the JAX package's plain versions.  The tensor core's
own accumulation inside a chain is modelled by fp32 adds: the card's
tests hold the kernel to the plain versions.  The slot layout (K-major
no-swizzle core matrices) is read from the header and walked as a
``wgmma`` descriptor reads it.  Inputs come from seeded numpy.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops, ref
from repro_torch.kernels import upsample_conv
from repro_torch.vae import layers as L
from repro_torch.vae import model as M
from repro_torch.vae import quantize as Q
from test_torch_tc_conv import conv_taps, max_abs
from test_torch_tc_numerics import arrs, split, tf32

torch.set_num_threads(2)

CHUNK, SLICE = 16, 8
HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "wg_conv_tile.cuh")


def header_constants():
    """The ``constexpr int`` constants of namespace scope in the header,
    evaluated in order (C's integer division)."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 HEADER.read_text(), re.M):
        out[name] = eval(expr.replace("/", "//"), {}, dict(out))
    return out


HC = header_constants()


def wg_tile_sum(a_taps, b_taps, cin, exact_b=False, skip_past_cin=False):
    """The kernel's sum of one output tile: a_taps [T, P, Cin] (each tap's
    shifted input), b_taps [T, Cin, Cout] -> [P, Cout] fp32, in the
    kernel's order: per chunk one chain over its taps and slices in a
    fresh accumulator, then a round-to-nearest add.  The kernel sums the
    zero slices past Cin; ``skip_past_cin`` leaves them out."""
    chunks = -(-cin // CHUNK)
    pad = chunks * CHUNK - cin
    a = torch.nn.functional.pad(a_taps, (0, pad))
    b = torch.nn.functional.pad(b_taps, (0, 0, 0, pad))
    ah, al = split(a)
    bh, bl = (b, None) if exact_b else split(b)
    acc = torch.zeros((a.shape[1], b.shape[2]), dtype=torch.float32)
    for ch in range(chunks):
        d = None
        for t in range(a.shape[0]):
            for q in range(CHUNK // SLICE):
                k0 = ch * CHUNK + q * SLICE
                if skip_past_cin and k0 >= cin:
                    continue                    # a slice wholly past Cin
                s = slice(k0, k0 + SLICE)
                terms = [al[t][:, s] @ bh[t][s]]
                if not exact_b:
                    terms.append(ah[t][:, s] @ bl[t][s])
                terms.append(ah[t][:, s] @ bh[t][s])
                for term in terms:
                    d = term if d is None else d + term
        acc = acc + d
    return acc


def wg_conv3x3(x, w, b=None, **kw):
    """conv3x3 of x [N, H, W, Cin] as the tile sums it, image by image."""
    n, h, wd, cin = x.shape
    out = torch.stack([wg_tile_sum(conv_taps(x[i]), w.reshape(9, cin, -1),
                                   cin, **kw) for i in range(n)])
    out = out.reshape(n, h, wd, -1)
    return out if b is None else out + b


def wg_upsample(x, wc, b=None, **kw):
    """upsample_conv3x3 of x [N, H, W, Cin] from collapsed taps wc [2, 2,
    2, 2, Cin, Cout], each phase as the tile sums it."""
    n, h, wd, cin = x.shape
    out = torch.empty((n, 2 * h, 2 * wd, wc.shape[-1]))
    for i in range(n):
        xp = torch.nn.functional.pad(x[i], (0, 0, 1, 1, 1, 1))
        for pi in (0, 1):
            for pj in (0, 1):
                a = torch.stack([
                    xp[pi + ta:pi + ta + h, pj + tb:pj + tb + wd]
                    .reshape(h * wd, cin) for ta in (0, 1) for tb in (0, 1)])
                y = wg_tile_sum(a, wc[pi, pj].reshape(4, cin, -1), cin, **kw)
                out[i, pi::2, pj::2] = y.reshape(h, wd, -1)
    return out if b is None else out + b


def gn_case(seed, shape, cin, cout, groups):
    """Seeded (x, scale, bias, w, b) of a fused GN conv, numpy fp32."""
    x, s, gb, w, b = arrs(seed, shape + (cin,), (cin,), (cin,),
                          (3, 3, cin, cout), (cout,))
    return x, s, gb, w * (9 * cin) ** -0.5, b


@pytest.mark.parametrize("cin,cout,groups,hw", [(512, 512, 32, (8, 8)),
                                                (520, 264, 8, (5, 7))])
def test_gn_conv_order_holds_fp32_tolerance(cin, cout, groups, hw):
    """The fused GN conv at the SD3.5 width and at the card tests' ragged
    Cin = 520 (a last chunk of 8 channels and 8 zeros) and
    Cout = 264: the tile's order in 3xTF32 within 1e-4 of float64 and of
    the JAX package's ``gn_silu_conv3x3_ref``; one TF32 pass is not."""
    x, s, gb, w, b = gn_case(50, (1,) + hw, cin, cout, groups)
    act = ref.group_norm_silu_ref(torch.from_numpy(x), torch.from_numpy(s),
                                  torch.from_numpy(gb), groups, 1e-6)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    got = wg_conv3x3(act, wt, bt)
    f64 = ref.conv3x3_ref(act.double(), wt.double(), bt.double())
    want = np.asarray(jref.gn_silu_conv3x3_ref(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(gb), jnp.asarray(w),
        jnp.asarray(b), groups))
    assert got.shape == (1,) + hw + (cout,)
    assert max_abs(got, f64) <= 1e-4
    assert max_abs(got, want) <= 1e-4
    one = ref.conv3x3_ref(tf32(act), tf32(wt), bt)
    assert max_abs(one, f64) > 1e-4


def test_phase_form_order_holds_fp32_tolerance():
    """The upsampler's phase form at 512 -> 512 (the decoder's first two
    upsamplers) on a 5 x 6 patch: within 1e-4 of the JAX package's
    ``upsample_conv3x3_ref`` and of float64."""
    x, w, b = arrs(51, (1, 5, 6, 512), (3, 3, 512, 512), (512,))
    w *= (9 * 512) ** -0.5
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, b))
    got = wg_upsample(xt, ref.phase_weights(wt), bt)
    want = np.asarray(jref.upsample_conv3x3_ref(jnp.asarray(x),
                                                jnp.asarray(w),
                                                jnp.asarray(b)))
    f64 = ref.upsample_conv3x3_ref(xt.double(), wt.double(), bt.double())
    assert got.shape == (1, 10, 12, 512)
    assert max_abs(got, want) <= 1e-4
    assert max_abs(got, f64) <= 1e-4


@pytest.mark.parametrize("form", ["conv_bfloat16", "conv_int8",
                                  "phase_bfloat16", "phase_int16"])
def test_exact_weights_two_products_give_three_products_bits(form):
    """bf16 weights and int8 codes (and the upsampler's bf16 and int16
    taps) are exact in TF32: lo is 0, so under the tile's chain the two
    products a_lo b, a_hi b give the bits of the three, at Cin = 40 (a
    last chunk of 8 channels)."""
    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 40))
                         .astype(np.float32))
    if form.endswith("bfloat16"):
        w = torch.from_numpy(rng.standard_normal((3, 3, 40, 24))
                             .astype(np.float32) * 0.05).bfloat16()
    else:
        w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 40, 24))
                             .astype(np.int8))
    if form.startswith("phase"):
        wf = ref.storage_phase_weights(w).float()
        run = wg_upsample
    else:
        wf = w.float()
        run = wg_conv3x3
    hi, lo = split(wf)
    assert torch.equal(hi, wf) and not lo.any()
    assert torch.equal(run(x, wf, exact_b=True), run(x, wf))


@pytest.mark.parametrize("cin", [3, 24, 40])
def test_zero_slices_past_cin_change_no_bit(cin):
    """Cin not a multiple of 16: the kernel's products of the zero
    channels past Cin give the bits of leaving them out, within 1e-5 of
    the JAX package's ``conv3x3_ref``."""
    x, w, b = arrs(54, (1, 5, 7, cin), (3, 3, cin, 24), (24,))
    w *= (9 * cin) ** -0.5
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, b))
    summed = wg_conv3x3(xt, wt, bt)
    assert torch.equal(wg_conv3x3(xt, wt, bt, skip_past_cin=True), summed)
    want = np.asarray(jref.conv3x3_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    assert max_abs(summed, want) <= 1e-5


def test_batch_gives_each_image_its_own_bits():
    """Every sum's order is set by the shape: the model of a batch of
    three equals three models of one."""
    x, w = arrs(53, (3, 4, 6, 24), (3, 3, 24, 16))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w * 0.05)
    batch = wg_conv3x3(xt, wt)
    for i in range(3):
        assert torch.equal(wg_conv3x3(xt[i:i + 1], wt), batch[i:i + 1])


# ---------------------------------------------------------------------------
# the weight slots: K-major core matrices, as the descriptor reads them
# ---------------------------------------------------------------------------

def slot_off(n, k):
    """``wg_conv_tile.cuh``'s ``slot_off``: byte offset of weight (n, k)."""
    return ((n >> 3) * HC["SBO"] + (k >> 2) * 128 + (n & 7) * 16
            + (k & 3) * 4)


def desc_read(plane_words, k0, lbo, sbo, n_cols):
    """B [8 x n_cols] of the k8 slice at k0, read as a no-swizzle K-major
    ``wgmma`` descriptor reads it: core matrix (kc along K, nc along N)
    at start + kc * lbo + nc * sbo, its row r (n) 16 bytes at + 16 r, 4 k
    values of 4 bytes."""
    start = slot_off(0, k0)
    out = np.zeros((8, n_cols), np.int64)
    for nc in range(n_cols // 8):
        for kc in range(2):
            for r in range(8):
                for c in range(4):
                    byte = start + kc * lbo + nc * sbo + 16 * r + 4 * c
                    out[4 * kc + c, 8 * nc + r] = plane_words[byte // 4]
    return out


def test_slot_layout_reads_back_as_the_hwio_slice():
    """Every (n, k) of a slot plane has its own 4-byte word inside the
    plane, and each k8 slice read through the kernel's descriptor
    (leading offset 128, stride offset SBO) is the weights' [k, n]
    slice: the K-major restaging of HWIO rows."""
    bn, bk = HC["BN"], HC["BK"]
    assert HC["BPLANE"] == bn // 8 * HC["SBO"]
    offs = {slot_off(n, k) for n in range(bn) for k in range(bk)}
    assert len(offs) == bn * bk
    assert max(offs) + 4 <= HC["BPLANE"] and min(offs) == 0
    w = np.arange(bk * bn, dtype=np.int64).reshape(bk, bn)  # [k, n]
    plane = np.full(HC["BPLANE"] // 4, -1, np.int64)
    for k in range(bk):
        for n in range(bn):
            plane[slot_off(n, k) // 4] = w[k, n]
    for k0 in (0, 8):
        assert np.array_equal(desc_read(plane, k0, 128, HC["SBO"], bn),
                              w[k0:k0 + 8])


def test_weight_warp_stores_hit_distinct_bank_groups():
    """The weight warp's 16-byte stores: lane l writes output channel
    4 l + j at one k block; in each quarter warp the eight lanes' 16-byte
    units fall in 8 distinct bank groups (no conflict), for every j and
    k block.  Without the 16 bytes of padding in SBO they would not."""
    def groups(sbo, j, kb):
        out = []
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            units = [(((4 * l + j) >> 3) * sbo + kb * 128
                      + ((4 * l + j) & 7) * 16) // 16 % 8 for l in lanes]
            out.append(len(set(units)))
        return out
    for j in range(4):
        for kb in range(HC["BK"] // 4):
            assert groups(HC["SBO"], j, kb) == [8] * 4
    assert groups(4 * 128, 0, 0) != [8] * 4


@pytest.mark.parametrize("rows,size,want", [(2, 4, 227456), (2, 2, 181376),
                                            (2, 1, 175232)])
def test_shared_memory_fits_one_block_an_sm(rows, size, want):
    """A block's shared memory (the header's ``Smem``) for ``size``-byte
    weights, from the header's constants: the barriers, three split halo
    buffers (hi and lo) of the block's ``rows`` + 2 halo rows, four weight
    slots (hi and lo for fp32), two raw halo buffers, three raw weight
    stages; one block an SM of 227 KB."""
    assert rows == HC["NC"]
    plane = HC["BK"] // 4 * (rows + 2) * HC["HWD"] * 16
    slot = (2 if size == 4 else 1) * HC["BPLANE"]
    got = (128 + HC["HALO_BUFS"] * 2 * plane + HC["STAGES"] * slot
           + HC["RAW_HALOS"] * plane + HC["RAW"] * HC["BK"] * HC["BN"] * size)
    assert got == want <= at.MAX_SMEM
    assert 128 * (rows + 2) <= at.MAX_THREADS
    assert (HC["STAGES"], HC["RAW"], HC["HALO_BUFS"], HC["RAW_HALOS"],
            HC["BN"], HC["BK"]) == (4, 3, 3, 2, 128, 16)


# ---------------------------------------------------------------------------
# the decoder's upsampler taps, collapsed once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8"])
def test_serving_tree_holds_the_per_call_collapse(weight_dtype):
    """Each upsampler of a serving tree holds ``storage_phase_weights`` of
    its stored filter bit for bit (int8 codes in int16 with the filter's
    scale) in place of the filter, so the tree holds one copy of its
    weights; the rest of the tree is shared with the quantized decoder,
    and deriving the serving form again keeps the taps."""
    vae = M.VAE(M.DEMO_VAE, seed=0, device="cpu", with_encoder=False,
                weight_dtype=weight_dtype)
    tree = vae._params_for(None)
    stored = Q.quantize_decoder(vae.decoder, weight_dtype)
    ups = [(lv["upsample"]["conv"], st["upsample"]["conv"])
           for lv, st in zip(tree["up"], stored["up"]) if "upsample" in lv]
    assert len(ups) == len(M.DEMO_VAE.block_out_channels) - 1
    grown = 0
    for conv, st in ups:
        assert set(conv) == {"taps", "b"}
        wq, s = ops.weight_parts(st["w"])
        tq, ts = ops.weight_parts(conv["taps"])
        assert tq.dtype == (torch.int16 if weight_dtype == "int8"
                            else wq.dtype)
        assert torch.equal(tq, ref.storage_phase_weights(wq))
        assert (ts is None) == (s is None)
        assert s is None or torch.equal(ts, s)
        grown += conv["taps"].nbytes - st["w"].nbytes
    assert Q.decoder_storage(tree)["bytes"] == \
        Q.decoder_storage(stored)["bytes"] + grown
    assert tree["mid"] is vae._params_for(None)["mid"]
    assert "taps" not in str(vae.decoder)
    again = M.with_phase_taps(tree)
    assert all(a["upsample"]["conv"]["taps"] is t["upsample"]["conv"]["taps"]
               for a, t in zip(again["up"], tree["up"]) if "upsample" in t)


def upsample_per_call(x, p):
    """The upsampler that collapses its 3x3 filter's taps on every call
    (``ops.upsample_conv3x3``, which on the card collapses and launches
    from the taps)."""
    return ops.upsample_conv3x3(x, p["conv"]["w"], p["conv"]["b"])


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8"])
def test_precollapsed_decode_is_bit_identical_to_the_per_call_collapse(
        weight_dtype, monkeypatch):
    """``decode_u8`` from the precollapsed serving tree equals, bit for
    bit, the decode that collapses each upsampler's taps on every call
    and launches from them, on the plain path; and it never takes the
    per-call route."""
    vae = M.VAE(M.DEMO_VAE, seed=0, device="cpu", with_encoder=False,
                weight_dtype=weight_dtype)
    M.calibrate_output_range(vae)
    z = Q.probe_latents((8, 8, 4), 2, seed=5)
    per_call_tree = Q.quantize_decoder(vae.decoder, weight_dtype)
    calls = []

    def per_call(x, w, b=None):
        calls.append(w)
        wq, s = ops.weight_parts(w)
        return upsample_conv.upsample_conv3x3_taps(
            x, ref.storage_phase_weights(wq), b, w_scale=s)

    monkeypatch.setattr(ops, "upsample_conv3x3", per_call)
    with monkeypatch.context() as mp:
        mp.setattr(L, "upsample", upsample_per_call)
        want = M.decode_u8(per_call_tree, torch.from_numpy(z), vae.cfg)
        assert len(calls) == len(M.DEMO_VAE.block_out_channels) - 1
        # the fp32 oracle and the float decode
        want32 = M.decode(Q.quantize_decoder(vae.decoder, "float32"),
                          torch.from_numpy(z), vae.cfg)
    calls.clear()
    got = vae.decode_u8(z)
    assert calls == []
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    # ... come from the fp32 serving tree
    assert torch.equal(vae.decode(z), want32) and calls == []


def test_decode_step_takes_the_serving_form_or_the_decoder():
    """``make_decode_step`` gives the same bits from ``VAE.decoder`` (its
    taps collapsed in the step) as from the serving form derived once, and
    the VAE's own float decode."""
    from repro_torch.vae.serve import make_decode_step
    vae = M.VAE(M.DEMO_VAE, seed=0, device="cpu", with_encoder=False)
    z = torch.from_numpy(Q.probe_latents((8, 8, 4), 2, seed=6))
    step = make_decode_step(M.DEMO_VAE, device="cpu")
    raw = step(vae.decoder, z)
    assert torch.equal(step(M.with_phase_taps(vae.decoder), z), raw)
    assert torch.equal(vae.decode(z), raw)

"""The arithmetic of the tensor-core conv tile (``csrc/tc_conv_tile.cuh``)
that ``conv3x3`` and ``upsample_conv3x3`` run on, modelled on the CPU.

The kernel is an implicit GEMM in 3xTF32: K is walked as (16-channel
chunk, tap, 8-deep slice); each slice's products are summed in a fresh
fragment, lo*hi + hi*lo + hi*hi, which is then added to the fp32 sum.  A
weight that TF32 holds exactly (bf16, or an integer code of at most 11
bits) has a zero lo half, and its slice takes two products.  A slice that
lies wholly past Cin is skipped.  Where the 32-wide Cout tile splits K
over a cluster of ``ks`` blocks, block r sums a consecutive share of the
chunks and the shares are added in rank order.  These tests repeat that
in PyTorch (operands rounded as ``cvt.rna.tf32.f32`` rounds, sums in
fp32): the upsampler's phase form at the decoder's widths, the encoder's
``conv_out`` (512 -> 32) with its split, exact taps, Cin = 3's padding and
the split's choice.  Inputs come from seeded numpy; the references are the
JAX package's plain versions and float64.
"""

import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import conv3x3 as tconv
from repro_torch.kernels import ref
from repro_torch.vae.model import SD35_VAE
from test_torch_tc_numerics import arrs, split, tf32

torch.set_num_threads(2)

CHUNK, SLICE = 16, 8


def tile_sum(a_taps, b_taps, cin, ks=1, exact_b=False, skip_past_cin=True):
    """The kernel's sum of one output tile: a_taps [T, P, Cin] (each tap's
    shifted input), b_taps [T, Cin, Cout] -> [P, Cout] fp32.  ``ks`` ranks
    split the chunks as ``tc_conv_kernel`` does; ``exact_b`` takes the two
    products of a weight exact in TF32."""
    chunks = -(-cin // CHUNK)
    pad = chunks * CHUNK - cin
    a = torch.nn.functional.pad(a_taps, (0, pad))
    b = torch.nn.functional.pad(b_taps, (0, 0, 0, pad))
    ah, al = split(a)
    if exact_b:
        bh, bl = b, torch.zeros_like(b)
    else:
        bh, bl = split(b)
    parts = []
    for r in range(ks):
        acc = torch.zeros((a.shape[1], b.shape[2]), dtype=torch.float32)
        for ch in range(r * chunks // ks, (r + 1) * chunks // ks):
            for t in range(a.shape[0]):
                for kk in range(0, CHUNK, SLICE):
                    k0 = ch * CHUNK + kk
                    if skip_past_cin and k0 >= cin:
                        continue
                    s = slice(k0, k0 + SLICE)
                    d = al[t][:, s] @ bh[t][s]
                    if not exact_b:
                        d = d + ah[t][:, s] @ bl[t][s]
                    acc = acc + (d + ah[t][:, s] @ bh[t][s])
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def conv_taps(x):
    """x [H, W, Cin] -> the 3x3 conv's nine shifted inputs [9, H*W, Cin]."""
    h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[ry:ry + h, cx:cx + w].reshape(h * w, c)
                        for ry in range(3) for cx in range(3)])


def tc_conv3x3(x, w, b=None, **kw):
    """conv3x3 of x [N, H, W, Cin] as the kernel sums it, image by image."""
    n, h, wd, cin = x.shape
    out = torch.stack([tile_sum(conv_taps(x[i]), w.reshape(9, cin, -1), cin,
                                **kw) for i in range(n)])
    out = out.reshape(n, h, wd, -1)
    return out if b is None else out + b


def tc_upsample(x, wc, b=None, **kw):
    """upsample_conv3x3 of x [N, H, W, Cin] from collapsed taps wc [2, 2, 2,
    2, Cin, Cout], each phase as the kernel sums it."""
    n, h, wd, cin = x.shape
    out = torch.empty((n, 2 * h, 2 * wd, wc.shape[-1]))
    for i in range(n):
        xp = torch.nn.functional.pad(x[i], (0, 0, 1, 1, 1, 1))
        for pi in (0, 1):
            for pj in (0, 1):
                a = torch.stack([
                    xp[pi + ta:pi + ta + h, pj + tb:pj + tb + wd]
                    .reshape(h * wd, cin) for ta in (0, 1) for tb in (0, 1)])
                y = tile_sum(a, wc[pi, pj].reshape(4, cin, -1), cin, **kw)
                out[i, pi::2, pj::2] = y.reshape(h, wd, -1)
    return out if b is None else out + b


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max())


@pytest.mark.parametrize("cin,cout", [(512, 512), (256, 256)])
def test_phase_form_3xtf32_holds_fp32_tolerance(cin, cout):
    """(a) the decoder's upsamplers at full channel width on a 5 x 6 patch:
    the phase form in 3xTF32 within 1e-4 of the JAX package's
    ``upsample_conv3x3`` and of float64; one TF32 pass is not."""
    x, w, b = arrs(40, (1, 5, 6, cin), (3, 3, cin, cout), (cout,))
    w *= (9 * cin) ** -0.5
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, b))
    got = tc_upsample(xt, ref.phase_weights(wt), bt)
    want = np.asarray(jref.upsample_conv3x3_ref(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(b)))
    f64 = ref.upsample_conv3x3_ref(xt.double(), wt.double(), bt.double())
    assert got.shape == (1, 10, 12, cout)
    assert max_abs(got, want) <= 1e-4
    assert max_abs(got, f64) <= 1e-4
    one = ref.upsample_conv3x3_phase_ref(tf32(xt), tf32(ref.phase_weights(wt)),
                                         bt)
    assert max_abs(one, f64) > 1e-4


def test_phase_form_matches_its_plain_version_from_taps():
    """The launch from collapsed taps and its plain version
    (``ref.upsample_conv3x3_phase_ref``) compute the upsampler: fp32 taps
    against the upsampled conv, int16 taps with their scale against the
    int8 filter's."""
    x, w = arrs(41, (2, 4, 5, 24), (3, 3, 24, 40))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w * 0.1)
    b = torch.linspace(-1, 1, 40)
    plain = ref.upsample_conv3x3_phase_ref(xt, ref.storage_phase_weights(wt), b)
    assert max_abs(plain, ref.upsample_conv3x3_ref(xt, wt, b)) <= 1e-5
    assert max_abs(tc_upsample(xt, ref.phase_weights(wt), b), plain) <= 1e-5
    q = torch.from_numpy(np.random.default_rng(41).integers(
        -127, 128, (3, 3, 24, 40)).astype(np.int8))
    scale = torch.linspace(0.001, 0.01, 40)
    wc16 = ref.storage_phase_weights(q)
    assert wc16.dtype == torch.int16
    got = ref.upsample_conv3x3_phase_ref(xt, wc16, b, scale)
    assert max_abs(got, ref.upsample_conv3x3_ref(xt, q, b, scale)) <= 1e-5


@pytest.mark.parametrize("ks", [1, 2, 4, 8])
def test_conv_out_split_k_holds_fp32_tolerance(ks):
    """(b) the encoder's conv_out, 512 -> 32, on an 8 x 8 patch: 3xTF32
    with K split over ks cluster ranks and merged in rank order, within
    1e-4 of the JAX package's ``conv3x3`` and of float64."""
    x, w, b = arrs(42, (1, 8, 8, 512), (3, 3, 512, 32), (32,))
    w *= (9 * 512) ** -0.5
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, b))
    got = tc_conv3x3(xt, wt, bt, ks=ks)
    want = np.asarray(jref.conv3x3_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    f64 = ref.conv3x3_ref(xt.double(), wt.double(), bt.double())
    assert max_abs(got, want) <= 1e-4
    assert max_abs(got, f64) <= 1e-4
    assert torch.equal(tc_conv3x3(xt, wt, bt, ks=ks), got)


def test_conv_out_split_is_the_wrappers():
    """The split the wrapper passes at the VAE's conv_out shape is one of
    those (b) holds: 8 ranks of 4 chunks each."""
    top, z = SD35_VAE.block_out_channels[-1], 2 * SD35_VAE.latent_channels
    assert tconv.k_split(64, 64, top, z) == 8


@pytest.mark.parametrize("kind", ["bfloat16", "int16"])
def test_exact_taps_two_products_give_three_products_bits(kind):
    """(c) bf16 taps collapsed in bf16 and int8 codes collapsed in int16
    are exact in TF32 (lo half exactly 0, |int16 tap| <= 508), so two TF32
    products per product give the bits of three."""
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 64)).astype(np.float32))
    if kind == "bfloat16":
        w = torch.from_numpy(rng.standard_normal((3, 3, 64, 48))
                             .astype(np.float32) * 0.05).bfloat16()
        wc = ref.phase_weights(w)
    else:
        w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 48))
                             .astype(np.int8))
        wc = ref.storage_phase_weights(w)
        assert int(wc.abs().max()) <= 4 * 127
    wf = wc.float()
    hi, lo = split(wf)
    assert torch.equal(hi, wf)
    assert not lo.any()
    three = tc_upsample(x, wf)
    two = tc_upsample(x, wf, exact_b=True)
    assert torch.equal(two, three)


@pytest.mark.parametrize("cin", [3, 24])
def test_zero_padding_past_cin_changes_no_sum(cin):
    """(d) the encoder's conv_in (Cin = 3, zero-padded to the 16-channel
    chunk) and a Cin of 24: summing the zero slices past Cin or skipping
    them gives the same bits, within 1e-5 of the JAX package."""
    x, w, b = arrs(44, (2, 6, 7, cin), (3, 3, cin, 128), (128,))
    w *= (9 * cin) ** -0.5
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, b))
    skipped = tc_conv3x3(xt, wt, bt)
    padded = tc_conv3x3(xt, wt, bt, skip_past_cin=False)
    assert torch.equal(skipped, padded)
    want = np.asarray(jref.conv3x3_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    assert max_abs(skipped, want) <= 1e-5


def test_k_split_depends_on_the_shape_alone():
    """(e) the split is a function of (H, W, Cin, Cout): no batch argument,
    so a batch's images sum in the order each takes alone."""
    assert list(inspect.signature(tconv.k_split).parameters) == [
        "h", "w", "cin", "cout"]


@pytest.mark.parametrize("h,w,cin,cout,want", [
    (64, 64, 512, 32, 8),       # encoder conv_out
    (64, 64, 16, 512, 1),       # decoder conv_in: the 128-wide tile
    (512, 512, 3, 128, 1),      # encoder conv_in
    (512, 512, 128, 3, 1),      # float decode conv_out: CUDA cores
    (128, 128, 512, 32, 2),     # 128 tiles: one more block per tile
    (256, 256, 512, 32, 1),     # 512 tiles fill the card unsplit
    (5, 33, 512, 32, 8), (7, 70, 24, 32, 2), (9, 45, 3, 32, 1),
    (16, 16, 40, 8, 2)])
def test_k_split_choices(h, w, cin, cout, want):
    """The split at the VAE's shapes and the card tests' ragged ones: a
    power of two up to 8, at most one rank per chunk, and at most 256
    blocks per image where it splits."""
    ks = tconv.k_split(h, w, cin, cout)
    assert ks == want
    tiles = -(-h // tconv.TILE_H) * -(-w // tconv.TILE_W)
    assert ks & (ks - 1) == 0 and 1 <= ks <= tconv.MAX_SPLIT
    assert ks <= -(-cin // CHUNK)
    assert ks == 1 or tiles * ks <= tconv.SPLIT_BLOCKS


def test_split_batch_gives_each_image_its_own_bits():
    """Each image of a batch goes through the split as it would alone: the
    model of a batch of three equals three models of one."""
    x, w = arrs(45, (3, 4, 6, 64), (3, 3, 64, 16))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w * 0.05)
    ks = tconv.k_split(4, 6, 64, 16)
    assert ks == 4
    batch = tc_conv3x3(xt, wt, ks=ks)
    for i in range(3):
        assert torch.equal(tc_conv3x3(xt[i:i + 1], wt, ks=ks), batch[i:i + 1])

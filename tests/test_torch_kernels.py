"""The port's kernel layer on the CPU against the JAX package's Pallas
kernels run in interpret mode (as ``tests/test_kernels.py`` runs them).

On a CPU tensor every wrapper of ``repro_torch.kernels.ops`` runs its
plain PyTorch version, so these tests hold the plain versions — which
``chip_smoke.py`` holds the Hopper kernels against on the card — to the
JAX kernels.  Tolerances: 2e-5 for fp32 (1e-4 for the fused GN+conv, as
``tests/test_kernels.py``), +-1 LSB for uint8.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.conv3x3 import conv3x3 as jconv3x3
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.gn_silu import group_norm_silu as jgn_silu
from repro.kernels.gn_silu_conv import gn_silu_conv3x3 as jgn_conv
from repro.kernels.output_epilogue import output_epilogue as jepilogue
from repro.kernels.upsample_conv import phase_weights as jphase_weights
from repro.kernels.upsample_conv import upsample_conv3x3 as jupsample
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)


def arrs(seed, *shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(port, want, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=atol,
                               rtol=atol)


# the ragged and odd-H cases of tests/test_kernels.py:47-50
CONV_SHAPES = [(1, 8, 8, 16, 32, 4), (2, 16, 12, 8, 8, 2),
               (1, 5, 7, 4, 4, 2), (3, 4, 4, 32, 16, 8), (1, 9, 6, 8, 3, 2)]


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_conv3x3(n, h, w, cin, cout, groups):
    x, wt, b = arrs(1, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= 0.1
    want = jconv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), rows=8,
                    interpret=True)
    close(ops.conv3x3(t(x), t(wt), t(b)), want, 2e-5)


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_gn_silu_conv3x3(n, h, w, cin, cout, groups):
    x, s, gb, wt, b = arrs(2, (n, h, w, cin), (cin,), (cin,),
                           (3, 3, cin, cout), (cout,))
    wt *= 0.1
    want = jgn_conv(*map(jnp.asarray, (x, s, gb, wt, b)), groups=groups,
                    rows=8, interpret=True)
    close(ops.gn_silu_conv3x3(t(x), t(s), t(gb), t(wt), t(b), groups=groups),
          want, 1e-4)


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_output_epilogue_within_one_lsb(n, h, w, cin, cout, groups):
    x, s, gb, wt, b = arrs(3, (n, h, w, cin), (cin,), (cin,),
                           (3, 3, cin, cout), (cout,))
    wt *= 0.1
    want = np.asarray(jepilogue(*map(jnp.asarray, (x, s, gb, wt, b)),
                                groups=groups, rows=8, interpret=True))
    got = ops.output_epilogue(t(x), t(s), t(gb), t(wt), t(b),
                              groups=groups).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert 0 < got.mean() < 255                  # not all clamped


# C = 16 / g = 4, C = 512 / g = 32 (the encoder's norm_out width), and
# 20 x 30 = 600 pixels, which the reference's 512-pixel tile does not
# divide (it falls back to 8-pixel tiles)
@pytest.mark.parametrize("n,h,w,c,groups", [
    (2, 6, 5, 16, 4), (2, 8, 8, 512, 32), (1, 20, 30, 16, 4)])
def test_group_norm_silu(n, h, w, c, groups):
    x, s, gb = arrs(12, (n, h, w, c), (c,), (c,))
    want = jgn_silu(*map(jnp.asarray, (x, s, gb)), groups=groups,
                    interpret=True)
    close(ops.group_norm_silu(t(x), t(s), t(gb), groups=groups), want, 2e-5)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 4, 4, 8, 8), (2, 5, 3, 4, 16), (1, 8, 6, 16, 8)])
def test_upsample_conv3x3(n, h, w, cin, cout):
    x, wt, b = arrs(4, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= 0.1
    want = jupsample(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                     rows=4, interpret=True)
    got = ops.upsample_conv3x3(t(x), t(wt), t(b))
    assert tuple(got.shape) == (n, 2 * h, 2 * w, cout)
    close(got, want, 2e-5)


def test_phase_weights_match_reference():
    (wt,) = arrs(5, (3, 3, 6, 5))
    close(ref.phase_weights(t(wt)), jphase_weights(jnp.asarray(wt)), 1e-6)


@pytest.mark.parametrize("n,h,sq,skv,d", [
    (1, 1, 64, 64, 32), (2, 1, 96, 80, 16), (1, 2, 40, 130, 8)])
def test_flash_attention_non_causal(n, h, sq, skv, d):
    q, k, v = arrs(6, (n, h, sq, d), (n, h, skv, d), (n, h, skv, d))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, block_q=32, block_kv=32, interpret=True)
    close(ops.flash_attention(t(q), t(k), t(v)), want, 2e-5)


# causal; window with GQA rep 2; GQA rep 2 over a batch of 2; rep 7; sq <
# skv (q aligned at the sequence end); ragged tiles with a non-causal
# window; rep 7 with a window over an odd length
LM_ATTENTION = [(1, 2, 2, 64, 64, 16, True, None),
                (1, 2, 1, 48, 48, 8, True, 16),
                (2, 4, 2, 40, 40, 8, True, None),
                (1, 7, 1, 24, 24, 8, True, None),
                (1, 2, 1, 16, 40, 8, True, None),
                (1, 2, 2, 20, 36, 8, False, 12),
                (1, 14, 2, 33, 33, 16, True, 8)]


@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", LM_ATTENTION)
def test_flash_attention_lm_cases(n, hq, hkv, sq, skv, d, causal, window):
    q, k, v = arrs(7, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=32, block_kv=32,
                  interpret=True)
    close(ops.flash_attention(t(q), t(k), t(v), causal=causal,
                              window=window), want, 2e-5)


def test_fully_masked_rows_give_zero():
    """With sq > skv under ``causal`` the first rows see no key: the port
    gives 0 there (the JAX package's plain version gives NaN, its Pallas
    kernel the mean of v), and the other rows are unchanged."""
    q, k, v = arrs(14, (1, 2, 12, 8), (1, 1, 8, 8), (1, 1, 8, 8))
    got = ops.flash_attention(t(q), t(k), t(v), causal=True).numpy()
    assert np.all(got[:, :, :4] == 0)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=True)
    close(torch.from_numpy(got[:, :, 4:]), np.asarray(want)[:, :, 4:], 2e-5)
    lengths = torch.tensor([0, 3])
    out = ops.decode_attention(t(q[0, :, 0]).reshape(2, 1, 8).expand(
        2, 2, 8).contiguous(), t(k).expand(2, 1, 8, 8).contiguous(),
        t(v).expand(2, 1, 8, 8).contiguous(), lengths)
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out))


# ragged lengths; rep 7 with a length of 1; S = 300, not a multiple of the
# reference's 256-row tile; rep 1 with lengths at and below a tile edge
DECODE = [(3, 4, 2, 64, 16, (64, 17, 1)),
          (2, 7, 1, 40, 8, (1, 39)),
          (2, 14, 2, 300, 32, (300, 129)),
          (4, 8, 8, 256, 8, (256, 255, 128, 3))]


@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", DECODE)
def test_decode_attention(n, hq, hkv, s, d, lengths):
    q, kc, vc = arrs(15, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d))
    lens = np.array(lengths, np.int32)
    want = jdecode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                   jnp.asarray(lens), interpret=True)
    close(ops.decode_attention(t(q), t(kc), t(vc), t(lens)), want, 2e-5)
    close(ref.decode_attention_ref(t(q), t(kc), t(vc), t(lens)),
          jref.decode_attention_ref(*map(jnp.asarray, (q, kc, vc, lens))),
          2e-5)


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 1),
                                               (False, 8, 2),
                                               (True, 8, 1)])
def test_plain_attention_covers_lm_cases(causal, window, hkv):
    """The plain version keeps the reference's causal/window/GQA
    semantics for the LM slice."""
    q, k, v = arrs(8, (1, 2, 24, 8), (1, hkv, 24, 8), (1, hkv, 24, 8))
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window)
    close(ref.flash_attention_ref(t(q), t(k), t(v), causal=causal,
                                  window=window), want, 2e-5)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 32), 8),
                                          ((1, 16, 16, 64), 32)])
def test_gn_stats_two_pass_accuracy(shape, groups):
    """Statistics that the fused kernels share: mean and rstd match a
    float64 computation, also with a large common offset where
    E[x^2] - E[x]^2 in fp32 would cancel."""
    (x,) = arrs(9, shape)
    x += 300.0
    mean, rstd = ref.gn_stats_ref(t(x), groups, 1e-6)
    n, h, w, c = shape
    x64 = x.astype(np.float64).reshape(n, h * w, groups, c // groups)
    np.testing.assert_allclose(mean.numpy(), x64.mean(axis=(1, 3)),
                               rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt(x64.var(axis=(1, 3)) + 1e-6),
                               rtol=1e-3)


def test_quantize_rounds_half_to_even():
    # (y + 1) * 127.5 lands on .5 exactly for these y
    y = torch.tensor([-1.0, 1.0, 0.0, 2 / 255 - 1, 4 / 255 - 1, 7.0, -3.0])
    want = np.asarray(jref.quantize_u8_ref(jnp.asarray(y.numpy())))
    got = ref.quantize_u8_ref(y).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 128          # 127.5 -> 128 (even)


@pytest.mark.parametrize("name", sorted(ops.KERNEL_MODULES))
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(name):
    ops.reset_launch_counts()
    x, s, gb, wt, b = arrs(10, (1, 4, 4, 8), (8,), (8,), (3, 3, 8, 8), (8,))
    q = t(x).reshape(1, 1, 16, 8)
    qg = q.clone().requires_grad_(True)
    calls = {
        "conv3x3": lambda: ops.conv3x3(t(x), t(wt), t(b)),
        "gn_silu_conv3x3": lambda: ops.gn_silu_conv3x3(
            t(x), t(s), t(gb), t(wt), t(b), groups=2),
        "upsample_conv3x3": lambda: ops.upsample_conv3x3(t(x), t(wt), t(b)),
        "output_epilogue": lambda: ops.output_epilogue(
            t(x), t(s), t(gb), t(wt), t(b), groups=2),
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "flash_attention_bwd": lambda: torch.autograd.grad(
            ops.flash_attention(qg, q, q).sum(), qg),
        "group_norm_silu": lambda: ops.group_norm_silu(t(x), t(s), t(gb),
                                                       groups=2),
        "decode_attention": lambda: ops.decode_attention(
            q[:, 0, :2], q[:, :, :3], q[:, :, :3], torch.tensor([3])),
        "rwkv6_scan": lambda: ops.rwkv6_scan(q, q, q, q, q[0, :, 0]),
        "rwkv6_scan_bwd": lambda: torch.autograd.grad(
            ops.rwkv6_scan(qg, q, q, q, q[0, :, 0])[0].sum(), qg),
    }
    calls[name]()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNEL_MODULES}


def test_other_devices_are_refused():
    """A tensor that is neither on the CPU nor on CUDA never reaches the
    plain version."""
    x = torch.zeros((1, 4, 4, 8), device="meta")
    w = torch.zeros((3, 3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.conv3x3(x, w)
    r = x.reshape(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros((4, 8), device="meta"))

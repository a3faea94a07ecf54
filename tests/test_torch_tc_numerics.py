"""The arithmetic of the port's tensor-core kernels, modelled on the CPU.

The Hopper kernels run only on the card, but the numbers they can keep
follow from their arithmetic, which these tests repeat in PyTorch:

* 3xTF32 (``csrc/gn_silu_conv.cu``, the fp32 path of
  ``csrc/flash_attention.cu``): every fp32 operand is carried as hi =
  tf32(x) and lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32`` rounds
  (to nearest, ties away from zero, 13 low bits cleared), and a product is
  hi*hi' + hi*lo' + lo*hi' with fp32 sums.  At the SD3.5 VAE's full width
  it holds the fused conv's 1e-4 tolerance and the fp32 attention's 2e-5;
  one TF32 pass does not.
* bf16 attention on ``wgmma``: P is rounded to bf16 before P V (the row
  sums stay fp32), tile by tile over 64 keys with the online softmax.  At
  Qwen2-7B's and zamba2-2.7b's head shapes it stays within the 1e-2-of-max
  tolerance that the card's tests and ``chip_smoke.py`` hold the kernel to.

Inputs come from seeded numpy; the references are the JAX package's and
the port's plain versions, and float64 where the point is the error of a
product.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

torch.set_num_threads(2)

BKV = 64                     # keys per tile of the attention kernel


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


def three_tf32(fn, a, b):
    """``fn(a, b)`` for a bilinear ``fn`` in 3xTF32: the two cross terms
    first, then hi*hi, all in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return fn(al, bh) + fn(ah, bl) + fn(ah, bh)


def arrs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def test_tf32_rounding_is_cvt_rna():
    one = 1.0 + 2.0 ** -11           # exactly half of tf32's last place
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -9, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    v = torch.from_numpy(arrs(0, (4096,))[0])
    assert not (tf32(v).view(torch.int32) & 0x1FFF).any()
    hi, lo = split(v)
    rel = ((hi.double() + lo.double() - v.double()).abs() /
           v.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def test_3xtf32_conv_holds_fp32_tolerance_at_sd35_width(capsys):
    """One decoder res-block conv, Cin = Cout = 512, on an 8x8 patch."""
    cin = cout = 512
    x, s, gb, w, b = arrs(1, (1, 8, 8, cin), (cin,), (cin,),
                          (3, 3, cin, cout), (cout,))
    w *= (9 * cin) ** -0.5
    act = ref.group_norm_silu_ref(torch.from_numpy(x), torch.from_numpy(s),
                                  torch.from_numpy(gb), 32, 1e-6)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    want = ref.conv3x3_ref(act.double(), wt.double(), bt.double())
    jax_fp32 = np.asarray(jref.gn_silu_conv3x3_ref(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(gb), jnp.asarray(w),
        jnp.asarray(b), 32))

    three = three_tf32(ref.conv3x3_ref, act, wt) + bt
    one = ref.conv3x3_ref(tf32(act), tf32(wt), bt)
    err3 = float((three.double() - want).abs().max())
    err1 = float((one.double() - want).abs().max())
    with capsys.disabled():
        print(f"\n512->512 conv, 8x8: max error 3xTF32 {err3:.3g}, "
              f"1xTF32 {err1:.3g} (fp32 attention tolerance 2e-5, conv "
              f"tolerance 1e-4)")
    assert err3 <= 1e-4
    np.testing.assert_allclose(three.numpy(), jax_fp32, atol=1e-4, rtol=1e-4)
    assert err1 > 2e-5


def test_3xtf32_attention_holds_fp32_tolerance_at_vae_width():
    """The VAE mid-block's single head at d = 512 over 256 tokens."""
    q, k, v = (torch.from_numpy(a) for a in arrs(2, *[(1, 1, 256, 512)] * 3))
    scale = 512 ** -0.5
    want = torch.softmax(q.double() @ k.double().transpose(-1, -2) * scale,
                         -1) @ v.double()
    s3 = three_tf32(lambda a, b: a @ b.transpose(-1, -2), q, k) * scale
    out3 = three_tf32(torch.matmul, torch.softmax(s3, -1), v)
    s1 = tf32(q) @ tf32(k).transpose(-1, -2) * scale
    out1 = tf32(torch.softmax(s1, -1)) @ tf32(v)
    assert float((out3.double() - want).abs().max()) <= 2e-5
    assert float((out1.double() - want).abs().max()) > 2e-5


def attention_bf16_p(q, k, v, causal, window=None):
    """The bf16 kernel's arithmetic: fp32 logits of bf16 inputs, an online
    softmax over 64-key tiles with fp32 statistics, P rounded to bf16
    before P V, fp32 accumulation, output rounded to bf16."""
    n, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, dim=1).float()
    v = v.repeat_interleave(hq // hkv, dim=1).float()
    scale = d ** -0.5
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((n, hq, sq, 1), float("-inf"))
    l = torch.zeros((n, hq, sq, 1))
    acc = torch.zeros((n, hq, sq, d))
    for k0 in range(0, skv, BKV):
        s = q.float() @ k[:, :, k0:k0 + BKV].transpose(-1, -2) * scale
        kpos = torch.arange(k0, min(k0 + BKV, skv))[None, :]
        keep = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ v[:, :, k0:k0 + BKV]
        m = m_new
    out = torch.where(l > 0, acc / l, 0.0)
    return out.bfloat16()


@pytest.mark.parametrize("name,hq,hkv,d,window", [
    ("qwen2-7b", 7, 1, 128, None),
    ("qwen2-7b window", 7, 1, 128, 100),
    ("zamba2-2.7b", 2, 2, 80, None)])
def test_bf16_p_attention_holds_bf16_tolerance(name, hq, hkv, d, window):
    """Causal prefill over 512 keys at the model's head shape."""
    qn, kn, vn = arrs(3, (1, hq, 512, d), (1, hkv, 512, d), (1, hkv, 512, d))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    got = attention_bf16_p(q, k, v, causal=True, window=window).float()
    plain = ref.flash_attention_ref(q, k, v, causal=True,
                                    window=window).float()
    jax_out = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
          for a in (q, k, v)), causal=True, window=window)
        .astype(jnp.float32))
    tol = 1e-2 * float(plain.abs().max())
    assert float((got - plain).abs().max()) <= tol
    assert float(np.abs(got.numpy() - jax_out).max()) <= tol

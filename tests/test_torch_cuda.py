"""The port's Hopper kernels on the card, at small and ragged shapes that
the main paths (checked by ``chip_smoke.py``) never give them: odd
heights and widths, channel counts that fill no tile, conv_out's three
channels, the encoder's three input channels, ragged attention lengths.
Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  Also the batch invariance of the decode, the encoder and the
engine on CUDA against the CPU, and regeneration bit-exact on the card.
The four conv kernels' quantized-weight cases (bf16, and int8 with a
per-Cout scale) at ragged shapes, their bits against the fp32 path on
the same weight values, and the quantized decode and engine gate.  The
decode attention also at its serving shapes and at the edges of its row
partition, its bits independent of the batch and of the cache length,
and one device kernel per call.  The persistent, sharded store on the
card: a box it writes reopens bit-identical there and within +-1 LSB on
the CPU, and a dead shard's replicas serve the healthy box's bits.  The
serving runtime on the card: a drain stream is the window path bit for
bit, and an autoscaled engine scales on measured decode time.  The launch
layer on the card: ``make_decode_step`` against the same step on the
CPU, and the serving launcher at a tiny size.  The MoE, VLM and enc-dec
families: small fp32 models on the card against the CPU (the MoE at the
published capacity, so its steps drop entries), the attention kernels at
their serving shapes (whisper's head_dim 64, non-causal, 384 queries over
1500 keys), and the MoE on CUDA tensors with no synchronising call.

Marked ``cuda``: these skip where no NVIDIA GPU is present.  Run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  Tolerances: 2e-5 fp32, 1e-4 for the fused
GN + conv, +-1 LSB for uint8.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.vae import quantize as Q

pytestmark = pytest.mark.cuda

CONV_SHAPES = [(1, 8, 8, 16, 32, 4), (2, 16, 12, 8, 8, 2),
               (1, 5, 7, 4, 4, 2), (3, 4, 4, 32, 16, 8), (1, 9, 6, 8, 3, 2),
               (2, 33, 70, 24, 136, 4)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(dev, seed, *shapes, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev) * scale for s in shapes]


def max_err(a, b):
    torch.cuda.synchronize()
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_conv3x3(dev, n, h, w, cin, cout, groups):
    x, wt, b = randn(dev, 1, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= 0.1
    assert max_err(ops.conv3x3(x, wt, b), ref.conv3x3_ref(x, wt, b)) <= 2e-5


# the tensor-core tile's edges: Cin not a multiple of its 16-channel chunk,
# Cout not a multiple of its 128-channel tile, H and W not multiples of its
# 4 x 32 pixels; grids up to one block per SM run 16-warp blocks, the last
# case (324 blocks) 8-warp ones
TC_CONV_SHAPES = [(1, 13, 37, 520, 264, 8), (2, 6, 45, 128, 132, 32),
                  (2, 70, 90, 24, 264, 4)]


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES + TC_CONV_SHAPES)
def test_gn_silu_conv3x3(dev, n, h, w, cin, cout, groups):
    x, s, gb, wt, b = randn(dev, 2, (n, h, w, cin), (cin,), (cin,),
                            (3, 3, cin, cout), (cout,))
    wt *= 0.1
    got = ops.gn_silu_conv3x3(x, s, gb, wt, b, groups=groups)
    want = ref.gn_silu_conv3x3_ref(x, s, gb, wt, b, groups)
    assert max_err(got, want) <= 1e-4


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_output_epilogue(dev, n, h, w, cin, cout, groups):
    x, s, gb, wt, b = randn(dev, 3, (n, h, w, cin), (cin,), (cin,),
                            (3, 3, cin, cout), (cout,))
    wt *= 0.1
    got = ops.output_epilogue(x, s, gb, wt, b, groups=groups)
    want = ref.output_epilogue_ref(x, s, gb, wt, b, groups)
    assert got.dtype == torch.uint8
    assert max_err(got.int(), want.int()) <= 1


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 4, 4, 8, 8), (2, 5, 3, 4, 16), (1, 8, 6, 16, 8), (1, 7, 40, 12, 130)])
def test_upsample_conv3x3(dev, n, h, w, cin, cout):
    x, wt, b = randn(dev, 4, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= 0.1
    got = ops.upsample_conv3x3(x, wt, b)
    assert tuple(got.shape) == (n, 2 * h, 2 * w, cout)
    assert max_err(got, ref.upsample_conv3x3_ref(x, wt, b)) <= 2e-5


@pytest.mark.parametrize("n,h,sq,skv,d", [
    (1, 1, 64, 64, 32), (2, 1, 96, 80, 16), (1, 2, 40, 130, 8),
    (1, 1, 200, 333, 132)])
def test_flash_attention(dev, n, h, sq, skv, d):
    q, k, v = randn(dev, 6, (n, h, sq, d), (n, h, skv, d), (n, h, skv, d))
    got = ops.flash_attention(q, k, v)
    assert max_err(got, ref.flash_attention_ref(q, k, v)) <= 2e-5


# q heads over kv heads of 1, 2, 7; ragged tiles (sq, skv not multiples of
# 64); sq < skv and sq > skv (first rows with no key give 0); windows; the
# VAE's d = 512 and d not a multiple of 128 (zamba2's shared block: 80)
LM_ATTENTION = [(1, 4, 4, 70, 70, 128, True, None),
                (2, 14, 2, 129, 129, 128, True, None),
                (1, 28, 4, 100, 100, 128, True, 33),
                (1, 6, 2, 17, 200, 64, True, None),
                (1, 2, 1, 90, 60, 32, True, None),
                (2, 4, 2, 65, 130, 96, False, 40),
                (1, 2, 1, 40, 40, 512, True, 16),
                (2, 32, 32, 130, 130, 80, True, None),
                (1, 4, 4, 70, 70, 80, True, 20),
                # the tensor-core tiles' edges: d = 8, 80, 132, 512; rep 7, 2
                # and 1; sq, skv not multiples of 64 or 128; windows
                (1, 7, 1, 100, 100, 8, True, None),
                (2, 14, 2, 200, 200, 80, True, 64),
                (1, 2, 1, 150, 150, 132, True, 50),
                (1, 4, 4, 130, 257, 132, True, None),
                (1, 1, 1, 70, 300, 512, False, None),
                (1, 2, 2, 190, 190, 512, True, 100),
                # whisper-large-v3's d 64, rep 1: the encoder (non-causal,
                # 1500 keys: not a multiple of a key tile), the decoder's
                # causal self-attention and its cross-attention (384
                # queries over 1500 keys); qwen2-vl-72b's 64 over 8 heads
                (1, 20, 20, 1500, 1500, 64, False, None),
                (2, 20, 20, 384, 384, 64, True, None),
                (2, 20, 20, 384, 1500, 64, False, None),
                (1, 64, 8, 300, 300, 128, True, None),
                # kimi-k2's d 112 (the bf16 tile's 16 zero-padded lanes),
                # 64 over 8 heads; ragged sq < skv and sq > skv, a window
                (1, 64, 8, 130, 130, 112, True, None),
                (2, 16, 2, 70, 200, 112, True, 50),
                (1, 8, 1, 190, 65, 112, False, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", LM_ATTENTION)
def test_flash_attention_lm_cases(dev, n, hq, hkv, sq, skv, d, causal,
                                  window, dtype):
    q, k, v = (a.to(dtype) for a in randn(
        dev, 16, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert max_err(got, want) <= tol * float(want.abs().max().float())


# ragged lengths incl. 0, 1 and S; S not a multiple of the 64-row tile;
# rep 7, rep 1 and rep 12 (two groups of 8 heads); d 32, 64, 128, 256,
# zamba2's 80 and kimi-k2's 112
DECODE = [(4, 28, 4, 300, 128, (300, 129, 1, 0)),
          (2, 7, 1, 1000, 64, (999, 128)),
          (3, 8, 8, 64, 32, (64, 63, 2)),
          (2, 24, 2, 257, 256, (257, 100)),
          (1, 12, 1, 130, 128, (130,)),
          (4, 32, 32, 200, 80, (200, 129, 64, 1)),
          # the serving shapes of chip_smoke.py: Qwen2-7B, zamba2-2.7b,
          # mixtral-8x7b, qwen2-vl-72b, and whisper-large-v3's decoder
          # self-attention (448 slots) and cross-attention (1500 keys)
          (4, 28, 4, 2112, 128, (2049, 2080, 1500, 7)),
          (4, 32, 32, 2112, 80, (2049, 2080, 1500, 7)),
          (4, 32, 8, 2112, 128, (2049, 2080, 1500, 7)),
          (4, 64, 8, 2112, 128, (2049, 2080, 1500, 7)),
          (4, 20, 20, 448, 64, (385, 448, 416, 400)),
          (4, 20, 20, 1500, 64, (1500, 1500, 1500, 1500)),
          # kimi-k2-1t-a32b: d 112 at rep 8 (224-byte rows, the CUDA-core
          # p v path), its serving shape and the partition's edges
          (4, 64, 8, 2112, 112, (2049, 2080, 1500, 7)),
          (6, 8, 1, 1100, 112, (1, 31, 33, 65, 129, 1100)),
          # the partition's edges: a tile of 32 rows (fp32 d 128) or 64
          # (bf16 d 128, d 80) +-1; a CTA's span of the 8-way split steps
          # by 16 rows at len 128 k -> 128 k + 1; S itself; lengths that
          # leave CTAs of the cluster empty (1, 33, 40, 129: 1-5 of 8)
          (6, 14, 2, 1100, 128, (1, 31, 32, 33, 63, 64)),
          (6, 14, 2, 1100, 128, (65, 127, 128, 129, 1023, 1024)),
          (4, 7, 1, 1100, 128, (1025, 40, 1100, 1099)),
          (6, 4, 4, 1030, 80, (1, 63, 65, 129, 1025, 1030)),
          # more q heads per kv head than one pass of 8 takes
          (1, 20, 1, 300, 64, (300,)),
          (2, 34, 2, 200, 32, (200, 17))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", DECODE)
def test_decode_attention(dev, n, hq, hkv, s, d, lengths, dtype):
    q, kc, vc = (a.to(dtype) for a in randn(
        dev, 17, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    lens = torch.tensor(lengths, device=dev)
    got = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert max_err(got, want) <= tol * float(want.abs().max().float())
    # each sequence also against its own largest output: a long sequence's
    # outputs are far smaller than a short one's, so a fault in its share
    # of the rows would hide under the whole batch's limit
    for i in range(n):
        assert max_err(got[i], want[i]) <= tol * float(
            want[i].abs().max().float()), (i, lengths[i])
    assert torch.all(got[[i for i, n_ in enumerate(lengths) if n_ == 0]]
                     == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", DECODE)
def test_decode_attention_partial(dev, n, hq, hkv, s, d, lengths, dtype):
    """The partial form against its plain version at the ragged shapes:
    o fp32 within 2e-5 (fp32) or 1e-4 (bf16 inputs: both sides sum exact
    products in fp32, in other orders) of each row's largest, lse within
    1e-5 of max(1, |lse|); a row of length 0 gives o = 0, lse = -inf.
    One launch, counted as ``decode_attention``'s, and o rounded to the
    inputs' dtype is the default form's output bit for bit."""
    q, kc, vc = (a.to(dtype) for a in randn(
        dev, 17, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    lens = torch.tensor(lengths, device=dev)
    ops.reset_launch_counts()
    o, lse = ops.decode_attention_partial(q, kc, vc, lens)
    assert ops.launch_counts()["decode_attention"] == 1
    want_o, want_lse = ref.decode_attention_partial_ref(q, kc, vc, lens)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == want_o.shape and lse.shape == want_lse.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-4
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert torch.all(o[i] == 0) and torch.all(torch.isneginf(lse[i]))
            continue
        assert max_err(o[i], want_o[i]) <= tol * float(
            want_o[i].abs().max()), (i, n_keys)
        assert max_err(lse[i], want_lse[i]) <= 1e-5 * max(
            1.0, float(want_lse[i].abs().max())), (i, n_keys)
    assert torch.equal(o.to(dtype), ops.decode_attention(q, kc, vc, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [2, 16])
def test_decode_attention_partial_split_and_merged(dev, dtype, parts):
    """Qwen2-7B's decode shape with its slots split into ``parts`` ranges
    (some empty at the short lengths), each through the partial kernel,
    merged by ``ops.merge_partials``: against one ``decode_attention``
    call, fp32 within 1e-5 of each row's largest, bf16 within one ulp of
    the output (both round the same fp32 row once)."""
    n, hq, hkv, s, d = 4, 28, 4, 2112, 128
    q, kc, vc = (a.to(dtype) for a in randn(
        dev, 23, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    lens = torch.tensor((2049, 2080, 1500, 7), device=dev)
    s_l = s // parts
    os_, lses = [], []
    for r in range(parts):
        sl = slice(r * s_l, (r + 1) * s_l)
        o, lse = ops.decode_attention_partial(
            q, kc[:, :, sl].contiguous(), vc[:, :, sl].contiguous(),
            torch.clamp(lens - r * s_l, 0, s_l))
        os_.append(o)
        lses.append(lse)
    got = ops.merge_partials(torch.stack(os_), torch.stack(lses), dtype)
    want = ops.decode_attention(q, kc, vc, lens)
    for i in range(n):
        w = want[i].float()
        if dtype == torch.float32:
            assert max_err(got[i], want[i]) <= 1e-5 * float(w.abs().max()), i
        else:                  # one bf16 ulp: 2^-7 of each output's binade
            ulp = torch.exp2(torch.floor(torch.log2(
                w.abs().clamp(min=2.0 ** -126))) - 7)
            assert torch.all((got[i].float() - w).abs() <= ulp), i


def test_decode_attention_independent_of_batch_and_cache_length(dev):
    """A sequence's result depends on its own rows and length only: the
    same bits alone, in a batch, and in a longer cache.  Lengths 2049 and
    1000 spread over all 8 CTAs of a cluster, 400 over 7, 33 over 3."""
    for s, lengths, longer_s in ((400, (400, 257, 33), 700),
                                 (2112, (2049, 1000, 33), 2400)):
        q, kc, vc = randn(dev, 18, (3, 14, 128), (3, 2, s, 128),
                          (3, 2, s, 128))
        lens = torch.tensor(lengths, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), kc.to(dtype), vc.to(dtype)
            batch = ops.decode_attention(qd, kd, vd, lens)
            for i in range(3):
                one = ops.decode_attention(qd[i:i + 1], kd[i:i + 1],
                                           vd[i:i + 1], lens[i:i + 1])
                assert torch.equal(batch[i:i + 1], one)
            longer = torch.zeros((3, 2, longer_s, 128), device=dev,
                                 dtype=dtype)
            kl, vl = longer.clone(), longer.clone()
            kl[:, :, :s], vl[:, :, :s] = kd, vd
            assert torch.equal(ops.decode_attention(qd, kl, vl, lens), batch)


# the serving shapes at 8 kv heads (32 clusters of 8 at batch 4):
# kimi-k2-1t-a32b's d 112 and qwen2-vl-72b's d 128, 64 q heads each
EIGHT_KV = [(4, 64, 8, 2112, 112, (2049, 2080, 1500, 7)),
            (4, 64, 8, 2112, 128, (2049, 2080, 1500, 7))]


def garbage_past_lengths(kc, vc, lengths):
    """The caches with every slot at or past each length set to NaN, +inf
    or -inf in turn (a slot never written may hold anything), and the
    same caches with zeros there."""
    s = kc.shape[2]
    past = (torch.arange(s, device=kc.device)[None, :]
            >= torch.tensor(lengths, device=kc.device)[:, None])
    past = past[:, None, :, None].expand_as(kc)
    junk = torch.tensor([float("nan"), float("inf"), float("-inf")],
                        device=kc.device)
    fill = junk[torch.arange(kc.numel(), device=kc.device).view(kc.shape)
                % 3].to(kc.dtype)
    return ([torch.where(past, fill, t) for t in (kc, vc)],
            [torch.where(past, torch.zeros_like(t), t) for t in (kc, vc)])


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", [
    (4, 28, 4, 2112, 128, (2049, 2080, 1500, 7)),    # Qwen2-7B
    (4, 64, 8, 2112, 112, (2049, 2080, 1500, 7)),    # kimi-k2
    # kimi-k2's head shape at a length of 0, 1, a CTA's span + 1 and S
    (4, 64, 8, 2112, 112, (0, 1, 273, 2112))])
def test_decode_attention_ignores_nan_and_inf_past_each_length(
        dev, n, hq, hkv, s, d, lengths, dtype, partial):
    """Slots at or past each length full of NaN and +-inf (the TMA boxes
    load up to 15 of them a CTA, and the tensor-core p v multiplies its
    rows by p = 0): the output is finite, the same bits as with zeros
    there, and within the plain version's tolerances per sequence (on the
    zeroed caches: the plain version multiplies p = 0 by what the slots
    hold); a length of 0 gives o = 0 (and lse = -inf)."""
    q, kc, vc = (a.to(dtype) for a in randn(
        dev, 41, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    (kg, vg), (kz, vz) = garbage_past_lengths(kc, vc, lengths)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    if partial:
        got, got_lse = ops.decode_attention_partial(q, kg, vg, lens)
        clean, clean_lse = ops.decode_attention_partial(q, kz, vz, lens)
        want, want_lse = ref.decode_attention_partial_ref(q, kz, vz, lens)
        assert torch.equal(got_lse, clean_lse)
        tol = 2e-5 if dtype == torch.float32 else 1e-4
    else:
        got = ops.decode_attention(q, kg, vg, lens)
        clean = ops.decode_attention(q, kz, vz, lens)
        want = ref.decode_attention_ref(q, kz, vz, lens)
        tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, clean)
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert torch.all(got[i] == 0)
            if partial:
                assert torch.all(torch.isneginf(got_lse[i]))
            continue
        assert max_err(got[i], want[i]) <= tol * float(
            want[i].abs().max().float()), (i, n_keys)
        if partial:
            assert max_err(got_lse[i], want_lse[i]) <= 1e-5 * max(
                1.0, float(want_lse[i].abs().max())), (i, n_keys)


@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", EIGHT_KV)
def test_decode_attention_independent_of_batch_at_eight_kv_heads(
        dev, n, hq, hkv, s, d, lengths):
    """The bits of each sequence at the 32-cluster serving shapes: alone,
    in the batch, and in a longer cache, fp32 and bf16."""
    q, kc, vc = randn(dev, 42, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d))
    lens = torch.tensor(lengths, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = q.to(dtype), kc.to(dtype), vc.to(dtype)
        batch = ops.decode_attention(qd, kd, vd, lens)
        for i in range(n):
            one = ops.decode_attention(qd[i:i + 1], kd[i:i + 1], vd[i:i + 1],
                                       lens[i:i + 1])
            assert torch.equal(batch[i:i + 1], one), (dtype, i)
        longer = torch.zeros((n, hkv, s + 300, d), device=dev, dtype=dtype)
        kl, vl = longer.clone(), longer.clone()
        kl[:, :, :s], vl[:, :, :s] = kd, vd
        assert torch.equal(ops.decode_attention(qd, kl, vl, lens), batch)


@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", EIGHT_KV)
def test_decode_attention_one_device_kernel_at_eight_kv_heads(
        dev, n, hq, hkv, s, d, lengths):
    """One kernel on the device per call, at the 32-cluster shapes."""
    q, kc, vc = (a.to(torch.bfloat16) for a in randn(
        dev, 43, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    assert device_nodes_of(
        lambda: ops.decode_attention(q, kc, vc, lens)) == [0]


@pytest.mark.parametrize("dtype,hq,hkv,s,d", [
    (torch.bfloat16, 28, 4, 2112, 128),     # Qwen2-7B
    (torch.float32, 28, 4, 2112, 128),
    (torch.bfloat16, 32, 32, 2112, 80),     # zamba2-2.7b
    (torch.bfloat16, 32, 8, 2112, 128),     # mixtral-8x7b
    (torch.bfloat16, 64, 8, 2112, 128),     # qwen2-vl-72b
    (torch.bfloat16, 64, 8, 2112, 112),     # kimi-k2
    (torch.bfloat16, 20, 20, 448, 64),      # whisper-large-v3 self
    (torch.bfloat16, 20, 20, 1500, 64),     # and cross
    (torch.float32, 20, 20, 1500, 64)])
def test_decode_attention_config_at_serving_shapes(dev, dtype, hq, hkv, s, d):
    """Every serving shape: bf16 at rep > 1 two CTAs an SM (32 clusters of
    8 in one wave where the card holds them) with four consumer warps, rep
    1 four CTAs an SM, at least three stages in the ring; fp32 at rep > 1
    eight consumer warps (CUDA-core p v of 8 heads); p v on the tensor
    cores exactly for bf16 at rep > 1 with d % 16 == 0; the grid a cluster
    per (sequence, kv head)."""
    from repro_torch.kernels import decode_attention as da
    q = torch.zeros((4, hq, d), device=dev, dtype=dtype)
    kc = torch.zeros((4, hkv, s, d), device=dev, dtype=dtype)
    c = da.config(q, kc)
    rep = hq // hkv
    if rep == 1:
        assert c["ctas_per_sm"] >= 4 and c["stages"] >= 3, c
    elif dtype == torch.bfloat16:
        assert c["ctas_per_sm"] >= 2 and c["stages"] >= 3, c
        assert c["threads"] == 32 * 5, c
    else:
        assert c["threads"] == 32 * 9 and c["stages"] >= 2, c
    assert c["tensor_core_pv"] == int(
        dtype == torch.bfloat16 and rep > 1 and d % 16 == 0), c
    assert (c["grid_x"], c["grid_y"], c["grid_z"]) == (
        c["cluster"], hkv, 4), c
    assert c["max_active_clusters"] > 0, c


def test_attention_kernels_count_one_launch_per_call(dev):
    q, kc = randn(dev, 19, (2, 4, 32), (2, 2, 50, 32))
    ops.reset_launch_counts()
    ops.decode_attention(q, kc, kc, torch.tensor([50, 3], device=dev))
    qq = q.reshape(2, 4, 1, 32)
    ops.flash_attention(qq, kc, kc, causal=True)
    ref.decode_attention_ref(q, kc, kc, torch.tensor([50, 3], device=dev))
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 1
    assert counts["flash_attention"] == 1
    assert sum(counts.values()) == 2


def device_nodes_of(call):
    """The device work one ``call()`` issues: the node types of a CUDA graph
    captured from it, as the driver lists them (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``; a kernel is 0).  Capture records every launch
    on the stream, where a profiler window on the card now and then
    reports no device activity at all."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    call()                                              # build, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        call()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds


def test_decode_attention_issues_one_device_kernel(dev):
    """One call is one kernel on the device: no second merge launch, no
    scratch to fill (counted in a CUDA graph captured from the call)."""
    for dtype, shape in ((torch.bfloat16, (4, 28, 4, 128)),
                         (torch.bfloat16, (4, 32, 32, 80)),
                         (torch.float32, (2, 12, 1, 256))):
        n, hq, hkv, d = shape
        q, kc, vc = (a.to(dtype) for a in randn(
            dev, 20, (n, hq, d), (n, hkv, 700, d), (n, hkv, 700, d)))
        lens = torch.tensor([700, 513, 2, 0][:n], device=dev,
                            dtype=torch.int32)
        assert device_nodes_of(
            lambda: ops.decode_attention(q, kc, vc, lens)) == [0]


def test_decode_attention_refuses_partial_16_byte_rows(dev):
    """The kernel stages cache rows 16 bytes at a time: bf16 needs d % 8
    (fp32 d % 4), and the wrapper raises for other head dims."""
    for dtype, d in ((torch.bfloat16, 36), (torch.bfloat16, 4),
                     (torch.float32, 6)):
        kc = torch.zeros((1, 1, 8, d), device=dev, dtype=dtype)
        with pytest.raises(ValueError):
            ops.decode_attention(torch.zeros((1, 2, d), device=dev,
                                             dtype=dtype), kc, kc,
                                 torch.tensor([8], device=dev))
    kc = torch.zeros((1, 1, 8, 40), device=dev, dtype=torch.bfloat16)
    out = ops.decode_attention(torch.ones((1, 2, 40), device=dev,
                                          dtype=torch.bfloat16), kc, kc,
                               torch.tensor([8], device=dev))
    assert torch.equal(out, torch.zeros_like(out))


def test_lm_on_card_matches_cpu(dev):
    """A small fp32 qwen2-family model: prefill and decode steps on the
    card through both attention kernels against the plain CPU path."""
    import dataclasses
    from repro_torch.configs import build_model, get_config, reduced_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.vae.model import map_params
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-7b")),
                              n_heads=8, n_kv_heads=2, d_model=256)
    gpu = build_model(cfg, device=dev, seed=3)
    cpu = CausalLM(cfg, device="cpu",
                   params=map_params(gpu.params, lambda t: t.cpu()))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 41))
    gl, gc = gpu.prefill(toks[:, :37], max_len=48)
    cl, cc = cpu.prefill(toks[:, :37], max_len=48)
    for t in range(37, 41):
        assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
        gl, gc = gpu.decode_step(gc, toks[:, t])
        cl, cc = cpu.decode_step(cc, toks[:, t])
    assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
    assert max_err(gc["k"].cpu(), cc["k"]) <= 1e-4 * float(cc["k"].abs().max())


def small_family_model(arch, dev, seed):
    """A small fp32 model of ``arch``'s family on the card and the same
    weights on the CPU."""
    import dataclasses
    from repro_torch.configs import build_model, get_config, reduced_config
    from repro_torch.vae.model import map_params
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=3)
    if cfg.family == "moe":        # the published capacity: steps drop
        cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    gpu = build_model(cfg, device=dev, seed=seed)
    cpu = type(gpu)(cfg, device="cpu",
                    params=map_params(gpu.params, lambda t: t.cpu()))
    return cfg, gpu, cpu


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-72b",
                                  "whisper-large-v3"])
def test_moe_vlm_encdec_on_card_match_cpu(dev, arch):
    """Small fp32 MoE (capacity factor 1.25), VLM (an embeds prefix) and
    enc-dec models: prefill and decode steps on the card through both
    attention kernels against the plain CPU path, logits and every cache
    leaf; each kernel's launches per prefill and per step."""
    cfg, gpu, cpu = small_family_model(arch, dev, seed=8)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (3, 40))
    side = None
    if cfg.family == "vlm":
        side = rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    elif cfg.family == "encdec":
        side = rng.standard_normal((3, 70, cfg.d_model)).astype(np.float32)

    def prefill(model):
        if cfg.family == "encdec":
            return model.prefill(toks[:, :37], side, max_len=48)
        return model.prefill(toks[:, :37], max_len=48, embeds=side)

    ops.reset_launch_counts()
    gl, gc = prefill(gpu)
    layers = cfg.encoder_layers + 2 * cfg.n_layers \
        if cfg.family == "encdec" else cfg.n_layers
    assert ops.launch_counts()["flash_attention"] == layers
    cl, cc = prefill(cpu)
    for t in range(37, 40):
        assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
        ops.reset_launch_counts()
        gl, gc = gpu.decode_step(gc, toks[:, t])
        assert ops.launch_counts()["decode_attention"] == (
            2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers)
        cl, cc = cpu.decode_step(cc, toks[:, t])
    assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
    assert torch.equal(gc["pos"].cpu(), cc["pos"])
    for key in [k for k in cc if k != "pos"]:
        assert max_err(gc[key].cpu(), cc[key]) <= \
            1e-4 * float(cc[key].abs().max()), key


@pytest.mark.parametrize("t", [4, 37, 300])
def test_moe_on_card_matches_cpu_without_a_host_sync(dev, t):
    """``blocks.moe`` on CUDA tensors makes no synchronising call (a
    decode step stays one stream of launches), drops what the CPU drops at
    capacity factor 1.25, and gives the CPU's values in fp32."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import blocks as B
    cfg = dataclasses.replace(reduced_config(get_config("mixtral-8x7b")),
                              capacity_factor=1.25)
    g = torch.Generator(device=dev).manual_seed(t)
    params = B.moe_init(g, cfg)
    x = torch.randn((1, t, cfg.d_model), generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = B.moe(params, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = B.moe({k: v.cpu() for k, v in params.items()}, x.cpu(), cfg)
    assert max_err(got.cpu(), want) <= 1e-4 * float(want.abs().max())


def test_gn_stats_against_float64(dev):
    from repro_torch.kernels.gn_silu_conv import gn_stats
    (x,) = randn(dev, 7, (2, 37, 29, 64))
    x = x + 300.0                  # E[x^2] - E[x]^2 would cancel here
    stats = gn_stats(x, 8, 1e-6)
    x64 = x.double().reshape(2, -1, 8, 8)
    mean = x64.mean(dim=(1, 3))
    rstd = (x64.var(dim=(1, 3), correction=0) + 1e-6).rsqrt()
    assert max_err(stats[..., 0], mean) <= 1e-4
    assert float(((stats[..., 1].double() - rstd) / rstd).abs().max()) <= 1e-4


# ragged pixel counts, C = 4 (one quad), cpg = 2 (a quad spans two
# groups), odd C/4, and the float decode's norm_out width
GN_SHAPES = [(1, 5, 7, 16, 4), (3, 9, 11, 8, 4), (2, 13, 3, 12, 3),
             (1, 4, 4, 4, 2), (2, 33, 70, 40, 5), (1, 64, 64, 512, 32)]


@pytest.mark.parametrize("n,h,w,c,groups", GN_SHAPES)
def test_group_norm_silu(dev, n, h, w, c, groups):
    x, s, gb = randn(dev, 10, (n, h, w, c), (c,), (c,))
    x = x * 3.0 + 1.5
    got = ops.group_norm_silu(x, s, gb, groups=groups)
    want = ref.group_norm_silu_ref(x, s, gb, groups)
    assert got.shape == x.shape
    assert max_err(got, want) <= 2e-5 * max(1.0, float(want.abs().max()))


def test_group_norm_silu_float_decode_width_against_float64(dev):
    """norm_out of the float decode: 512x512x128, 4 channels per group,
    about 1 M elements per group, with an offset at which E[x^2] - E[x]^2
    in fp32 would cancel."""
    x, s, gb = randn(dev, 11, (1, 512, 512, 128), (128,), (128,))
    x = x + 30.0
    got = ops.group_norm_silu(x, s, gb, groups=32)
    x64 = x.double().reshape(1, -1, 32, 4)
    mean = x64.mean(dim=(1, 3), keepdim=True)
    rstd = (x64.var(dim=(1, 3), correction=0, keepdim=True) + 1e-6).rsqrt()
    y = ((x64 - mean) * rstd).reshape(x.shape) * s.double() + gb.double()
    want = y * torch.sigmoid(y)
    assert max_err(got, want) <= 1e-4


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 64, 64, 3, 128),       # encoder conv_in (Cin = 3, one padded chunk)
    (1, 16, 16, 512, 32),      # encoder conv_out (Cout = 32 on a 128 tile)
    (1, 64, 64, 128, 3),       # float decode conv_out (narrow tile, fp32)
    (2, 9, 13, 3, 32)])
def test_conv3x3_encoder_and_float_decode_shapes(dev, n, h, w, cin, cout):
    x, wt, b = randn(dev, 12, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= (9 * cin) ** -0.5
    got = ops.conv3x3(x, wt, b)
    want = ref.conv3x3_ref(x, wt, b)
    assert max_err(got, want) <= 2e-5 * max(1.0, float(want.abs().max()))


def test_launch_counted_once_per_call(dev):
    x, wt, b = randn(dev, 8, (1, 8, 8, 8), (3, 3, 8, 8), (8,))
    ops.reset_launch_counts()
    ops.conv3x3(x, wt, b)
    ops.conv3x3(x, wt, b)
    ref.conv3x3_ref(x, wt, b)
    counts = ops.launch_counts()
    assert counts["conv3x3"] == 2
    assert sum(counts.values()) == 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, wt = randn(dev, 9, (1, 8, 8, 8), (3, 3, 8, 8))
    with pytest.raises(TypeError):
        ops.conv3x3(x.double(), wt.double())
    with pytest.raises(ValueError):
        ops.conv3x3(x.transpose(1, 2), wt)
    with pytest.raises(ValueError):
        ops.conv3x3(x, wt.cpu())
    q = x.reshape(1, 1, 64, 8)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double(), causal=True)
    with pytest.raises(ValueError):          # 3 q heads over 2 kv heads
        ops.flash_attention(x.reshape(1, 2, 32, 8)[:, :1].expand(
            1, 3, 32, 8).contiguous(), x.reshape(1, 2, 32, 8),
            x.reshape(1, 2, 32, 8))
    with pytest.raises(ValueError):          # head dim above 256
        kc = torch.zeros((1, 1, 4, 260), device=dev)
        ops.decode_attention(torch.zeros((1, 2, 260), device=dev), kc, kc,
                             torch.tensor([4], device=dev))
    (y,) = randn(dev, 9, (1, 4, 4, 6))
    with pytest.raises(ValueError):          # C not a multiple of 4
        ops.group_norm_silu(y, y[0, 0, 0], y[0, 0, 0], groups=2)


def test_group_norm_silu_counts_one_launch(dev):
    x, s, gb = randn(dev, 13, (2, 8, 8, 16), (16,), (16,))
    ops.reset_launch_counts()
    ops.group_norm_silu(x, s, gb, groups=4)
    assert ops.launch_counts()["group_norm_silu"] == 1
    assert sum(ops.launch_counts().values()) == 1


def test_demo_decode_batch_invariant_and_matches_cpu(dev):
    from repro_torch.vae.model import DEMO_VAE, VAE, map_params
    gpu = VAE(DEMO_VAE, seed=1, device=dev)
    cpu = VAE(DEMO_VAE, device="cpu",
              params=map_params(gpu.decoder, lambda t: t.cpu()))
    z = np.random.default_rng(1).standard_normal((8, 8, 8, 4)).astype(
        np.float32)
    batch = gpu.decode_u8(z).cpu()
    for i in range(8):
        assert torch.equal(batch[i:i + 1], gpu.decode_u8(z[i:i + 1]).cpu())
    assert max_err(batch.int(), cpu.decode_u8(z).int()) <= 1


def test_demo_encode_and_float_decode_match_cpu(dev):
    from repro_torch.vae.model import DEMO_VAE, VAE, map_params
    gpu = VAE(DEMO_VAE, seed=2, device=dev)
    cpu = VAE(DEMO_VAE, device="cpu",
              params=map_params(gpu.decoder, lambda t: t.cpu()),
              encoder_params=map_params(gpu.encoder, lambda t: t.cpu()))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 32, 32, 3)) * 0.5).astype(np.float32)
    got = gpu.encode_mean(x).cpu()
    want = cpu.encode_mean(x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for i in range(4):                       # batch-invariant encoder
        assert torch.equal(got[i:i + 1], gpu.encode_mean(x[i:i + 1]).cpu())
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    assert max_err(gpu.decode(z).cpu(), cpu.decode(z)) <= 1e-4


def test_regeneration_bit_exact_on_card(dev):
    from repro_torch.core.regen_tier import Recipe
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.store import LatentBox, StoreConfig
    box = LatentBox.engine(device=dev, config=StoreConfig(
        n_nodes=1, cache_bytes_per_node=1e4, image_bytes=768.0,
        latent_bytes=6e2, tuner=TunerConfig(window=10**9)))
    store = box.backend.store
    box.put(9, recipe=Recipe(seed=21, height=32, width=32, scale=0.5))
    blob = store.get(9)
    before = box.get(9)
    assert box.demote(9) and store.get(9) is None
    after = box.get(9)
    assert after.regenerated and store.get(9) == blob
    np.testing.assert_array_equal(before.payload, after.payload)


def test_engine_on_cuda_classifies_like_cpu(dev):
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.vae.model import VAE, demo_vae, map_params

    def cfg():
        return StoreConfig(n_nodes=2, cache_bytes_per_node=2e4,
                           image_bytes=768.0, latent_bytes=6e2,
                           promote_threshold=2,
                           tuner=TunerConfig(window=10**9))

    gvae = demo_vae(seed=0, device=dev)
    cvae = VAE(gvae.cfg, device="cpu",
               params=map_params(gvae.decoder, lambda t: t.cpu()))
    rng = np.random.default_rng(2)
    lat = [rng.standard_normal((8, 8, 4)).astype(np.float16)
           for _ in range(12)]
    trace = [int(t) for t in rng.integers(0, 12, 48)]
    out = []
    for box in (LatentBox.engine(vae=gvae, config=cfg(), device=dev),
                LatentBox.engine(vae=cvae, config=cfg(), device="cpu")):
        for oid, z in enumerate(lat):
            box.put(oid, latent=z)
        res = []
        for s in range(0, len(trace), 8):
            res += box.get_many(trace[s:s + 8])
        out.append(res)
    for g, c in zip(*out):
        assert (g.hit_class, g.node) == (c.hit_class, c.node)
        d = np.abs(g.payload.astype(np.int16) - c.payload.astype(np.int16))
        assert d.max() <= 1


# ---------------------------------------------------------------------------
# the persistent, sharded store on the card: a box the card writes reopens
# bit-identical on the card and within +-1 LSB on the CPU's plain path
# (the same directory opened there), at ragged 24x40 latents
# ---------------------------------------------------------------------------

STORE_LATENT = (24, 40, 4)


def _store_cfg(**kw):
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.store import StoreConfig
    side = 2 * STORE_LATENT[0] * 2 * STORE_LATENT[1] * 3
    return StoreConfig(n_nodes=2, cache_bytes_per_node=4 * side,
                       image_bytes=float(side), latent_bytes=4e3,
                       promote_threshold=2, tuner=TunerConfig(window=10**9),
                       **kw)


def _store_vaes(dev):
    from repro_torch.vae.model import VAE, demo_vae, map_params
    gvae = demo_vae(seed=0, device=dev)
    cvae = VAE(gvae.cfg, device="cpu",
               params=map_params(gvae.decoder, lambda t: t.cpu()),
               encoder_params=map_params(gvae.encoder, lambda t: t.cpu()))
    return gvae, cvae


def _fill_store(box, n):
    from repro_torch.core.regen_tier import Recipe
    rng = np.random.default_rng(4)
    for oid in range(n):
        if oid % 5 == 4:            # an encode on the card, then demoted
            box.put(oid, recipe=Recipe(seed=oid, height=48, width=80))
            assert box.demote(oid)
        else:
            box.put(oid, latent=rng.standard_normal(STORE_LATENT)
                    .astype(np.float16))


def _serve_store(box, ids):
    res = []
    for s in range(0, len(ids), 8):
        res += box.get_many(ids[s:s + 8])
    return [(r.hit_class, r.node) for r in res], [r.payload for r in res]


def _near(a, b):
    return all(x.shape == y.shape and np.abs(x.astype(np.int16)
                                             - y.astype(np.int16)).max() <= 1
               for x, y in zip(a, b))


def test_store_reopen_on_card_bit_identical_and_near_cpu(dev, tmp_path):
    import shutil
    from repro_torch.store import LatentBox
    gvae, cvae = _store_vaes(dev)
    ids = [int(i) for i in np.random.default_rng(5).integers(0, 10, 40)]
    with LatentBox.open(tmp_path / "g", vae=gvae, config=_store_cfg(),
                        device=dev) as box:
        _fill_store(box, 10)
        box.flush()
        _, first = _serve_store(box, ids)
        assert first[0].shape == (48, 80, 3)
        for oid in (4, 9):
            assert box.demote(oid) or box.stat(oid).demoted
    shutil.copytree(tmp_path / "g", tmp_path / "c")
    with LatentBox.open(tmp_path / "g", vae=gvae, config=_store_cfg(),
                        device=dev) as box:
        gsig, again = _serve_store(box, ids)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    with LatentBox.open(tmp_path / "c", vae=cvae, config=_store_cfg(),
                        device="cpu") as box:
        csig, cpu = _serve_store(box, ids)
    assert csig == gsig and _near(again, cpu)


def test_store_dead_shard_on_card_bit_identical_and_near_cpu(dev, tmp_path):
    import shutil
    from repro_torch.store import LatentBox
    from repro_torch.store.faults import FaultPlan
    gvae, cvae = _store_vaes(dev)
    ids = [int(i) for i in np.random.default_rng(6).integers(0, 16, 64)]
    kw = dict(config=_store_cfg(), shards=4, replication=2)
    with LatentBox.open(tmp_path / "a", vae=gvae, device=dev, **kw) as box:
        _fill_store(box, 16)
    for d in ("b", "c"):
        shutil.copytree(tmp_path / "a", tmp_path / d)
    runs = {}
    for d, vae, device, plan in (("a", gvae, dev, None),
                                 ("b", gvae, dev, FaultPlan.kill(1, 16)),
                                 ("c", cvae, "cpu", FaultPlan.kill(1, 16))):
        with LatentBox.open(tmp_path / d, vae=vae, device=device,
                            fault_plan=plan, **kw) as box:
            runs[d] = _serve_store(box, ids) + (box.summary(),)
    assert runs["b"][2]["failovers"] > 0 and runs["b"][2]["dead_shards"] == [1]
    assert runs["a"][0] == runs["b"][0] == runs["c"][0]
    for a, b in zip(runs["a"][1], runs["b"][1]):
        np.testing.assert_array_equal(a, b)
    assert _near(runs["b"][1], runs["c"][1])


# ---------------------------------------------------------------------------
# the serving runtime on the card: a drain stream serves what windows of 8
# serve, bit for bit, and an autoscaled engine scales on measured decode
# time, at ragged 24x40 latents
# ---------------------------------------------------------------------------

def _stream_box(gvae, dev, **kw):
    from repro_torch.store import LatentBox
    box = LatentBox.engine(vae=gvae, config=_store_cfg(**kw), device=dev)
    _fill_store(box, 20)
    return box


def test_stream_drain_is_the_window_path_on_card(dev):
    from repro_torch.serve.runtime import RuntimeConfig
    from repro_torch.trace.synth import make_trace
    gvae, _ = _store_vaes(dev)
    tr = make_trace("flash_crowd", n_objects=20, n_requests=96,
                    span_days=2.0, seed=7)
    ids = [int(o) for o in tr.object_ids]
    sig, pixels = _serve_store(_stream_box(gvae, dev), ids)
    rep = _stream_box(gvae, dev).serve_stream(
        tr, RuntimeConfig.conformance(keep_payloads=True))
    assert rep.outcomes == sig
    assert {h for h, _ in sig} >= {"image_hit", "full_miss", "regen_miss"}
    for k, px in enumerate(pixels):
        np.testing.assert_array_equal(rep.payloads[k], px)


def test_engine_autoscales_on_card(dev):
    """Measured decode time on the card against a barely advancing
    injected clock saturates utilization: the controller scales up, and
    every image is the unscaled box's."""
    from repro_torch.core.autoscale import AutoscaleConfig
    gvae, _ = _store_vaes(dev)
    clock = [1_000.0]
    box = _stream_box(gvae, dev, clock=lambda: clock[0], autoscale=True,
                      autoscale_cfg=AutoscaleConfig(window=8,
                                                    cooldown_windows=0))
    ids = [int(i) for i in np.random.default_rng(8).integers(0, 20, 48)]
    served = []
    for s in range(0, len(ids), 8):
        clock[0] += 1e-3
        served += box.get_many(ids[s:s + 8])
    summ = box.summary()
    assert summ["autoscale_windows"] == len(ids) // 8
    assert summ["scale_up_events"] >= 1
    _, plain = _serve_store(_stream_box(gvae, dev), ids)
    for r, px in zip(served, plain):
        np.testing.assert_array_equal(r.payload, px)


# ---------------------------------------------------------------------------
# rwkv6_scan: t not a multiple of the chunked kernel's 16-token sub-chunk, d
# from 3 to 128 (and d not a power of two), fp32 and bf16 r/k/v, with and
# without an initial state; the sub-chunk's edges, decays from dec ~ 1 to a
# log-decay of -55 per token, and the decode kernel (t <= DECODE_MAX_T) in
# place
# ---------------------------------------------------------------------------

RWKV = [(1, 2, 37, 8, False), (2, 3, 20, 16, True), (3, 4, 1, 32, True),
        (2, 5, 64, 64, True), (1, 2, 29, 128, True), (2, 2, 13, 80, False),
        (1, 3, 9, 3, True)]
# the sub-chunk's edges at the rwkv6-7b head width
RWKV += [(2, 3, t, 64, s) for t in (1, 15, 16, 17, 45) for s in (False, True)]


def rwkv_inputs(dev, seed, n, h, t, d, dtype, with_state, w_range=None):
    r, k, v, w, u, s0 = randn(dev, seed, *[(n, h, t, d)] * 4, (h, d),
                              (n, h, d, d), scale=0.5)
    if w_range is None:
        w = w * 0.6 - 1.0
    else:                      # uniform in [lo, hi]
        lo, hi = w_range
        w = lo + (hi - lo) * torch.rand(w.shape, device=dev,
                                        generator=torch.Generator(
                                            device=dev).manual_seed(seed))
    return ([a.to(dtype) for a in (r, k, v)] + [w, u]
            + [s0 if with_state else None])


def check_rwkv(args, dtype):
    """Against the sequential plain version on the same CUDA tensors:
    fp32 1e-4 of the max (sums over d and t in another order, the state
    update as one fma); bf16 output 1e-2 (one bf16 rounding of each)."""
    got, gs = ops.rwkv6_scan(*args)
    want, ws = ref.rwkv6_scan_ref(*args)
    assert got.dtype == dtype and gs.dtype == torch.float32
    assert bool(torch.isfinite(got.float()).all())
    assert bool(torch.isfinite(gs).all())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert max_err(got, want) <= tol * float(want.float().abs().max())
    assert max_err(gs, ws) <= 1e-4 * float(ws.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,t,d,with_state", RWKV)
def test_rwkv6_scan(dev, n, h, t, d, with_state, dtype):
    check_rwkv(rwkv_inputs(dev, 30 + d, n, h, t, d, dtype, with_state),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_range", [(-10.0, -10.0), (4.0, 4.0),
                                     (-10.0, 4.0)])
@pytest.mark.parametrize("t,d", [(45, 64), (17, 80), (3, 64)])
def test_rwkv6_scan_extreme_decay(dev, t, d, w_range, dtype):
    """w = -10 (dec = 1 - 4.5e-5) to w = 4 (log-decay -54.6 per token, a
    product of two underflows): finite, at the same tolerances."""
    check_rwkv(rwkv_inputs(dev, 60 + t, 2, 3, t, d, dtype, True, w_range),
               dtype)


@pytest.mark.parametrize("d", [64, 80, 3])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_rwkv6_scan_decode_in_place(dev, t, d):
    """The decode kernel's token counts: the state written over the given
    one equals a fresh one bit for bit, and both hold the tolerances."""
    from repro_torch.kernels import rwkv6_scan as kr
    assert t <= kr.DECODE_MAX_T
    args = rwkv_inputs(dev, 70 + t, 4, 8, t, d, torch.bfloat16, True)
    check_rwkv(args, torch.bfloat16)
    out, fresh = ops.rwkv6_scan(*args)
    state = args[5].clone()
    out2, same = ops.rwkv6_scan(*args[:5], state, out_state=state)
    assert same is state
    assert torch.equal(out2, out) and torch.equal(state, fresh)


def test_rwkv6_scan_state_in_place_and_batch_invariant(dev):
    """The final state written over the initial one equals a separate
    one bit for bit; each sequence alone gives the same bits as in the
    batch."""
    args = rwkv_inputs(dev, 41, 3, 4, 45, 64, torch.bfloat16, True)
    out, fresh = ops.rwkv6_scan(*args)
    state = args[5].clone()
    out2, same = ops.rwkv6_scan(*args[:5], state, out_state=state)
    assert same is state
    assert torch.equal(out2, out) and torch.equal(state, fresh)
    for i in range(3):
        one = [a[i:i + 1] for a in args[:4]] + [args[4], args[5][i:i + 1]]
        o1, s1 = ops.rwkv6_scan(*one)
        assert torch.equal(o1, out[i:i + 1]) and torch.equal(s1, fresh[i:i + 1])


def test_rwkv6_scan_counts_and_refuses(dev):
    args = rwkv_inputs(dev, 42, 1, 2, 5, 16, torch.float32, True)
    ops.reset_launch_counts()
    ops.rwkv6_scan(*args)
    ref.rwkv6_scan_ref(*args)
    assert ops.launch_counts()["rwkv6_scan"] == 1
    assert sum(ops.launch_counts().values()) == 1
    big = rwkv_inputs(dev, 43, 1, 1, 2, 136, torch.float32, False)
    with pytest.raises(ValueError):          # head dim above 128
        ops.rwkv6_scan(*big)
    with pytest.raises(TypeError):           # w must be fp32
        ops.rwkv6_scan(*args[:3], args[3].to(torch.bfloat16), *args[4:])
    with pytest.raises(ValueError):          # a CPU state on a CUDA call
        ops.rwkv6_scan(*args[:5], args[5].cpu())


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_ssm_lm_on_card_matches_cpu(dev, arch):
    """Small fp32 RWKV-6 and zamba2 models: prefill and decode steps on
    the card (rwkv6_scan; flash and decode attention in the shared block)
    against the plain CPU path, logits and state caches."""
    import dataclasses
    from repro_torch.configs import build_model, get_config, reduced_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.vae.model import map_params
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=4)
    gpu = build_model(cfg, device=dev, seed=4)
    cpu = CausalLM(cfg, device="cpu",
                   params=map_params(gpu.params, lambda t: t.cpu()))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 40))
    ops.reset_launch_counts()
    gl, gc = gpu.prefill(toks[:, :37], max_len=48)
    cl, cc = cpu.prefill(toks[:, :37], max_len=48)
    counts = ops.launch_counts()
    if arch == "rwkv6-7b":
        assert counts["rwkv6_scan"] == cfg.n_layers
    else:
        assert counts["flash_attention"] == cfg.n_layers // cfg.attn_every
    for t in range(37, 40):
        assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
        gl, gc = gpu.decode_step(gc, toks[:, t])
        cl, cc = cpu.decode_step(cc, toks[:, t])
    assert max_err(gl.cpu(), cl) <= 1e-4 * float(cl.abs().max())
    for key, want in cc["ssm"].items():
        got = gc["ssm"][key].cpu()
        assert max_err(got, want) <= 1e-4 * max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# quantized weights: bf16, and int8 codes with a per-Cout scale
# ---------------------------------------------------------------------------

QUANT = ["bfloat16", "int8"]
# Cin 4-520, Cout 8-264 and conv_out's 3; H and W multiples of neither the
# 4 x 32 tiles nor the 16 x 32 narrow one.  The tensor-core tile copies
# weights 16 bytes at a time where Cout allows: Cout 136 and 264 send
# int8 (Cout % 16) to the one-value path, 132 bf16 (Cout % 8) too, 256
# neither
QUANT_CONV_SHAPES = [(1, 5, 7, 4, 8, 2), (1, 9, 6, 8, 3, 2),
                     (2, 33, 70, 24, 136, 4), (1, 13, 37, 520, 264, 8),
                     (2, 6, 45, 128, 132, 32), (1, 37, 70, 128, 3, 32),
                     (1, 6, 45, 520, 256, 8)]


def stored(wt, weight_dtype):
    return wt.bfloat16() if weight_dtype == "bfloat16" else Q.quantize_int8(wt)


def plain_args(w):
    """(weight in its storage dtype, w_scale) for the plain versions."""
    return ops.weight_parts(w)


def rel_err(got, want):
    return max_err(got, want) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups", QUANT_CONV_SHAPES)
def test_conv3x3_quantized(dev, weight_dtype, n, h, w, cin, cout, groups):
    x, wt, b = randn(dev, 21, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wq = stored(wt * 0.1, weight_dtype)
    wp, s = plain_args(wq)
    got = ops.conv3x3(x, wq, b)
    assert rel_err(got, ref.conv3x3_ref(x, wp, b, s)) <= 2e-5


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups",
                         QUANT_CONV_SHAPES + [(2, 70, 90, 24, 264, 4)])
def test_gn_silu_conv3x3_quantized(dev, weight_dtype, n, h, w, cin, cout,
                                   groups):
    x, sc, gb, wt, b = randn(dev, 22, (n, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    wq = stored(wt * 0.1, weight_dtype)
    wp, s = plain_args(wq)
    got = ops.gn_silu_conv3x3(x, sc, gb, wq, b, groups=groups)
    want = ref.gn_silu_conv3x3_ref(x, sc, gb, wp, b, groups, w_scale=s)
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups",
                         [(1, 9, 6, 8, 3, 2), (1, 37, 70, 128, 3, 32),
                          (2, 5, 7, 520, 3, 8), (1, 8, 8, 16, 32, 4)])
def test_output_epilogue_quantized(dev, weight_dtype, n, h, w, cin, cout,
                                   groups):
    x, sc, gb, wt, b = randn(dev, 23, (n, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    wq = stored(wt * 0.1 / max(1.0, (cin / 32) ** 0.5), weight_dtype)
    wp, s = plain_args(wq)
    got = ops.output_epilogue(x, sc, gb, wq, b, groups=groups)
    want = ref.output_epilogue_ref(x, sc, gb, wp, b, groups, w_scale=s)
    assert got.dtype == torch.uint8
    assert max_err(got.int(), want.int()) <= 1
    assert 0 < float(got.float().mean()) < 255


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 4, 4, 8, 8), (2, 5, 3, 4, 16), (1, 7, 40, 12, 130),
    (1, 6, 9, 520, 264)])
def test_upsample_conv3x3_quantized(dev, weight_dtype, n, h, w, cin, cout):
    x, wt, b = randn(dev, 24, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wq = stored(wt * 0.1, weight_dtype)
    wp, s = plain_args(wq)
    got = ops.upsample_conv3x3(x, wq, b)
    assert tuple(got.shape) == (n, 2 * h, 2 * w, cout)
    assert rel_err(got, ref.upsample_conv3x3_ref(x, wp, b, s)) <= 2e-5


@pytest.mark.parametrize("n,h,w,cin,cout,groups", [(2, 33, 70, 24, 136, 4),
                                                   (1, 13, 37, 520, 264, 8)])
def test_quantized_kernels_give_the_fp32_bits(dev, n, h, w, cin, cout,
                                              groups):
    """Stored bf16 and int8 weights are exact in fp32 (and TF32): the
    quantized cases sum the same products in the same order as the fp32
    kernels on the same values, and the int8 scale is one rounded multiply
    before the bias.  In ``gn_silu_conv.cu`` the bf16/int8 case runs two
    TF32 MMAs per product where fp32 runs three; the dropped one is 0."""
    x, sc, gb, wt, b = randn(dev, 25, (n, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    zero = torch.zeros_like(b)
    wb = (wt * 0.1).bfloat16()
    assert torch.equal(ops.conv3x3(x, wb, b), ops.conv3x3(x, wb.float(), b))
    assert torch.equal(ops.gn_silu_conv3x3(x, sc, gb, wb, b, groups=groups),
                       ops.gn_silu_conv3x3(x, sc, gb, wb.float(), b,
                                           groups=groups))
    qw = Q.quantize_int8(wt * 0.1)
    assert torch.equal(ops.conv3x3(x, qw, b),
                       ops.conv3x3(x, qw.q.float(), zero) * qw.scale + b)
    assert torch.equal(
        ops.gn_silu_conv3x3(x, sc, gb, qw, b, groups=groups),
        ops.gn_silu_conv3x3(x, sc, gb, qw.q.float(), zero, groups=groups)
        * qw.scale + b)
    assert torch.equal(ops.upsample_conv3x3(x, qw, b),
                       ops.upsample_conv3x3(x, qw.q.float(), zero)
                       * qw.scale + b)


def test_quantized_launch_counted_once_per_call(dev):
    x, sc, gb, wt, b = randn(dev, 26, (1, 8, 8, 16), (16,), (16,),
                             (3, 3, 16, 16), (16,))
    ops.reset_launch_counts()
    for wq in (wt.bfloat16(), Q.quantize_int8(wt)):
        ops.conv3x3(x, wq, b)
        ops.gn_silu_conv3x3(x, sc, gb, wq, b, groups=4)
        ops.upsample_conv3x3(x, wq, b)
        ops.output_epilogue(x, sc, gb, wq, b, groups=4)
    counts = ops.launch_counts()
    for k in ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
              "output_epilogue"):
        assert counts[k] == 2
    assert sum(counts.values()) == 8


def test_wrappers_refuse_bad_quantized_weights(dev):
    x, wt, b = randn(dev, 27, (1, 8, 8, 8), (3, 3, 8, 8), (8,))
    qw = Q.quantize_int8(wt)
    with pytest.raises(ValueError):          # int8 without its scale
        ops._conv3x3.conv3x3(x, qw.q, b)
    with pytest.raises(ValueError):          # a scale with fp32 weights
        ops._conv3x3.conv3x3(x, wt, b, w_scale=qw.scale)
    with pytest.raises(ValueError):          # a scale of the wrong length
        ops._upsample_conv.upsample_conv3x3(x, qw.q, b,
                                            w_scale=qw.scale[:4])
    with pytest.raises(TypeError):           # int16 is the collapse's only
        ops._conv3x3.conv3x3(x, qw.q.to(torch.int16), b, w_scale=qw.scale)
    with pytest.raises(ValueError):          # the scale on the CPU
        ops.gn_silu_conv3x3(x, x[0, 0, 0], x[0, 0, 0],
                            ops.QuantizedWeight(qw.q, qw.scale.cpu()), b,
                            groups=4)


@pytest.mark.parametrize("weight_dtype", QUANT)
def test_quantized_demo_decode_on_card(dev, weight_dtype):
    """bf16 and snapped int8 demo decoders on the card: bucket 8
    bit-identical to batch 1, within +-1 LSB of the same weights on the
    CPU, and the gate within 1 LSB; an engine opens and reports it."""
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.vae.model import demo_vae, map_params
    gpu = demo_vae(seed=0, device=dev)
    if weight_dtype == "int8":
        Q.snap_to_grid(gpu)
    gpu.set_weight_dtype(weight_dtype)
    cpu = demo_vae(seed=0, device="cpu")
    cpu.decoder = map_params(gpu.decoder, lambda p: p.cpu())
    cpu.set_weight_dtype(weight_dtype)
    z = Q.probe_latents((8, 8, 4), 8, seed=4)
    batch = gpu.decode_u8(z).cpu()
    for i in range(8):
        assert torch.equal(batch[i:i + 1], gpu.decode_u8(z[i:i + 1]).cpu())
    assert max_err(batch.int(), cpu.decode_u8(z).int()) <= 1
    gate = Q.check_u8_gate(gpu, (1, 2, 4, 8), (8, 8, 4))
    assert max(gate.values()) <= 1
    box = LatentBox.engine(vae=gpu, device=dev, config=StoreConfig(
        n_nodes=1, cache_bytes_per_node=1e5, adaptive=False,
        weight_dtype=weight_dtype))
    box.put(0, latent=z[0].astype(np.float16))
    assert box.get(0).payload.dtype == np.uint8
    assert box.summary()["quantize_gate_lsb"] == gate


# -- conv3x3 and upsample_conv3x3 on the tensor-core tile -------------------
# Cout 32 takes the 32-wide tile with its K split over a cluster (the split
# from conv3x3.k_split: 2 for Cin 24 on 6 tiles, 8 for Cin 512 and 520 on
# a few tiles, 1 for Cin 3), Cout 40 and 136 the 128-wide tile; Cin 3 the
# one-channel halo path; H and W multiples of neither 4 nor 32
TC_RAGGED = [(2, 9, 45, 3, 32), (1, 13, 37, 24, 40), (2, 7, 70, 24, 32),
             (1, 5, 33, 512, 32), (1, 6, 40, 520, 24), (3, 11, 9, 3, 8),
             (1, 10, 66, 24, 136)]


@pytest.mark.parametrize("n,h,w,cin,cout", TC_RAGGED)
def test_conv3x3_tensor_core_ragged(dev, n, h, w, cin, cout):
    x, wt, b = randn(dev, 31, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= (9 * cin) ** -0.5
    got = ops.conv3x3(x, wt, b)
    want = ref.conv3x3_ref(x, wt, b)
    assert max_err(got, want) <= 2e-5 * max(1.0, float(want.abs().max()))
    assert torch.equal(ops.conv3x3(x, wt, b), got)     # the split's order is fixed


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout", TC_RAGGED)
def test_conv3x3_tensor_core_ragged_quantized(dev, weight_dtype, n, h, w,
                                              cin, cout):
    x, wt, b = randn(dev, 32, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wq = stored(wt * (9 * cin) ** -0.5, weight_dtype)
    wp, s = plain_args(wq)
    assert rel_err(ops.conv3x3(x, wq, b),
                   ref.conv3x3_ref(x, wp, b, s)) <= 2e-5
    assert torch.equal(ops.conv3x3(x, wq, b),
                       ops.conv3x3(x, wp.float(), torch.zeros_like(b))
                       * (1.0 if s is None else s) + b)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 5, 37, 3, 40), (2, 6, 35, 24, 136), (1, 9, 33, 520, 32),
    (1, 3, 70, 256, 256)])
def test_upsample_conv3x3_tensor_core_ragged(dev, n, h, w, cin, cout):
    x, wt, b = randn(dev, 33, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= (9 * cin) ** -0.5
    got = ops.upsample_conv3x3(x, wt, b)
    want = ref.upsample_conv3x3_ref(x, wt, b)
    assert tuple(got.shape) == (n, 2 * h, 2 * w, cout)
    assert max_err(got, want) <= 2e-5 * max(1.0, float(want.abs().max()))


# every conv3x3 and upsample_conv3x3 shape the SD3.5 VAE runs: (kernel, H,
# W, Cin, Cout)
VAE_CONVS = [("conv3x3", 64, 64, 16, 512), ("conv3x3", 512, 512, 3, 128),
             ("conv3x3", 64, 64, 512, 32), ("conv3x3", 512, 512, 128, 3),
             ("upsample_conv3x3", 64, 64, 512, 512),
             ("upsample_conv3x3", 128, 128, 512, 512),
             ("upsample_conv3x3", 256, 256, 256, 256)]


@pytest.mark.parametrize("kernel,h,w,cin,cout", VAE_CONVS)
def test_vae_convs_batch_invariant(dev, kernel, h, w, cin, cout):
    """Image i of a batch of 3 is bit-identical to that image alone (a
    batch of one 64 x 64 latent fills the SMs once over, and the 128-wide
    tile then runs sixteen warps per block where the batch runs eight)."""
    fn = getattr(ops, kernel)
    x, wt, b = randn(dev, 34, (3, h, w, cin), (3, 3, cin, cout), (cout,))
    wt *= (9 * cin) ** -0.5
    batch = fn(x, wt, b)
    for i in range(3):
        assert torch.equal(fn(x[i:i + 1], wt, b), batch[i:i + 1]), i


def test_tensor_core_convs_issue_one_device_kernel(dev):
    """conv3x3 (with and without its K split) and the upsampler's launch
    from collapsed taps are one device kernel per call, and each wrapper
    call adds one to its launch count."""
    from repro_torch.kernels import upsample_conv
    x, wt, w32, b, b32 = randn(dev, 35, (2, 16, 16, 64), (3, 3, 64, 64),
                               (3, 3, 64, 32), (64,), (32,))
    wc = ref.storage_phase_weights(wt).contiguous()
    calls = [lambda: ops.conv3x3(x, wt, b), lambda: ops.conv3x3(x, w32, b32),
             lambda: upsample_conv.upsample_conv3x3_taps(x, wc, b)]
    for call in calls:
        assert device_nodes_of(call) == [0]
        ops.reset_launch_counts()
        call()
        assert sum(ops.launch_counts().values()) == 1
    ops.reset_launch_counts()
    ops.upsample_conv3x3(x, wt, b)
    assert ops.launch_counts()["upsample_conv3x3"] == 1
    assert sum(ops.launch_counts().values()) == 1


# -- gn_silu_conv3x3 and upsample_conv3x3 on the warpgroup tile -------------
# (csrc/wg_conv_tile.cuh): one wgmma TF32 product through its operand
# layouts against the CPU, and every shape the SD3.5 VAE's decode gives
# the two kernels in every weight form against the plain versions, with
# the tile's named layout's bits equal to the default's


def tf32_rna(x):
    """fp32 -> tf32 as ``cvt.rna`` rounds (ties away from zero, 13 low bits
    cleared), on the CPU."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits & 0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def test_wgmma_tf32_product_against_cpu(dev):
    """A [64, 8] @ B [8, 128] in one wgmma m64n128k8 TF32 (A as a halo
    plane, B as a weight slot of the conv tile, both K-major): on
    TF32-exact inputs each product is exact in fp32, so the result is the
    float64 product up to the fp32 sum of eight terms."""
    from repro_torch.kernels.gn_silu_conv import wgmma_tf32_probe
    g = torch.Generator().manual_seed(61)
    a = tf32_rna(torch.randn(64, 8, generator=g))
    b = tf32_rna(torch.randn(8, 128, generator=g))
    got = wgmma_tf32_probe(a.to(dev), b.to(dev)).cpu()
    want = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    assert float((got.double() - want).abs().max()) <= 8 * 2.0 ** -23 * scale


def decode_conv_shapes():
    """(kernel, H, W, Cin, Cout) of every gn_silu_conv3x3 and
    upsample_conv3x3 call of a 512x512 decode of the SD3.5 VAE."""
    from repro_torch.kernels import autotune as at
    from repro_torch.vae.model import SD35_VAE
    return [(s["kernel"], s["h"], s["w"], s["cin"], s["cout"])
            for s in at.decode_shapes(SD35_VAE, (64, 64, 16), 1)
            if s["kernel"] in at.WG_KERNELS]


@pytest.mark.parametrize("weight_dtype", ["float32"] + QUANT)
@pytest.mark.parametrize("kernel,h,w,cin,cout", [
    ("gn_silu_conv3x3", 64, 64, 512, 512),
    ("gn_silu_conv3x3", 128, 128, 512, 512),
    ("gn_silu_conv3x3", 256, 256, 512, 256),
    ("gn_silu_conv3x3", 256, 256, 256, 256),
    ("gn_silu_conv3x3", 512, 512, 256, 128),
    ("gn_silu_conv3x3", 512, 512, 128, 128),
    ("upsample_conv3x3", 64, 64, 512, 512),
    ("upsample_conv3x3", 128, 128, 512, 512),
    ("upsample_conv3x3", 256, 256, 256, 256)])
def test_warpgroup_tile_at_every_decode_shape(dev, weight_dtype, kernel, h,
                                              w, cin, cout):
    """Each decode shape in fp32, bf16 and int8 weights (the upsampler
    from taps collapsed once, int8 codes in int16) against the plain
    version within 1e-4 of the output's max; the tile's layout by name
    (code 1) gives the default's bits, and a code it lacks raises."""
    from repro_torch.kernels import gn_silu_conv as gsc
    from repro_torch.kernels import upsample_conv as uc
    assert (kernel, h, w, cin, cout) in decode_conv_shapes()
    x, sc, gb, wt, b = randn(dev, 62, (1, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    sc = 1.0 + 0.1 * sc
    wt = wt * (9 * cin) ** -0.5
    wq, s = tuned_weight(wt, weight_dtype)
    if kernel == "gn_silu_conv3x3":
        def call(c):
            return gsc.gn_silu_conv3x3(x, sc, gb, wq, b, groups=32,
                                       w_scale=s, layout=c)
        want = ref.gn_silu_conv3x3_ref(x, sc, gb, wq, b, 32, w_scale=s)
    else:
        wc = ref.storage_phase_weights(wq).contiguous()

        def call(c):
            return uc.upsample_conv3x3_taps(x, wc, b, w_scale=s, layout=c)
        want = ref.upsample_conv3x3_phase_ref(x, wc, b, s)
    from repro_torch.kernels import autotune as at
    got = call(0)
    assert rel_err(got, want) <= 1e-4
    assert torch.equal(call(at.ROWS2), got)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        call(2)


# ---------------------------------------------------------------------------
# the GroupNorm statistics pass and the output epilogue, redesigned: the
# coalesced statistics kernel held to its CPU model bit for bit, its scalar
# path, batch invariance; the epilogue at the decode's shape per weight
# dtype
# ---------------------------------------------------------------------------

# (n, h, w, c, groups): the float4 path at cpg 4 and 16, the scalar path
# at cpg 1, 2 and 65 (C % 4 != 0), and one group wider than a block
STATS_MODEL_SHAPES = [(2, 37, 29, 128, 32), (1, 64, 48, 512, 32),
                      (2, 13, 11, 32, 32), (1, 9, 14, 16, 8),
                      (1, 7, 9, 130, 2), (1, 5, 6, 258, 1)]


@pytest.mark.parametrize("n,h,w,c,groups", STATS_MODEL_SHAPES)
def test_gn_stats_is_its_cpu_model_bit_for_bit(dev, n, h, w, c, groups):
    """``tests/test_torch_gn_stats.py`` repeats the kernel's roundings on
    the CPU; the card gives the same bits."""
    from repro_torch.kernels.gn_silu_conv import gn_stats
    from test_torch_gn_stats import inputs, stats_model
    x = inputs(40, (n, h, w, c), 30.0, scale=2.0)
    got = gn_stats(x.to(dev), groups, 1e-6).cpu()
    assert torch.equal(got, stats_model(x, groups))


@pytest.mark.parametrize("n,h,w,c,groups,misalign", [
    (2, 13, 11, 30, 15, 0), (1, 9, 14, 16, 8, 0), (2, 13, 11, 32, 32, 0),
    (1, 37, 29, 64, 8, 1), (1, 5, 6, 258, 1, 0), (1, 64, 64, 128, 32, 1)])
def test_gn_stats_scalar_path_against_float64(dev, n, h, w, c, groups,
                                              misalign):
    """C % 4 != 0, cpg = 1 and 2 (a float4 would span two groups) and an
    x that is not 16-byte aligned take the scalar path; at +300 its
    statistics keep the float64 ones as the float4 path does."""
    from repro_torch.kernels.gn_silu_conv import gn_stats
    (x,) = randn(dev, 41, (n, h, w, c))
    x = x + 300.0
    if misalign:
        buf = torch.empty(x.numel() + 1, device=dev)
        x = buf[1:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 and x.is_contiguous()
    stats = gn_stats(x, groups, 1e-6)
    x64 = x.double().reshape(n, -1, groups, c // groups)
    mean = x64.mean(dim=(1, 3))
    rstd = (x64.var(dim=(1, 3), correction=0) + 1e-6).rsqrt()
    assert max_err(stats[..., 0], mean) <= 1e-4
    assert float(((stats[..., 1].double() - rstd) / rstd).abs().max()) <= 1e-4


@pytest.mark.parametrize("h,w,c", [(64, 64, 512), (128, 128, 256),
                                   (97, 61, 128), (33, 70, 40)])
def test_gn_stats_image_alone_equals_its_row_at_bucket_8(dev, h, w, c):
    from repro_torch.kernels.gn_silu_conv import gn_stats
    (x,) = randn(dev, 42, (8, h, w, c))
    groups = 32 if c % 32 == 0 else 8
    batch = gn_stats(x, groups, 1e-6)
    for i in range(8):
        assert torch.equal(gn_stats(x[i:i + 1], groups, 1e-6),
                           batch[i:i + 1]), i


@pytest.mark.parametrize("weight_dtype", ["float32"] + QUANT)
def test_output_epilogue_at_the_decode_shape(dev, weight_dtype):
    """1 x 512 x 512 x 128 -> 3, the uint8 decode's last call: within +-1
    LSB of the plain version per weight dtype, and image i of a batch of
    two bit-identical to that image alone."""
    x, sc, gb, wt, b = randn(dev, 43, (2, 512, 512, 128), (128,), (128,),
                             (3, 3, 128, 3), (3,))
    sc = 1.0 + 0.1 * sc
    gb = 0.1 * gb
    wt = wt * 0.35 * (9 * 128) ** -0.5
    wq = wt if weight_dtype == "float32" else stored(wt, weight_dtype)
    wp, s = plain_args(wq)
    got = ops.output_epilogue(x[:1], sc, gb, wq, b)
    want = ref.output_epilogue_ref(x[:1], sc, gb, wp, b, 32, w_scale=s)
    assert got.dtype == torch.uint8 and got.shape == (1, 512, 512, 3)
    assert max_err(got.int(), want.int()) <= 1
    assert 16 < float(got.float().mean()) < 240
    batch = ops.output_epilogue(x, sc, gb, wq, b)
    assert torch.equal(batch[:1], got)
    assert torch.equal(batch[1:], ops.output_epilogue(x[1:], sc, gb, wq, b))


def test_gn_kernels_count_one_launch_per_call_and_issue_three(dev):
    """Each GN wrapper call adds one to its own count; output_epilogue and
    group_norm_silu are three device kernels a call (the statistics'
    partial pass and merge, then the kernel itself)."""
    x, sc, gb, wt, b = randn(dev, 44, (2, 16, 32, 64), (64,), (64,),
                             (3, 3, 64, 3), (3,))
    calls = {"output_epilogue": lambda: ops.output_epilogue(x, sc, gb, wt, b),
             "group_norm_silu": lambda: ops.group_norm_silu(x, sc, gb),
             "gn_silu_conv3x3": lambda: ops.gn_silu_conv3x3(x, sc, gb, wt,
                                                            b)}
    for name, call in calls.items():
        ops.reset_launch_counts()
        call()
        call()
        assert ops.launch_counts()[name] == 2
        assert sum(ops.launch_counts().values()) == 2
    for name in ("output_epilogue", "group_norm_silu"):
        assert device_nodes_of(calls[name]) == [0, 0, 0], name


# ---------------------------------------------------------------------------
# the autotuner's launches (kernels/autotune.py): every tile layout of the
# tensor-core conv and every epilogue height gives layout 0's bits, at
# ragged shapes, for every weight dtype and both of the upsampler's forms;
# a code the kernel lacks raises
# ---------------------------------------------------------------------------

# H and W multiples of neither the 4 x 32 conv tile nor the 16 x 32 and
# 8 x 32 epilogue tiles; Cin 3 (one value at a time: no 64-wide layout, no
# 8-row epilogue) and 20; Cout 64, 96 and 520 (int8 at 520 is not
# vectorised either); the grids span both sides of the rule's 132 blocks
TUNE_SHAPES = [(n, h, w, cin, cout) for n, h, w in ((1, 13, 37), (3, 21, 70))
               for cin in (3, 20) for cout in (64, 96, 520)]
LAYOUT_CODES = (1, 2, 3)


def tuned_weight(wt, weight_dtype):
    """(the weight in its storage dtype, its w_scale or None)."""
    if weight_dtype == "float32":
        return wt, None
    return plain_args(stored(wt, weight_dtype))


def layouts_hold(call, kernel, spec, weight_dtype, codes, knob="layout",
                 named=()):
    """Each code that ``candidates`` lists, and each of ``named`` (a name
    of a listed launch), gives code 0's bits; each other code raises (the
    kernel lacks it for this shape)."""
    from repro_torch.kernels import autotune as at
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    listed = {c[knob] for c in at.candidates(kernel, spec, sms,
                                             weight_dtype)}
    base = call(0)
    for code in codes:
        if code in listed or code in named:
            assert torch.equal(call(code), base), (kernel, code)
        else:
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                call(code)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        call(7)                                   # no such code
    return listed


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,h,w,cin,cout", TUNE_SHAPES)
def test_tile_layouts_give_layout_0_bits(dev, weight_dtype, n, h, w, cin,
                                         cout):
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import conv3x3 as c3
    from repro_torch.kernels import gn_silu_conv as gsc
    from repro_torch.kernels import upsample_conv as uc
    groups = 1 if cin == 3 else 4
    x, sc, gb, wt, b = randn(dev, 41, (n, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    wq, s = tuned_weight(wt * (9 * cin) ** -0.5, weight_dtype)
    wc = ref.storage_phase_weights(wq).contiguous()
    spec = {"n": n, "h": h, "w": w, "cin": cin, "cout": cout}
    calls = {
        "conv3x3": lambda c: c3.conv3x3(x, wq, b, w_scale=s, layout=c),
        "gn_silu_conv3x3": lambda c: gsc.gn_silu_conv3x3(
            x, sc, gb, wq, b, groups=groups, w_scale=s, layout=c),
        "upsample_conv3x3": lambda c: uc.upsample_conv3x3(
            x, wq, b, w_scale=s, layout=c)}
    # the warpgroup tile has one layout, code 0, also named code 1
    wg_named = (at.ROWS2,)
    for kernel, call in calls.items():
        listed = layouts_hold(call, kernel, dict(spec, kernel=kernel),
                              weight_dtype, LAYOUT_CODES,
                              named=wg_named if kernel in at.WG_KERNELS
                              else ())
        if kernel == "conv3x3":
            assert {1, 2} <= listed              # both 128-wide layouts
            assert (3 in listed) == (cin % 4 == 0 and not (
                weight_dtype == "int8" and cout % 16))
        else:
            assert listed == {at.RULE}
    # the launch from collapsed taps takes the same codes
    layouts_hold(lambda c: uc.upsample_conv3x3_taps(x, wc, b, w_scale=s,
                                                    layout=c),
                 "upsample_conv3x3", dict(spec, kernel="upsample_conv3x3"),
                 weight_dtype, LAYOUT_CODES, named=wg_named)


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 13, 37, 3, 3),
                                            (2, 21, 70, 20, 3),
                                            (1, 37, 70, 128, 3),
                                            (2, 9, 45, 20, 5)])
def test_epilogue_heights_give_the_default_bits(dev, weight_dtype, n, h, w,
                                                cin, cout):
    from repro_torch.kernels import output_epilogue as oe
    groups = 1 if cin == 3 else 4
    x, sc, gb, wt, b = randn(dev, 42, (n, h, w, cin), (cin,), (cin,),
                             (3, 3, cin, cout), (cout,))
    wq, s = tuned_weight(wt * 0.1 / max(1.0, (cin / 32) ** 0.5),
                         weight_dtype)
    listed = layouts_hold(
        lambda th: oe.output_epilogue(x, sc, gb, wq, b, groups=groups,
                                      w_scale=s, tile_h=th),
        "output_epilogue", {"kernel": "output_epilogue", "n": n, "h": h,
                            "w": w, "cin": cin, "cout": cout},
        weight_dtype, (16, 8, 32), knob="tile_h")
    assert listed == ({16, 8} if cin % 4 == 0 else {16})


def test_single_layout_routes_refuse_other_codes(dev):
    """conv3x3's 32-wide tile (4 < Cout <= 32) and the CUDA-core tiles
    (Cout <= 4) have one launch: any other code raises."""
    from repro_torch.kernels import conv3x3 as c3
    from repro_torch.kernels import gn_silu_conv as gsc
    x, sc, gb, w32, w3, b32, b3 = randn(dev, 43, (1, 9, 40, 16), (16,),
                                        (16,), (3, 3, 16, 32), (3, 3, 16, 3),
                                        (32,), (3,))
    for call in (lambda c: c3.conv3x3(x, w32, b32, layout=c),
                 lambda c: c3.conv3x3(x, w3, b3, layout=c),
                 lambda c: gsc.gn_silu_conv3x3(x, sc, gb, w3, b3, groups=4,
                                               layout=c)):
        call(0)
        for code in LAYOUT_CODES:
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                call(code)


def test_wrappers_launch_the_active_cache_layout(dev, tmp_path):
    """With a tuning cache active, a wrapper launches the entry's layout
    (a code the shape lacks then raises, so the lookup is seen to reach
    the launch) and gives the default's bits; a miss runs the default."""
    from repro_torch.kernels import autotune as at
    x, sc, gb, wt, b = randn(dev, 44, (1, 9, 40, 6), (6,), (6,),
                             (3, 3, 6, 64), (64,))
    base = ops.conv3x3(x, wt, b)
    cache = at.TuningCache(None)
    key = at.cache_key("conv3x3", 1, 9, 40, 6, 64, "float32")
    with at.active_cache(cache):
        cache.put(key, {"layout": at.WIDE8})
        assert torch.equal(ops.conv3x3(x, wt, b), base)
        cache.put(key, {"layout": at.HALF8})     # Cin 6: not compiled
        with pytest.raises(RuntimeError, match="layout 3"):
            ops.conv3x3(x, wt, b)
        cache.put(key, {"rows": 8, "block_cout": 32})   # not this package's
        assert torch.equal(ops.conv3x3(x, wt, b), base)
    # the warpgroup tile of the fused GN conv: its layout by name gives the
    # default's bits; the mma.sync tile's code 3 is none of its codes, so
    # the entry is not read
    gbase = ops.gn_silu_conv3x3(x, sc, gb, wt, b, groups=2)
    key = at.cache_key("gn_silu_conv3x3", 1, 9, 40, 6, 64, "float32")
    with at.active_cache(cache):
        cache.put(key, {"layout": at.ROWS2})
        assert torch.equal(ops.gn_silu_conv3x3(x, sc, gb, wt, b, groups=2),
                           gbase)
        cache.put(key, {"layout": at.HALF8})
        assert at.tuned_params("gn_silu_conv3x3", x.shape, 64,
                               "float32") == {}
        assert torch.equal(ops.gn_silu_conv3x3(x, sc, gb, wt, b, groups=2),
                           gbase)


def test_autotuner_sweeps_on_the_card(dev, tmp_path):
    """A sweep of the demo decoder's keys on the card: every entry is the
    kernels' (impl "cuda"), its winner no slower than its default, and a
    decode under the tuned cache gives the untuned bits."""
    from repro_torch.kernels import autotune as at
    from repro_torch.vae.model import DEMO_VAE, demo_vae
    cache = at.TuningCache(str(tmp_path / at.CACHE_FILENAME))
    tuner = at.KernelAutotuner(cache, DEMO_VAE, device="cuda", reps=2)
    assert tuner.note_bucket(2, (8, 8, 4)) == 6
    while tuner.pending:
        tuner.step(2)
    assert at.TuningCache.load(cache.path).device == \
        torch.cuda.get_device_name(0)
    for e in cache.entries.values():
        assert e["impl"] == "cuda" and e["us"] <= e["default_us"]
    vae = demo_vae(seed=0, device="cuda")
    z = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (2, 8, 8, 4)).astype(np.float32)).cuda()
    untuned = vae.decode_u8(z)
    with at.active_cache(cache):
        assert torch.equal(vae.decode_u8(z), untuned)


def test_make_decode_step_on_card_matches_cpu(dev):
    """The launch layer's decode step on the card against the same step
    on the CPU, at a ragged latent, within the float decode's 1e-4."""
    from repro_torch.vae.model import DEMO_VAE, demo_vae, map_params
    from repro_torch.vae.serve import make_decode_step
    gpu = demo_vae(seed=3, device=dev)
    z = np.random.default_rng(46).standard_normal((3, 7, 9, 4)).astype(
        np.float32)
    got = make_decode_step(DEMO_VAE)(gpu.decoder, z)
    assert got.is_cuda and tuple(got.shape) == (3, 14, 18, 3)
    want = make_decode_step(DEMO_VAE, device="cpu")(
        map_params(gpu.decoder, lambda t: t.cpu()), z)
    assert max_err(got.cpu(), want) <= 1e-4


def test_serve_launcher_on_card(dev, capsys):
    """``python -m repro_torch.launch.serve`` at a tiny size on the card:
    the reference's lines, the device named, every kernel of the decode
    and the recipe put's encode launched, and the same request classes
    as the launcher on the CPU (fewer requests than the tuner's window,
    so no class depends on a measured time), each payload within +-1 LSB
    of the CPU's (recipe puts encode on each device; fp32 sums differ in
    order)."""
    from repro_torch.launch import serve
    argv = ["--objects", "6", "--requests", "40", "--res", "16"]
    ops.reset_launch_counts()
    _, got = serve.run(serve.parse_args(argv))
    launches = ops.launch_counts()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(ln.startswith("[serve] ") for ln in lines)
    assert f"on {torch.cuda.get_device_name(0)}, window=8" in lines[2]
    for k in ("conv3x3", "gn_silu_conv3x3", "flash_attention",
              "upsample_conv3x3", "output_epilogue", "group_norm_silu"):
        assert launches[k] > 0, k
    _, want = serve.run(serve.parse_args(argv + ["--device", "cpu"]))
    assert [(r.oid, r.hit_class, r.node) for r in got] == \
        [(r.oid, r.hit_class, r.node) for r in want]
    for g, w in zip(got, want):
        assert g.payload.shape == w.payload.shape == (16, 16, 3)
        assert g.payload.dtype == np.uint8
        assert np.abs(g.payload.astype(np.int16)
                      - w.payload.astype(np.int16)).max() <= 1, g.oid


# ---------------------------------------------------------------------------
# training: FlashAttention under autograd, the grad guard, a Trainer
# ---------------------------------------------------------------------------

#: ragged training shapes: GQA, windows, sq != skv, d 64 / 80 / 128
ATTENTION_GRAD = [(2, 4, 2, 70, 70, 128, True, None),
                  (1, 6, 3, 130, 130, 80, True, 33),
                  (1, 4, 4, 45, 97, 64, True, None),
                  (2, 2, 1, 100, 60, 64, False, None),
                  (1, 8, 2, 600, 600, 128, True, 257)]


def _grad_blocks(label, got, want, tol):
    """``chip_smoke.grad_block_errors``: each 128-row block of dq and
    128-key block of dk and dv within ``tol`` of its own max (a causal
    call's later rows and keys have gradients far below the first ones',
    under a tolerance of the whole gradient's max)."""
    import importlib.util
    from pathlib import Path
    import torch.nn.functional as F
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.grad_block_errors(torch, F, label, got, want, tol)


def _no_plain_backward_on_card(monkeypatch):
    """Make ``ref.flash_attention_bwd_ref`` raise on a CUDA tensor."""
    plain = ref.flash_attention_bwd_ref

    def refuse(q, *args, **kwargs):
        if q.is_cuda:
            raise AssertionError("the plain backward ran on the card")
        return plain(q, *args, **kwargs)

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", ATTENTION_GRAD)
def test_flash_attention_gradients_on_card(dev, monkeypatch, n, hq, hkv, sq,
                                           skv, d, causal, window, dtype):
    """``ops.flash_attention`` (the forward and backward kernels) against
    autograd through the plain version in fp32 on the same tensors: 1e-4
    of each gradient's max in fp32 (3xTF32 against TF32 off), 2e-2 in
    bf16 (bf16 inputs and gradients; the kernel's P in bf16 before P V,
    which the backward's row sums read; P and dS in bf16 before the
    backward's products), of the whole gradient and of each 128-row or
    128-key block.  The backward launches its kernels once, and the plain
    backward never runs on the card."""
    _no_plain_backward_on_card(monkeypatch)
    q, k, v, do = (a.to(dtype) for a in randn(
        dev, 61, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d),
        (n, hq, sq, d)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None
    assert ops.launch_counts()["flash_attention"] == before + 1
    before_bwd = ops.launch_counts()["flash_attention_bwd"]
    got = torch.autograd.grad(out, leaves, do)
    assert ops.launch_counts()["flash_attention_bwd"] == before_bwd + 1
    plain = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(
        *plain, causal=causal, window=window), plain, do.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert max_err(g.float(), w) <= tol * float(w.abs().max())
    _grad_blocks("autograd", got, want, tol)


def _backward_inputs(dev, dtype, n, hq, hkv, sq, skv, d, causal, window,
                     seed=62):
    """q, k, v, dO in ``dtype`` and the forward kernel's output."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = (a.to(dtype) for a in randn(
        dev, seed, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d),
        (n, hq, sq, d)))
    o = fa._forward(q, k, v, causal, d ** -0.5, window)
    return q, k, v, o, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", ATTENTION_GRAD)
def test_flash_attention_backward_kernel_matches_plain(dev, n, hq, hkv, sq,
                                                       skv, d, causal,
                                                       window, dtype):
    """The backward kernels against ``ref.flash_attention_bwd_ref`` on the
    same CUDA tensors (the forward kernel's output): 1e-4 of each
    gradient's (and each 128-row or 128-key block's) max in fp32, 2e-2
    in bf16 (P and dS rounded to bf16 before the kernels' products, the
    plain version's in fp32)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, o, do = _backward_inputs(dev, dtype, n, hq, hkv, sq, skv, d,
                                      causal, window)
    got = fab.flash_attention_bwd(q, k, v, o, do, causal, d ** -0.5, window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert max_err(g.float(), w.float()) <= tol * float(
            w.float().abs().max())
    _grad_blocks("kernel vs plain", got, want, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window",
                         [ATTENTION_GRAD[0], ATTENTION_GRAD[4],
                          (2, 28, 4, 512, 512, 128, True, None)])
def test_flash_attention_backward_is_deterministic(dev, n, hq, hkv, sq, skv,
                                                   d, causal, window, dtype):
    """Two backward calls on the same tensors give the same bits: every
    sum runs in a fixed order, with no atomics (the last shape splits
    each key block's tiles over parts)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, o, do = _backward_inputs(dev, dtype, n, hq, hkv, sq, skv, d,
                                      causal, window)
    a = fab.flash_attention_bwd(q, k, v, o, do, causal, d ** -0.5, window)
    b = fab.flash_attention_bwd(q, k, v, o, do, causal, d ** -0.5, window)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_backward_rows_with_no_key(dev):
    """Causal, 200 queries over 72 keys: the first 128 rows keep no key, so
    their dq is 0 and the kernel's dk and dv are those of the other rows
    alone, within the bf16 tolerance of the plain backward."""
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, o, do = _backward_inputs(dev, torch.bfloat16, 1, 4, 2, 200, 72,
                                      64, True, None)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, o, do, True, 0.125, None)
    assert not dq[:, :, :128].float().abs().max()
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert max_err(g.float(), w.float()) <= 2e-2 * float(
            w.float().abs().max())
    _grad_blocks("no key", (dq, dk, dv), want, 2e-2)


def test_flash_attention_backward_limits(dev):
    """The backward raises ``ValueError`` naming its limit: a head dim
    above 128, one that is not a multiple of 8 in bf16 (4 in fp32), a
    q that is not 16-byte aligned."""
    from repro_torch.kernels import flash_attention_bwd as fab
    for dtype, d in ((torch.bfloat16, 136), (torch.bfloat16, 36),
                     (torch.float32, 132), (torch.float32, 6)):
        q, k, v, do = (a.to(dtype) for a in randn(
            dev, 63, (1, 2, 16, d), (1, 2, 16, d), (1, 2, 16, d),
            (1, 2, 16, d)))
        with pytest.raises(ValueError, match="head dim"):
            fab.flash_attention_bwd(q, k, v, q, do, True, 0.1, None)
    buf = randn(dev, 64, (2 * 16 * 64 + 4,))[0].bfloat16()
    q = buf[4:].view(1, 2, 16, 64)           # 8 bytes past an aligned base
    k = buf[:-4].view(1, 2, 16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fab.flash_attention_bwd(q, k, k, k, k, True, 0.1, None)


@pytest.mark.parametrize("d", [128, 112, 80, 64, 32])
def test_flash_attention_backward_probe_is_exact(dev, d):
    """One product of each form of the bf16 backward (``a b^T`` with both
    operands K-major in shared memory; ``p c`` with p from registers in
    S's accumulator layout and c MN-major) on bf16-exact inputs: every
    product and sum is exact in fp32."""
    from repro_torch.kernels import flash_attention_bwd as fab
    g = torch.Generator().manual_seed(81 + d)
    a, b, p, c = (torch.randint(-8, 9, s_, generator=g).float() / 8
                  for s_ in ((64, d), (64, d), (64, 64), (64, d)))
    s, o = fab.probe(*(t.bfloat16().to(dev) for t in (a, b, p, c)))
    assert torch.equal(s.cpu().double(), a.double() @ b.double().T)
    assert torch.equal(o.cpu().double(), p.double() @ c.double())


def test_cuda_wrappers_refuse_inputs_that_require_grad(dev):
    """Every wrapper with no backward raises before its launch when an
    input requires grad under grad mode; serving modes launch.
    ``rwkv6_scan`` has one (:class:`RWKV6Scan`): under grad it launches
    its kernel once and its output is in the graph, its backward launches
    ``rwkv6_scan_bwd`` once and the forward kernel not again, and it
    refuses to write a state in place there."""
    x, w4, s4, wt = randn(dev, 67, (1, 8, 8, 16), (3, 3, 16, 16), (16,),
                          (3, 3, 16, 3))
    q, kc = randn(dev, 68, (2, 4, 32), (2, 2, 40, 32))
    lens = torch.tensor([40, 7], device=dev, dtype=torch.int32)
    r = randn(dev, 69, (1, 2, 8, 16))[0]
    u = randn(dev, 70, (2, 16))[0]
    calls = {
        "conv3x3": lambda g: ops.conv3x3(g(x), w4),
        "gn_silu_conv3x3": lambda g: ops.gn_silu_conv3x3(
            x, g(s4), s4, w4, groups=4),
        "upsample_conv3x3": lambda g: ops.upsample_conv3x3(x, g(w4)),
        "output_epilogue": lambda g: ops.output_epilogue(g(x), s4, s4, wt,
                                                         groups=4),
        "group_norm_silu": lambda g: ops.group_norm_silu(g(x), s4, s4,
                                                         groups=4),
        "decode_attention": lambda g: ops.decode_attention(g(q), kc, kc,
                                                           lens),
    }
    for name, call in calls.items():
        before = ops.launch_counts()[name]
        with pytest.raises(NotImplementedError, match=name):
            call(lambda t: t.clone().requires_grad_(True))
        assert ops.launch_counts()[name] == before, name
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_(True))
        assert ops.launch_counts()[name] == before + 1, name
    before = ops.launch_counts()["rwkv6_scan"]
    out, _ = ops.rwkv6_scan(r, r, r.clone().requires_grad_(True), r, u)
    assert type(out.grad_fn).__name__ == "RWKV6ScanBackward"
    assert ops.launch_counts()["rwkv6_scan"] == before + 1
    before_bwd = ops.launch_counts()["rwkv6_scan_bwd"]
    out.sum().backward()
    assert ops.launch_counts()["rwkv6_scan"] == before + 1
    assert ops.launch_counts()["rwkv6_scan_bwd"] == before_bwd + 1
    s0 = torch.zeros((1, 2, 16, 16), device=dev)
    with pytest.raises(ValueError, match="out_state"):
        ops.rwkv6_scan(r.clone().requires_grad_(True), r, r, r, u, s0,
                       out_state=s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,t,d", [(2, 3, 37, 16), (1, 2, 45, 64),
                                     (2, 2, 20, 80), (1, 3, 1, 32)])
def test_rwkv6_scan_backward_at_ragged_shapes(dev, n, h, t, d, dtype):
    """``RWKV6Scan`` (the forward kernel, and the backward kernel of
    ``csrc/rwkv6_scan_bwd.cu``) at t not a multiple of 16 from a non-zero
    initial state, both outputs weighted by random cotangents: the
    gradients of r, k, v, w, u and the state against autograd through
    the sequential plain scan on the same CUDA tensors, fp32 1e-4 of each
    gradient's max |value| (sums in another order), bf16 r/k/v 2e-2
    (their gradients round to bf16)."""
    args = rwkv_inputs(dev, 90 + t, n, h, t, d, dtype, with_state=True)
    go, gs = randn(dev, 91, (n, h, t, d), (n, h, d, d))
    grads = []
    for fn in (ops.rwkv6_scan, ref.rwkv6_scan_ref):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        out, state = fn(*leaves)
        loss = (out.float() * go).sum() + (state * gs).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for i, (g, w) in enumerate(zip(*grads)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all()), i
        tol = 2e-2 if i < 3 and dtype == torch.bfloat16 else 1e-4
        assert max_err(g.float(), w.float()) <= \
            tol * float(w.float().abs().max()), i


def _no_plain_rwkv_backward_on_card(monkeypatch):
    """Make the plain RWKV-6 backwards raise on a CUDA tensor."""
    for name in ("rwkv6_scan_bwd_ref", "rwkv6_chunked_ref"):
        plain = getattr(ref, name)

        def refuse(r, *args, _plain=plain, **kwargs):
            if r.is_cuda:
                raise AssertionError("a plain backward ran on the card")
            return _plain(r, *args, **kwargs)

        monkeypatch.setattr(ref, name, refuse)


# the backward kernel at ragged shapes: t at the sub-chunk's edges and
# past them, d from 3 to 128 (d 80 and 128 take value-column tiles of 32,
# summed in a second pass), with and without an initial state
RWKV_BWD = [(2, 3, 37, 16, True), (1, 2, 45, 64, True), (2, 2, 20, 80, False),
            (1, 3, 1, 32, True), (2, 2, 17, 3, True), (1, 1, 29, 128, True),
            (2, 3, 16, 64, False), (1, 2, 64, 8, True), (1, 2, 33, 128, False)]


def rwkv_bwd_inputs(dev, seed, n, h, t, d, dtype, with_state, w_range=None):
    args = rwkv_inputs(dev, seed, n, h, t, d, dtype, with_state, w_range)
    do, ds = randn(dev, seed + 1, (n, h, t, d), (n, h, d, d))
    return args + [do.to(dtype), ds]


def check_rwkv_bwd(got, want, dtype, with_state, dw_vanishes=False):
    """The backward kernel against ``ref.rwkv6_scan_bwd_ref`` on the same
    CUDA tensors: fp32 1e-4 of each gradient's max |value| (3xTF32
    products and another order of sums; 1e-6 measured); bf16 dr, dk, dv
    1e-2 (each rounded to bf16 from its fp32 sum), dw, du and dstate0
    fp32 at 1e-4.  Where the true dw vanishes (w = 4 everywhere) both
    return the rounding of their dw carries, and dw is held to 1e-4 of
    max |dr|."""
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    assert (got[5] is None) == (not with_state)
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        if i == 5 and not with_state:
            continue
        assert g.dtype == (dtype if i < 3 else torch.float32), name
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        tol = 1e-2 if i < 3 and dtype == torch.bfloat16 else 1e-4
        scale = float((want[0] if i == 3 and dw_vanishes else w)
                      .float().abs().max())
        assert max_err(g.float(), w.float()) <= tol * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,t,d,with_state", RWKV_BWD)
def test_rwkv6_scan_bwd_kernel_against_plain(dev, n, h, t, d, with_state,
                                             dtype):
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    args = rwkv_bwd_inputs(dev, 100 + t + d, n, h, t, d, dtype, with_state)
    got = krb.rwkv6_scan_bwd(*args)
    check_rwkv_bwd(got, ref.rwkv6_scan_bwd_ref(*args), dtype, with_state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_range", [(-10.0, 4.0), (-10.0, -10.0),
                                     (4.0, 4.0)])
@pytest.mark.parametrize("t,d", [(45, 64), (37, 80)])
def test_rwkv6_scan_bwd_kernel_extreme_decay(dev, t, d, w_range, dtype):
    """w = -10 (dec = 1 - 4.5e-5) to w = 4 (a log-decay of -54.6 a token):
    finite, at the same tolerances."""
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    args = rwkv_bwd_inputs(dev, 110 + t, 2, 3, t, d, dtype, True, w_range)
    check_rwkv_bwd(krb.rwkv6_scan_bwd(*args),
                   ref.rwkv6_scan_bwd_ref(*args), dtype, True,
                   dw_vanishes=w_range == (4.0, 4.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_bwd_kernel_bit_for_bit_and_batch_invariant(dev, dtype):
    """Two calls give the same bits (no atomics), and each sequence alone
    gives the bits it has in the batch except du, which sums over the
    sequences."""
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    for d in (64, 80):
        args = rwkv_bwd_inputs(dev, 120 + d, 3, 4, 45, d, dtype, True)
        first, again = krb.rwkv6_scan_bwd(*args), krb.rwkv6_scan_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        one = krb.rwkv6_scan_bwd(*[a if a.dim() == 2 else a[1:2]
                                   for a in args])
        for i in (0, 1, 2, 3, 5):
            assert torch.equal(one[i], first[i][1:2]), i


@pytest.mark.parametrize("which", ["dout", "dstate"])
@pytest.mark.parametrize("d", [64, 80])
def test_rwkv6_scan_bwd_kernel_with_one_cotangent_none(dev, d, which):
    """A cotangent None is zero, on the kernel as on the plain version;
    through ``RWKV6Scan`` an unused final state gives None."""
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    args = rwkv_bwd_inputs(dev, 130 + d, 2, 3, 37, d, torch.float32, True)
    i = 6 if which == "dout" else 7
    none = list(args)
    none[i] = None
    zeros = list(args)
    zeros[i] = torch.zeros_like(args[i])
    got = krb.rwkv6_scan_bwd(*none)
    check_rwkv_bwd(got, ref.rwkv6_scan_bwd_ref(*none), torch.float32, True)
    assert all(torch.equal(a, b)
               for a, b in zip(got, krb.rwkv6_scan_bwd(*zeros)))


def test_rwkv6_scan_backward_launches_the_kernel_once(dev, monkeypatch):
    """On CUDA tensors ``RWKV6Scan``'s backward launches ``rwkv6_scan_bwd``
    once, the forward kernel not again, and never runs a plain backward;
    on CPU tensors it takes ``ref.rwkv6_scan_bwd_ref`` and counts no
    launch."""
    _no_plain_rwkv_backward_on_card(monkeypatch)
    args = rwkv_bwd_inputs(dev, 140, 2, 3, 37, 64, torch.bfloat16, True)
    for device in ("cuda", "cpu"):
        leaves = [a.to(device).clone().requires_grad_(True)
                  for a in args[:6]]
        out, final = ops.rwkv6_scan(*leaves)
        before = ops.launch_counts()
        got = torch.autograd.grad((out, final), leaves,
                                  (args[6].to(device), args[7].to(device)))
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        want = {k: 0 for k in after}
        if device == "cuda":
            want["rwkv6_scan_bwd"] = 1
            cuda = got
        assert launched == want, device
    for g, c in zip(got, cuda):
        assert max_err(c.float().cpu(), g.float()) <= \
            2e-2 * float(g.float().abs().max())


def test_rwkv6_scan_bwd_refuses(dev):
    """d 129 (the cotangent lives in registers up to 128), a bf16 w, a
    CPU state on a CUDA call: each raises before any launch."""
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    before = ops.launch_counts()["rwkv6_scan_bwd"]
    big = rwkv_bwd_inputs(dev, 150, 1, 1, 5, 129, torch.float32, True)
    with pytest.raises(ValueError):
        krb.rwkv6_scan_bwd(*big)
    args = rwkv_bwd_inputs(dev, 151, 1, 2, 5, 16, torch.float32, True)
    with pytest.raises(TypeError):
        krb.rwkv6_scan_bwd(*args[:3], args[3].bfloat16(), *args[4:])
    with pytest.raises(ValueError):
        krb.rwkv6_scan_bwd(*args[:5], args[5].cpu(), *args[6:])
    assert ops.launch_counts()["rwkv6_scan_bwd"] == before


def test_trainer_on_card_matches_cpu(dev, tmp_path):
    """Two microbatched steps with compression of a small fp32 model on
    the card (through ``flash_attention``, remat on) and on the CPU from
    the same weights: losses within 1e-4, launches layers x microbatches
    x 2 a step, a checkpoint that resumes."""
    import dataclasses
    from repro_torch.configs import build_model, get_config, reduced_config
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.train.optim import AdamW, AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.vae.model import map_params
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-7b")),
                              n_heads=8, n_kv_heads=2, d_model=256,
                              remat=True)
    gpu = build_model(cfg, device=dev, seed=4)
    cpu = type(gpu)(cfg, device="cpu",
                    params=map_params(gpu.params, lambda t: t.cpu()))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4))
    runs = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        tr = Trainer(model, AdamW(AdamWConfig(lr=1e-3, warmup_steps=1,
                                              eps=1e-3)), data,
                     TrainerConfig(steps=2, ckpt_every=1,
                                   ckpt_dir=str(tmp_path / name),
                                   microbatches=2, compress_grads=True))
        ops.reset_launch_counts()
        tr.run()
        runs[name] = (tr, ops.launch_counts())
    (gt, glaunch), (ct, _) = runs["cuda"], runs["cpu"]
    assert glaunch["flash_attention"] == 2 * cfg.n_layers * 2 * 2
    for a, b in zip(gt.history, ct.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    assert gt.ckpt.all_steps() == [1, 2]
    restored, step = gt.ckpt.restore({"params": gpu.params})
    assert step == 2 and restored["params"]["embed"].is_cuda
    assert torch.equal(restored["params"]["embed"], gpu.params["embed"])


# ---------------------------------------------------------------------------
# flash_attention above head dim 128 (the VAE's d = 512): the wide kernel,
# a thread block cluster of ceil(d / 128) CTAs per 64 query rows on wgmma
# ---------------------------------------------------------------------------

# ragged sq and skv (not multiples of 64 or 128); d 132, 256, 260 and 512
# (clusters of 2, 2, 3 and 4 CTAs; 132 and 260 leave a CTA's slice mostly
# zero columns); n * hq > 1 with grouped heads; causal with sq < skv and
# sq > skv (the first rows have no key and give 0), windows, and d 1024
# (a cluster of 8)
WIDE_ATTENTION = [(1, 1, 1, 200, 333, 512, False, None),
                  (2, 3, 1, 130, 257, 260, False, None),
                  (1, 4, 2, 70, 190, 132, True, None),
                  (2, 2, 2, 257, 100, 256, True, None),
                  (1, 2, 1, 300, 70, 512, True, None),
                  (1, 2, 2, 190, 190, 512, True, 100),
                  (3, 1, 1, 65, 129, 512, False, None),
                  (1, 2, 1, 100, 100, 1024, True, 30)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", WIDE_ATTENTION)
def test_flash_attention_wide(dev, n, hq, hkv, sq, skv, d, causal, window,
                              dtype):
    q, k, v = (a.to(dtype) for a in randn(
        dev, 70, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert max_err(got, want) <= tol * float(want.abs().max().float())
    if causal and sq > skv:
        # rows before the first key have none: 0, as the plain version
        assert not got[:, :, :sq - skv].float().abs().max()


def test_flash_attention_wide_batch_invariant(dev):
    """Each image of an [8, 1, 1000, 512] call bit-identical to its own
    [1, 1, 1000, 512] call: every sum of a row has one order, whatever
    shares the launch."""
    q, k, v = randn(dev, 71, *[(8, 1, 1000, 512)] * 3)
    batch = ops.flash_attention(q, k, v)
    for i in range(8):
        one = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(batch[i:i + 1], one)


def test_flash_attention_wide_counts_one_launch_per_call(dev):
    q, k, v = randn(dev, 72, *[(2, 1, 130, 512)] * 3)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2
    assert sum(counts.values()) == 2


def test_wide_attention_wgmma_layouts_against_cpu(dev):
    """One wgmma of each product of the wide kernel through its operand
    layouts, on TF32-exact inputs: P V with P from registers in the
    accumulator layout of S and V transposed with its keys permuted, and
    q k^T with q and k K-major.  Each is the float64 product up to the
    fp32 sum of eight terms."""
    from repro_torch.kernels.flash_attention import wide_probe
    g = torch.Generator().manual_seed(73)
    p, v, q, k = (tf32_rna(torch.randn(*s, generator=g))
                  for s in ((64, 8), (8, 128), (64, 8), (64, 8)))
    o, s = wide_probe(p.to(dev), v.to(dev), q.to(dev), k.to(dev))
    for got, a, b in ((o, p, v), (s, q, k.T)):
        want = a.double() @ b.double()
        scale = (a.double().abs() @ b.double().abs()).max()
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 8 * 2.0 ** -23 * scale


# ---------------------------------------------------------------------------
# flash_attention's bf16_tma route (bf16, d % 8 == 0, d <= 128, 16-byte
# aligned operands): a TMA producer warp, two consumer warpgroups of 64
# rows, 128 x 128 tiles
# ---------------------------------------------------------------------------

# the tile's edges: sq and skv of 127, 128, 129 and 257; d 64, 80, 96, 112
# and 128 (each instantiation); rep 1, 4 and 8; windows of 1, 33 and 200;
# sq > skv (rows with no key: a whole first block at 257 over 129)
TMA_ATTENTION = [(1, 4, 1, 127, 127, 128, True, None),
                 (1, 8, 1, 128, 128, 112, True, None),
                 (2, 2, 2, 129, 129, 80, True, None),
                 (1, 8, 2, 257, 257, 96, True, 200),
                 (1, 4, 4, 257, 129, 64, True, None),
                 (1, 8, 1, 127, 257, 128, True, 33),
                 (1, 4, 1, 129, 128, 112, True, 1),
                 (2, 4, 4, 128, 257, 80, False, None),
                 (1, 4, 1, 257, 127, 96, False, None),
                 (1, 2, 2, 129, 129, 64, False, 33),
                 (1, 8, 8, 257, 257, 128, True, 1)]


@pytest.mark.parametrize("n,hq,hkv,sq,skv,d,causal,window", TMA_ATTENTION)
def test_flash_attention_bf16_tma_edges(dev, n, hq, hkv, sq, skv, d, causal,
                                        window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (a.bfloat16() for a in randn(
        dev, 74, (n, hq, sq, d), (n, hkv, skv, d), (n, hkv, skv, d)))
    assert fa.route(q, k, v) == "bf16_tma"
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert max_err(got, want) <= 1e-2 * float(want.abs().max().float())
    if causal and sq > skv:
        # rows before the first key have none: 0, as the plain version
        assert not got[:, :, :sq - skv].float().abs().max()


@pytest.mark.parametrize("d", [128, 112])
def test_flash_attention_bf16_batch_invariant(dev, d):
    """Each sequence of an [8, 8, 300, d] causal call over one kv head
    bit-identical to its own [1, 8, 300, d] call: every row's sums have
    one order, whatever shares the launch."""
    q, k, v = (a.bfloat16() for a in randn(
        dev, 75, (8, 8, 300, d), (8, 1, 300, d), (8, 1, 300, d)))
    batch = ops.flash_attention(q, k, v, causal=True)
    for i in range(8):
        one = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                  causal=True)
        assert torch.equal(batch[i:i + 1], one)


def flash_kernels_run(call):
    """The device kernels whose names hold ``fa_`` that ``call()`` ran,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "fa_" in e.key}


def test_flash_attention_routes_by_shape_and_alignment(dev):
    """d 128 with 16-byte-aligned operands runs the TMA kernel; d 36 (not a
    multiple of 8) and d 128 from an 8-byte-aligned view run PR 15's
    cp.async kernel; fp32 the mma.sync one.  ``route`` names what ran, and
    each call agrees with the plain version."""
    from repro_torch.kernels import flash_attention as fa
    flat = torch.randn(3 * 4 * 130 * 128 + 4, device=dev).bfloat16()
    view = flat[4:].view(3, 4, 130, 128)        # 8 bytes past an aligned base
    assert view.data_ptr() % 16 == 8
    (x36,) = randn(dev, 76, (3, 4, 130, 36))
    (x128,) = randn(dev, 77, (3, 4, 130, 128))
    cases = [(x128.bfloat16(), "bf16_tma", "fa_bf16_tma_kernel"),
             (x36.bfloat16(), "bf16_cp_async", "fa_bf16_kernel"),
             (view, "bf16_cp_async", "fa_bf16_kernel"),
             (x128, "fp32_mma_sync", "fa_f32_kernel")]
    for x, route, kernel in cases:
        assert fa.route(x, x, x) == route
        names = flash_kernels_run(lambda: ops.flash_attention(
            x, x, x, causal=True))
        assert len(names) == 1 and kernel in next(iter(names)), names
        got = ops.flash_attention(x, x, x, causal=True)
        want = ref.flash_attention_ref(x, x, x, causal=True)
        tol = 2e-5 if x.dtype == torch.float32 else 1e-2
        assert max_err(got, want) <= tol * float(want.abs().max().float())


def test_flash_attention_counts_one_launch_on_each_route(dev):
    (x,) = randn(dev, 78, (2, 4, 70, 128))
    (y,) = randn(dev, 79, (2, 4, 70, 36))
    ops.reset_launch_counts()
    ops.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    ops.flash_attention(y.bfloat16(), y.bfloat16(), y.bfloat16(), causal=True)
    assert ops.launch_counts()["flash_attention"] == 2
    ops.flash_attention(x, x, x, causal=True)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 3
    assert sum(counts.values()) == 3


@pytest.mark.parametrize("d", [128, 112, 96, 80, 64, 32, 8])
def test_bf16_tma_layouts_against_cpu(dev, d):
    """One q k^T and one P V of the TMA kernel through its boxes, 128-byte
    swizzle and operand layouts, on bf16-exact (and so TF32-exact) inputs,
    multiples of 1/8 up to 1: every product and every sum is exact in fp32,
    so both equal the float64 products."""
    from repro_torch.kernels.flash_attention import bf16_probe
    g = torch.Generator().manual_seed(80 + d)
    q, k, p, v = (torch.randint(-8, 9, s, generator=g).float() / 8
                  for s in ((64, d), (128, d), (64, 128), (128, d)))
    s, o = bf16_probe(*(t.bfloat16().to(dev) for t in (q, k, p, v)))
    assert torch.equal(s.cpu().double(), q.double() @ k.double().T)
    assert torch.equal(o.cpu().double(), p.double() @ v.double())

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
bit, and an autoscaled engine scales on measured decode time.

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
                (1, 2, 2, 190, 190, 512, True, 100)]


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
# rep 7, rep 1 and rep 12 (two groups of 8 heads); d 32, 64, 128, 256 and
# zamba2's 80
DECODE = [(4, 28, 4, 300, 128, (300, 129, 1, 0)),
          (2, 7, 1, 1000, 64, (999, 128)),
          (3, 8, 8, 64, 32, (64, 63, 2)),
          (2, 24, 2, 257, 256, (257, 100)),
          (1, 12, 1, 130, 128, (130,)),
          (4, 32, 32, 200, 80, (200, 129, 64, 1)),
          # the serving shapes of chip_smoke.py: Qwen2-7B and zamba2-2.7b
          (4, 28, 4, 2112, 128, (2049, 2080, 1500, 7)),
          (4, 32, 32, 2112, 80, (2049, 2080, 1500, 7)),
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

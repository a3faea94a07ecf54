"""The port's Hopper kernels on the card, at small and ragged shapes that
the decoder's main path (checked by ``chip_smoke.py``) never gives them:
odd heights and widths, channel counts that fill no tile, conv_out's
three channels, ragged attention lengths.  Each kernel is held against
its plain PyTorch version on the same CUDA tensors.  Also the batch
invariance of the decode and the engine on CUDA against the CPU.

Marked ``cuda``: these skip where no NVIDIA GPU is present.  Run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  Tolerances: 2e-5 fp32, 1e-4 for the fused
GN + conv, +-1 LSB for uint8.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

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


@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
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
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q, q, causal=True)


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

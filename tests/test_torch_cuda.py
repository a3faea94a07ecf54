"""The port's Hopper kernels on the card, at small and ragged shapes that
the main paths (checked by ``chip_smoke.py``) never give them: odd
heights and widths, channel counts that fill no tile, conv_out's three
channels, the encoder's three input channels, ragged attention lengths.
Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  Also the batch invariance of the decode, the encoder and the
engine on CUDA against the CPU, and regeneration bit-exact on the card.

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
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q, q, causal=True)
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

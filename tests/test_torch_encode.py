"""The port's encoder and float decode on the CPU against the JAX
package's: the calibrated ``repro.vae.model.demo_vae(seed=0)`` bridged
into the port (decoder and encoder trees) gives ``encode_mean`` within
1e-4 of the JAX encoder (default XLA path and Pallas kernels in
interpret mode), the float ``decode`` within 1e-4, and the strided
``downsample`` within 2e-5.  Also the encoder's parameter tree and the
SD3.5-width parameter count, and the seeded init."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.vae import layers as JL
from repro.vae import model as JM
from repro_torch.vae import layers as L
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jv = JM.demo_vae(seed=0)
    dec = jax.tree_util.tree_map(np.asarray, jv.decoder)
    enc = jax.tree_util.tree_map(np.asarray, jv.encoder)
    return jv, enc, vae_from_numpy(M.DEMO_VAE, dec, enc, device="cpu")


def images(b, hw=16, seed=0):
    """Pixels in [-1, 1], as the engine hands them to the encoder."""
    r = np.random.default_rng(seed)
    return np.clip(r.standard_normal((b, hw, hw, 3)) * 0.5, -1, 1).astype(
        np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,hw", [(1, 16), (2, 16), (1, 24)])
def test_encode_mean_matches_xla(pair, b, hw):
    jv, _, tv = pair
    x = images(b, hw, seed=b + hw)
    want = np.asarray(jv.encode_mean(jnp.asarray(x)))
    got = tv.encode_mean(x)
    assert tuple(got.shape) == want.shape == (b, hw // 2, hw // 2, 4)
    close(got.numpy(), want, 1e-4)


def test_encode_matches_pallas_interpret(pair):
    _, enc, tv = pair
    x = images(2, seed=9)
    params = jax.tree_util.tree_map(jnp.asarray, enc)
    mean, logvar = JM.encode(params, jnp.asarray(x), JM.DEMO_VAE,
                             impl="pallas_interpret")
    got_mean, got_logvar = M.encode(tv.encoder, torch.from_numpy(x),
                                    tv.cfg)
    close(got_mean.numpy(), mean, 1e-4)
    close(got_logvar.numpy(), logvar, 1e-4)


def test_float_decode_matches_jax(pair):
    jv, _, tv = pair
    z = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(jv.decode(jnp.asarray(z)))
    got = tv.decode(z).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    close(got, want, 1e-4)


@pytest.mark.parametrize("n,h,w,c", [(2, 8, 8, 6), (1, 7, 9, 4),
                                     (1, 16, 10, 16), (2, 5, 5, 3)])
def test_downsample_matches_jax(n, h, w, c):
    r = np.random.default_rng(h * w)
    x = r.standard_normal((n, h, w, c)).astype(np.float32)
    p = {"conv": {"w": (r.standard_normal((3, 3, c, c)) / np.sqrt(9 * c))
                  .astype(np.float32),
                  "b": r.standard_normal(c).astype(np.float32)}}
    want = np.asarray(JL.downsample(jnp.asarray(x),
                                    jax.tree_util.tree_map(jnp.asarray, p)))
    got = L.downsample(torch.from_numpy(x), {"conv": {
        k: torch.from_numpy(v) for k, v in p["conv"].items()}}).numpy()
    assert got.shape == want.shape == (n, (h - 2) // 2 + 1,
                                       (w - 2) // 2 + 1, c)
    close(got, want, 2e-5)


def leaf_shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in leaf_shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in leaf_shapes(v, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def test_bridged_encoder_matches_port_init_structure(pair):
    _, enc, tv = pair
    init = M.init_encoder(torch.Generator().manual_seed(0), M.DEMO_VAE)
    assert leaf_shapes(init) == leaf_shapes(enc) == leaf_shapes(tv.encoder)


def test_sd35_width_encoder_parameter_count():
    init = M.init_encoder(torch.Generator().manual_seed(0), M.SD35_VAE)
    ref = jax.eval_shape(lambda k: JM.init_encoder(k, JM.SD35_VAE),
                         jax.random.PRNGKey(0))
    count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(ref))
    assert M.param_count(init) == count == 34_274_208
    assert leaf_shapes(init) == leaf_shapes(ref)
    assert tuple(init["conv_in"]["w"].shape) == (3, 3, 3, 128)
    assert tuple(init["conv_out"]["w"].shape) == (3, 3, 512, 32)


def test_seeded_init_is_deterministic():
    x = images(1, seed=4)
    a = M.VAE(M.DEMO_VAE, seed=4, device="cpu")
    b = M.VAE(M.DEMO_VAE, seed=4, device="cpu")
    c = M.VAE(M.DEMO_VAE, seed=5, device="cpu")
    np.testing.assert_array_equal(a.encode_mean(x).numpy(),
                                  b.encode_mean(x).numpy())
    assert not np.array_equal(a.encode_mean(x).numpy(),
                              c.encode_mean(x).numpy())
    # the encoder draws from its own stream: the decoder is unchanged by it
    d = M.VAE(M.DEMO_VAE, seed=4, device="cpu", with_encoder=False)
    assert d.encoder is None
    for k in ("w", "b"):
        assert torch.equal(a.decoder["conv_in"][k], d.decoder["conv_in"][k])
    with pytest.raises(ValueError, match="with_encoder"):
        d.encode_mean(x)


def test_demo_vae_builds_the_encoder():
    vae = M.demo_vae(seed=0, device="cpu")
    lat = vae.encode_mean(images(2, seed=6))
    assert tuple(lat.shape) == (2, 8, 8, 4)
    assert bool(torch.isfinite(lat).all())

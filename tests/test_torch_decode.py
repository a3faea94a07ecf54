"""The port's decoder on the CPU against the JAX package's: the calibrated
``repro.vae.model.demo_vae(seed=0)`` bridged into the port gives
``decode_u8`` within +-1 LSB at every decode bucket (against the default
XLA path, and against the Pallas kernels in interpret mode at one
bucket), and the float trunk within 1e-4.  Also the parameter tree and
count of the full SD3.5 width."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.vae import model as JM
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jv = JM.demo_vae(seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jv.decoder)
    return jv, tree, vae_from_numpy(M.DEMO_VAE, tree, device="cpu")


def latents(b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 8, 8, 4)).astype(np.float32)


def lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
def test_decode_u8_within_one_lsb(pair, bucket):
    jv, _, tv = pair
    z = latents(bucket, seed=bucket)
    want = np.asarray(jv.decode_u8(jnp.asarray(z)))
    got = tv.decode_u8(z).numpy()
    assert got.shape == want.shape == (bucket, 16, 16, 3)
    assert got.dtype == np.uint8
    assert lsb(got, want) <= 1
    assert got.std() > 5                        # calibrated, not saturated


def test_decode_u8_against_pallas_interpret(pair):
    _, tree, tv = pair
    z = latents(2, seed=11)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = JM.decode_u8(params, jnp.asarray(z), JM.DEMO_VAE,
                        impl="pallas_interpret")
    assert lsb(tv.decode_u8(z).numpy(), want) <= 1


def test_decode_trunk_float(pair):
    jv, _, tv = pair
    z = latents(2, seed=5)
    want = np.asarray(JM._decode_trunk(jv.decoder, jnp.asarray(z), jv.cfg))
    got = tv.decode_trunk(z).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def leaf_shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaf_shapes(v, f"{path}/{i}"))
        return out
    return {path: tuple(np.shape(tree))}


def test_bridged_tree_matches_port_init_structure(pair):
    jv, tree, tv = pair
    init = M.init_decoder(torch.Generator().manual_seed(0), M.DEMO_VAE)
    assert leaf_shapes(init) == leaf_shapes(tree)
    assert tv.decoder_params == JM.param_count(jv.decoder)


def test_sd35_width_parameter_count():
    init = M.init_decoder(torch.Generator().manual_seed(0), M.SD35_VAE)
    assert M.param_count(init) == 49_545_475      # ~49.5 M (paper Table 1b)
    w = init["mid"]["res1"]["conv1"]["w"]
    assert tuple(w.shape) == (3, 3, 512, 512)
    # normal / sqrt(fan_in), as the JAX initialiser
    assert abs(float(w.std()) * np.sqrt(9 * 512) - 1.0) < 0.01


def test_calibration_lands_in_display_range():
    vae = M.demo_vae(seed=3, device="cpu")
    z = M.probe_latents((8, 8, 4), 2, seed=0)
    y = vae.decode(z).numpy()
    assert abs(float(y.std()) - 0.35) < 1e-3
    img = vae.decode_u8(z).numpy()
    assert (img == 0).mean() < 0.05 and (img == 255).mean() < 0.05


def test_seeded_init_is_deterministic():
    a = M.VAE(M.DEMO_VAE, seed=4, device="cpu")
    b = M.VAE(M.DEMO_VAE, seed=4, device="cpu")
    z = latents(1)
    np.testing.assert_array_equal(a.decode_u8(z).numpy(),
                                  b.decode_u8(z).numpy())

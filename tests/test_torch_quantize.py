"""The port's quantized decoder read path on the CPU against the JAX
package's: ``quantize_int8`` codes and scales bit-equal, storage equal,
the phase collapse of stored filters bit-equal (int8 in int16, bf16 in
bf16), the four conv kernels' plain versions with bf16 weights and with
int8 weights plus ``w_scale`` against the Pallas kernels in interpret
mode, and ``decode_u8`` at each ``weight_dtype`` within +-1 LSB of the
JAX decoder's.  Then the +-1-LSB gate and the engine's open-time gate,
mirroring ``tests/test_quantize.py``.

Tolerances are those of the fp32 kernels (bf16 and int8 weights are
exact in fp32, so only the summation order differs): 2e-5, 1e-4 for the
fused GN + conv, +-1 LSB for uint8.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels.conv3x3 import conv3x3 as jconv3x3
from repro.kernels.gn_silu_conv import gn_silu_conv3x3 as jgn_conv
from repro.kernels.output_epilogue import output_epilogue as jepilogue
from repro.kernels.upsample_conv import phase_weights as jphase_weights
from repro.kernels.upsample_conv import upsample_conv3x3 as jupsample
from repro.vae import model as JM
from repro.vae import quantize as JQ
from repro_torch.kernels import ops, ref
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.vae import model as M
from repro_torch.vae import quantize as Q
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)

LATENT_HWC = (8, 8, 4)
BUCKETS = (1, 2, 4, 8)


def arrs(seed, *shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def t(a):
    return torch.from_numpy(np.asarray(a))


def lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


def stored(wt, weight_dtype):
    """(JAX weight, JAX w_scale, port weight for ``ops``) of one filter."""
    if weight_dtype == "bfloat16":
        return jnp.asarray(wt).astype(jnp.bfloat16), None, \
            t(wt).to(torch.bfloat16)
    jq = JQ.quantize_int8(jnp.asarray(wt))
    return jq.q, jq.scale, Q.quantize_int8(t(wt))


@pytest.fixture(scope="module")
def jax_demo():
    return JM.demo_vae(seed=0)


def bridged(jv, weight_dtype="float32"):
    tv = vae_from_numpy(M.DEMO_VAE,
                        jax.tree_util.tree_map(np.asarray, jv.decoder),
                        device="cpu")
    tv.set_weight_dtype(weight_dtype)
    return tv


@pytest.fixture(scope="module")
def vae_bf16():
    return M.demo_vae(seed=0, device="cpu", weight_dtype="bfloat16")


@pytest.fixture(scope="module")
def vae_int8_snapped():
    vae = M.demo_vae(seed=0, device="cpu")
    Q.snap_to_grid(vae)
    vae.set_weight_dtype("int8")
    return vae


def store_config(**kw):
    base = dict(n_nodes=1, cache_bytes_per_node=1e5, adaptive=False,
                decode_buckets=BUCKETS)
    base.update(kw)
    return StoreConfig(**base)


# ---------------------------------------------------------------------------
# array-level quantizers against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 32, 16),
                                   (3, 3, 5, 3)])
def test_quantize_int8_bit_equal_to_reference(shape):
    (w,) = arrs(1, shape)
    w[..., 1] = 0.0                               # a zero channel
    jq = JQ.quantize_int8(jnp.asarray(w))
    tq = Q.quantize_int8(t(w))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert float(tq.scale[1]) == 1.0 and int(tq.q[..., 1].abs().max()) == 0
    # per channel, the largest |code| of a nonzero channel is 127
    amax = tq.q.abs().int().amax(dim=tuple(range(len(shape) - 1)))
    assert int(amax[0]) == 127 and int(amax.max()) <= 127


def test_quantized_weight_surface():
    (w,) = arrs(2, (3, 3, 4, 8))
    qw = Q.quantize_int8(t(w))
    assert qw.shape == (3, 3, 4, 8) and qw.ndim == 4 and qw.size == 288
    assert qw.nbytes == 288 + 8 * 4
    assert ops.weight_dtype_of(qw) == "int8"
    assert ops.weight_dtype_of(t(w).bfloat16()) == "bfloat16"
    assert ops.weight_dtype_of(t(w)) == "float32"
    assert ops.weight_parts(qw)[1] is qw.scale
    assert ops.weight_parts(t(w))[1] is None
    np.testing.assert_allclose(qw.dequant().numpy(), w,
                               atol=float(qw.scale.max()) / 2 + 1e-7)


def test_grid_snap_roundtrips_exactly():
    (w,) = arrs(3, (3, 3, 4, 8))
    snapped = Q.quantize_int8(t(w)).dequant()
    again = Q.quantize_int8(snapped).dequant()
    assert torch.equal(snapped, again)


def test_unknown_weight_dtype_rejected():
    with pytest.raises(ValueError, match="weight_dtype"):
        Q.quantize_decoder({}, "int4")


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8"])
def test_decoder_storage_equals_reference(jax_demo, weight_dtype):
    want = JQ.decoder_storage(JQ.quantize_decoder(jax_demo.decoder,
                                                  weight_dtype))
    tv = bridged(jax_demo)
    got = Q.decoder_storage(Q.quantize_decoder(tv.decoder, weight_dtype))
    assert got == want
    lo, hi = {"float32": (4.0, 4.0), "bfloat16": (1.9, 2.2),
              "int8": (1.0, 1.3)}[weight_dtype]
    assert lo <= got["bytes_per_param"] <= hi


def test_float32_is_identity():
    vae = M.VAE(M.DEMO_VAE, seed=0, device="cpu", with_encoder=False)
    assert Q.quantize_decoder(vae.decoder, "float32") is vae.decoder


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int8"])
def test_phase_weights_of_stored_filter_bit_equal(weight_dtype):
    (w,) = arrs(4, (3, 3, 6, 5))
    jw, _, tw = stored(w, weight_dtype)
    if weight_dtype == "int8":
        want = np.asarray(jphase_weights(jw.astype(jnp.int16)))
        got = ref.storage_phase_weights(tw.q)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = np.asarray(jphase_weights(jw).astype(jnp.float32))
        got = ref.storage_phase_weights(tw)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the four conv kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

CONV_SHAPES = [(1, 8, 8, 16, 32, 4), (2, 5, 7, 8, 8, 2), (1, 9, 6, 8, 3, 2)]
QUANT = ["bfloat16", "int8"]


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_conv3x3(weight_dtype, n, h, w, cin, cout, groups):
    x, wt, b = arrs(11, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    jw, js, tw = stored(wt * 0.1, weight_dtype)
    want = jconv3x3(jnp.asarray(x), jw, jnp.asarray(b), rows=h,
                    interpret=True, w_scale=js)
    np.testing.assert_allclose(ops.conv3x3(t(x), tw, t(b)).numpy(),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_gn_silu_conv3x3(weight_dtype, n, h, w, cin, cout, groups):
    x, s, gb, wt, b = arrs(12, (n, h, w, cin), (cin,), (cin,),
                           (3, 3, cin, cout), (cout,))
    jw, js, tw = stored(wt * 0.1, weight_dtype)
    want = jgn_conv(jnp.asarray(x), jnp.asarray(s), jnp.asarray(gb), jw,
                    jnp.asarray(b), groups=groups, rows=h, interpret=True,
                    w_scale=js)
    got = ops.gn_silu_conv3x3(t(x), t(s), t(gb), tw, t(b), groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout,groups", CONV_SHAPES)
def test_output_epilogue_within_one_lsb(weight_dtype, n, h, w, cin, cout,
                                        groups):
    x, s, gb, wt, b = arrs(13, (n, h, w, cin), (cin,), (cin,),
                           (3, 3, cin, cout), (cout,))
    jw, js, tw = stored(wt * 0.1, weight_dtype)
    want = jepilogue(jnp.asarray(x), jnp.asarray(s), jnp.asarray(gb), jw,
                     jnp.asarray(b), groups=groups, rows=h, interpret=True,
                     w_scale=js)
    got = ops.output_epilogue(t(x), t(s), t(gb), tw, t(b), groups=groups)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert lsb(got.numpy(), want) <= 1
    assert 0 < got.float().mean() < 255


@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 4, 4, 8, 8),
                                            (2, 5, 3, 4, 16)])
def test_upsample_conv3x3(weight_dtype, n, h, w, cin, cout):
    x, wt, b = arrs(14, (n, h, w, cin), (3, 3, cin, cout), (cout,))
    jw, js, tw = stored(wt * 0.1, weight_dtype)
    want = jupsample(jnp.asarray(x), jw, jnp.asarray(b), rows=h,
                     interpret=True, w_scale=js)
    got = ops.upsample_conv3x3(t(x), tw, t(b))
    assert tuple(got.shape) == (n, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_int8_plain_is_dequant_then_fp32():
    """The scale folded into the fp32 sum matches dequantize-then-conv."""
    x, wt, b = arrs(15, (1, 6, 6, 8), (3, 3, 8, 16), (16,))
    qw = Q.quantize_int8(t(wt) * 0.1)
    got = ops.conv3x3(t(x), qw, t(b))
    want = ref.conv3x3_ref(t(x), qw.dequant(), t(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# the decoder at each weight_dtype against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", QUANT)
@pytest.mark.parametrize("bucket", [1, 4])
def test_decode_u8_within_one_lsb_of_reference(jax_demo, weight_dtype,
                                               bucket):
    jv = JM.demo_vae(seed=0)
    if weight_dtype == "int8":
        JQ.snap_to_grid(jv)
    jv.set_weight_dtype(weight_dtype)
    tv = bridged(jv, weight_dtype)
    z = Q.probe_latents(LATENT_HWC, bucket, seed=bucket)
    want = np.asarray(jv.decode_u8(jnp.asarray(z)))
    got = tv.decode_u8(z).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    assert lsb(got, want) <= 1
    assert got.std() > 5


@pytest.mark.parametrize("weight_dtype", QUANT)
def test_decode_u8_against_pallas_interpret(jax_demo, weight_dtype):
    tree = jax.tree_util.tree_map(np.asarray, jax_demo.decoder)
    params = JQ.quantize_decoder(jax.tree_util.tree_map(jnp.asarray, tree),
                                 weight_dtype)
    z = Q.probe_latents(LATENT_HWC, 2, seed=11)
    want = JM.decode_u8(params, jnp.asarray(z), JM.DEMO_VAE,
                        impl="pallas_interpret")
    tv = bridged(jax_demo, weight_dtype)
    assert lsb(tv.decode_u8(z).numpy(), want) <= 1


# ---------------------------------------------------------------------------
# the +-1-LSB gate (tests/test_quantize.py::TestGate on the port)
# ---------------------------------------------------------------------------

class TestGate:
    def test_bf16_within_one_lsb_every_bucket(self, vae_bf16):
        gate = Q.check_u8_gate(vae_bf16, BUCKETS, LATENT_HWC)
        assert set(gate) == set(BUCKETS)
        assert max(gate.values()) <= 1

    def test_snapped_int8_within_one_lsb(self, vae_int8_snapped):
        gate = Q.check_u8_gate(vae_int8_snapped, BUCKETS, LATENT_HWC)
        assert max(gate.values()) <= 1

    def test_raw_int8_random_decoder_rejected(self):
        vae = M.demo_vae(seed=0, device="cpu")
        vae.set_weight_dtype("int8")
        with pytest.raises(Q.QuantizationGateError, match="int8"):
            Q.check_u8_gate(vae, (1, 2), LATENT_HWC)

    def test_float32_override_is_the_oracle(self, vae_bf16):
        z = Q.probe_latents(LATENT_HWC, 2, seed=3)
        oracle = M.VAE(M.DEMO_VAE, device="cpu", params=vae_bf16.decoder,
                       with_encoder=False)
        want = oracle.decode_u8(z).numpy()
        got = vae_bf16.decode_u8(z, precision="float32").numpy()
        np.testing.assert_array_equal(got, want)

    def test_calibration_rederives_the_quantized_tree(self):
        vae = M.VAE(M.DEMO_VAE, seed=0, device="cpu", with_encoder=False,
                    weight_dtype="bfloat16")
        gain = M.calibrate_output_range(vae)
        assert gain != 1.0
        want = vae.decoder["conv_out"]["w"].to(torch.bfloat16)
        assert torch.equal(vae._params_for(None)["conv_out"]["w"], want)


# ---------------------------------------------------------------------------
# the engine's open-time gate (tests/test_quantize.py::TestEngineGate)
# ---------------------------------------------------------------------------

def _put_latents(box, n, rng):
    for oid in range(n):
        box.put(oid, latent=rng.standard_normal(LATENT_HWC)
                .astype(np.float16))


class TestEngineGate:
    def test_bf16_opens_and_reports_its_gate(self, vae_bf16, rng):
        box = LatentBox.engine(vae=vae_bf16, device="cpu",
                               config=store_config(weight_dtype="bfloat16"))
        _put_latents(box, 3, rng)
        assert all(r.payload.dtype == np.uint8 for r in box.get_many([0, 1]))
        s = box.summary()
        assert s["weight_dtype"] == "bfloat16"
        assert set(s["quantize_gate_lsb"]) == set(BUCKETS)
        assert max(s["quantize_gate_lsb"].values()) <= 1

    def test_snapped_int8_opens(self, vae_int8_snapped, rng):
        box = LatentBox.engine(vae=vae_int8_snapped, device="cpu",
                               config=store_config(weight_dtype="int8"))
        _put_latents(box, 2, rng)
        assert box.get(1).payload.dtype == np.uint8
        assert max(box.summary()["quantize_gate_lsb"].values()) <= 1

    @pytest.mark.parametrize("n", [3, 5])
    def test_padded_windows_match_oracle(self, vae_bf16, rng, n):
        """Windows of 3 and 5 pad buckets 4 and 8: quantized serving stays
        within +-1 LSB of the fp32 oracle on the real slots."""
        box = LatentBox.engine(vae=vae_bf16, device="cpu",
                               config=store_config(weight_dtype="bfloat16"))
        lat = [rng.standard_normal(LATENT_HWC).astype(np.float16)
               for _ in range(n)]
        for oid, z in enumerate(lat):
            box.put(oid, latent=z)
        got = box.get_many(list(range(n)))
        for r, z in zip(got, lat):
            zb = np.asarray(z, np.float32)[None]
            want = vae_bf16.decode_u8(zb, precision="float32").numpy()[0]
            assert lsb(want, r.payload) <= 1

    def test_out_of_tolerance_quantizer_rejected(self, monkeypatch):
        monkeypatch.setitem(
            Q.QUANTIZERS, "bfloat16",
            lambda params: M.map_params(
                params, lambda p: p * 0 if p.ndim >= 2 else p))
        vae = M.demo_vae(seed=0, device="cpu")
        with pytest.raises(Q.QuantizationGateError):
            LatentBox.engine(vae=vae, device="cpu",
                             config=store_config(weight_dtype="bfloat16",
                                                 decode_buckets=(1, 2)))

    def test_raw_int8_rejected_at_open(self):
        vae = M.demo_vae(seed=0, device="cpu")
        with pytest.raises(Q.QuantizationGateError):
            LatentBox.engine(vae=vae, device="cpu",
                             config=store_config(weight_dtype="int8",
                                                 decode_buckets=(1, 2)))

    def test_quantization_requires_uint8_pixels(self, vae_bf16):
        with pytest.raises(ValueError, match="uint8 fast path"):
            LatentBox.engine(vae=vae_bf16, device="cpu",
                             config=store_config(weight_dtype="bfloat16",
                                                 pixel_format="float32",
                                                 image_bytes=64e3))

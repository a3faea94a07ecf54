"""The port's engine against the JAX engine on the CPU: the same latent
corpus and request trace through ``repro.store.LatentBox.engine`` and
``repro_torch.store.LatentBox.engine(device="cpu")`` give identical
per-request (hit_class, node), identical decode/coalesce counts, and
pixels within +-1 LSB.  Also: the device default (no CUDA -> the port
refuses to run instead of carrying on on the CPU), the features this
slice leaves out, and the batcher's bucketing and single-flight."""

import numpy as np
import pytest

import jax
import torch

from repro.core.tuner import TunerConfig
from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.vae.model import demo_vae as jax_demo_vae
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig as TorchTunerConfig
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.vae import model as M
from repro_torch.vae.bridge import params_from_numpy

torch.set_num_threads(2)

N_OBJECTS = 14
N_REQUESTS = 72
WINDOW = 8
# conftest.conformance_config's cell: caches evict (2e4 B per node), the
# tuner window never fires, so classification is deterministic
CFG = dict(n_nodes=2, cache_bytes_per_node=2e4, image_bytes=768.0,
           latent_bytes=6e2, promote_threshold=2)


def torch_cfg(**kw):
    return StoreConfig(**CFG, tuner=TorchTunerConfig(window=10**9), **kw)


@pytest.fixture(scope="module")
def vaes():
    jv = jax_demo_vae(seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jv.decoder)
    return jv, M.VAE(M.DEMO_VAE, params=params_from_numpy(tree),
                     device="cpu")


def corpus():
    rng = np.random.default_rng(7)
    lat = [rng.standard_normal((8, 8, 4)).astype(np.float16)
           for _ in range(N_OBJECTS)]
    ranks = np.arange(1, N_OBJECTS + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = rng.choice(N_OBJECTS, size=N_REQUESTS, p=p / p.sum())
    return lat, [int(t) for t in trace]


def serve(box, latents, trace):
    for oid, z in enumerate(latents):
        box.put(oid, latent=z)
    sig, pixels = [], []
    for s in range(0, len(trace), WINDOW):
        for r in box.get_many(trace[s:s + WINDOW]):
            sig.append((r.hit_class, r.node))
            pixels.append(np.asarray(r.payload))
    return sig, pixels, box.summary()


@pytest.fixture(scope="module")
def both(vaes):
    jv, tv = vaes
    latents, trace = corpus()
    jbox = JaxBox.engine(vae=jv, config=JaxStoreConfig(
        **CFG, tuner=TunerConfig(window=10**9)))
    tbox = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
    return serve(jbox, latents, trace), serve(tbox, latents, trace)


class TestConformance:
    def test_hit_class_and_node_identical(self, both):
        (jsig, _, _), (tsig, _, _) = both
        assert tsig == jsig
        assert len({h for h, _ in tsig}) >= 2     # the trace exercises tiers

    def test_decode_and_coalesce_counts_identical(self, both):
        (_, _, js), (_, _, ts) = both
        for key in ("decodes", "decode_batches", "coalesced_decodes",
                    "image_hit", "latent_hit", "full_miss"):
            assert ts[key] == js[key], key
        assert ts["decodes"] > 0

    def test_pixels_within_one_lsb(self, both):
        (_, jpx, _), (_, tpx, _) = both
        for a, b in zip(jpx, tpx):
            assert a.shape == b.shape == (16, 16, 3)
            assert b.dtype == np.uint8
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


class TestLifecycle:
    def test_stat_and_delete_match_the_jax_box(self, vaes):
        jv, tv = vaes
        latents, _ = corpus()
        jbox = JaxBox.engine(vae=jv, config=JaxStoreConfig(
            **CFG, tuner=TunerConfig(window=10**9)))
        tbox = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        for box in (jbox, tbox):
            for oid, z in enumerate(latents[:4]):
                box.put(oid, latent=z)
            box.get_many([0, 1, 0, 2])
            assert box.delete(3)
        for oid in range(4):
            js, ts = jbox.stat(oid), tbox.stat(oid)
            if oid == 3:
                assert js is None and ts is None and 3 not in tbox
                continue
            for field in ("residency", "durable_bytes", "pixel_bytes",
                          "demoted", "rung", "rung_name"):
                assert getattr(ts, field) == getattr(js, field), field
            assert tbox.pixels_resident(oid) == jbox.pixels_resident(oid)


class TestDevice:
    def test_engine_defaults_to_cuda_and_refuses_without_it(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is legal")
        with pytest.raises(RuntimeError, match="CUDA"):
            LatentBox.engine()
        with pytest.raises(RuntimeError, match="CUDA"):
            M.VAE(M.DEMO_VAE)

    def test_vae_on_another_device_is_refused(self, vaes):
        _, tv = vaes
        with pytest.raises((ValueError, RuntimeError)):
            LatentBox.engine(vae=tv, device="cuda")

    def test_cpu_box_decodes_with_default_demo_vae(self):
        box = LatentBox.engine(device="cpu", config=torch_cfg())
        z = np.random.default_rng(0).standard_normal((8, 8, 4))
        box.put(1, latent=z.astype(np.float16))
        r = box.get(1)
        assert r.payload.shape == (16, 16, 3) and r.payload.dtype == np.uint8
        # a calibrated decoder stays inside the display range
        assert 0 < r.payload.mean() < 255 and r.payload.std() > 5


class TestNotPorted:
    @pytest.mark.parametrize("kw", [dict(weight_dtype="bfloat16"),
                                    dict(autotune=True),
                                    dict(autoscale=True),
                                    dict(pixel_format="float32"),
                                    dict(data_dir="unused")])
    def test_config_raises(self, vaes, kw):
        _, tv = vaes
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LatentBox.engine(vae=tv, config=torch_cfg(**kw), device="cpu")

    def test_put_without_latent_and_regeneration_raise(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            box.put(1, image=np.zeros((16, 16, 3), np.uint8))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            box.put(2, recipe=Recipe(seed=2, height=16, width=16))
        z = np.zeros((8, 8, 4), np.float16)
        box.put(3, latent=z, recipe=Recipe(seed=3, height=16, width=16))
        assert box.demote(3)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            box.get(3)


class TestBatcher:
    def test_buckets_padding_and_single_flight(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(
            decode_buckets=(1, 2, 4)), device="cpu")
        rng = np.random.default_rng(3)
        for oid in range(5):
            box.put(oid, latent=rng.standard_normal((8, 8, 4))
                    .astype(np.float16))
        res = box.get_many([0, 1, 2, 0, 3, 4, 1])
        eng = box.backend.engine
        assert eng.batcher.stats["coalesced"] == 2
        assert eng.batcher.stats["decodes"] == 5
        # 5 unique decodes with max bucket 4 -> chunks of 4 and 1
        assert eng.batcher.stats["batches"] == 2
        assert eng.batcher.stats["padded_slots"] == 0
        assert {b: [k for _, k in v] for b, v in
                eng.batcher.bucket_ms.items()} == {4: [4], 1: [1]}
        np.testing.assert_array_equal(res[0].payload, res[3].payload)

    def test_padded_bucket_matches_single_decode(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        rng = np.random.default_rng(4)
        zs = [rng.standard_normal((8, 8, 4)).astype(np.float16)
              for _ in range(3)]
        for oid, z in enumerate(zs):
            box.put(oid, latent=z)
        res = box.get_many([0, 1, 2])          # bucket 4, one padded slot
        eng = box.backend.engine
        assert eng.batcher.stats["padded_slots"] == 1
        for oid, z in enumerate(zs):
            one = eng.batcher.decode_single(z.astype(np.float32))
            served = res[oid].payload.astype(np.int16)
            assert np.abs(one.astype(np.int16) - served).max() <= 1

    def test_prewarm_runs_every_bucket(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        eng = box.backend.engine
        eng.prewarm_decode((8, 8, 4))
        assert eng.batcher._warm == {1, 2, 4, 8}
        assert eng.batcher.stats["batches"] == 0

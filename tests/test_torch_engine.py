"""The port's engine against the JAX engine on the CPU: the same latent
corpus and request trace through ``repro.store.LatentBox.engine`` and
``repro_torch.store.LatentBox.engine(device="cpu")`` give identical
per-request (hit_class, node), identical decode/coalesce counts, and
pixels within +-1 LSB.  The same holds for a write-path trace (recipe
and uint8-image puts, demotions, regenerated reads), and float32 pixels
agree within 1e-4.  Also: regeneration bit-exact within the port,
``promote``, the device default (no CUDA -> the port refuses to run
instead of carrying on on the CPU), the features still left out (a
quantized ``weight_dtype`` opens: ``tests/test_torch_quantize.py``), and
the batcher's bucketing and single-flight."""

import numpy as np
import pytest

import jax
import torch

from repro.core.regen_tier import Recipe as JaxRecipe
from repro.core.tuner import TunerConfig
from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.vae.model import demo_vae as jax_demo_vae
from repro_torch.compression.latentcodec import decompress_latent
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig as TorchTunerConfig
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

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
    return jv, vae_from_numpy(
        M.DEMO_VAE, jax.tree_util.tree_map(np.asarray, jv.decoder),
        jax.tree_util.tree_map(np.asarray, jv.encoder), device="cpu")


def jax_box(jv, **kw):
    return JaxBox.engine(vae=jv, config=JaxStoreConfig(
        **CFG, tuner=TunerConfig(window=10**9), **kw))


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
    tbox = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
    return serve(jax_box(jv), latents, trace), serve(tbox, latents, trace)


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
        jbox = jax_box(jv)
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
    @pytest.mark.parametrize("kw", [dict(autotune=True),
                                    dict(data_dir="tmp", autotune=True)])
    def test_config_raises(self, vaes, kw, tmp_path):
        """``autotune=True`` raised naming ROADMAP A 8 until the kernel
        autotuner was ported: the engine now builds it on its own device,
        its cache (under ``data_dir`` where there is one, else in memory)
        active until the box closes, and saved at the close."""
        import os
        from repro_torch.kernels import autotune as at
        _, tv = vaes
        kw = {k: str(tmp_path) if v == "tmp" else v for k, v in kw.items()}
        box = LatentBox.engine(vae=tv, config=torch_cfg(**kw), device="cpu")
        eng = box.backend.engine
        assert isinstance(eng.autotuner, at.KernelAutotuner)
        assert eng.autotuner.device == torch.device("cpu")
        assert at.get_active_cache() is eng.tuning_cache
        path = (os.path.join(str(tmp_path), at.CACHE_FILENAME)
                if "data_dir" in kw else None)
        assert eng.tuning_cache.path == path
        s = box.summary()
        assert s["tuned_kernel_keys"] == 0 and s["tuning_pending"] == 0
        box.close()
        assert at.get_active_cache() is None
        assert path is None or (os.path.exists(path) and
                                at.TuningCache.load(path).device == "cpu")

    def test_autoscale_builds_a_controller_that_scales(self, vaes):
        """``autoscale=True`` raised naming ROADMAP A 6 until A 6 ported
        engine autoscaling: the engine now builds the controller, and
        real decode time against a barely advancing clock saturates
        utilization, so it scales up."""
        from repro_torch.core.autoscale import AutoscaleConfig
        _, tv = vaes
        clock = [1_000.0]
        box = LatentBox.engine(vae=tv, device="cpu", config=torch_cfg(
            clock=lambda: clock[0], autoscale=True,
            autoscale_cfg=AutoscaleConfig(window=8, cooldown_windows=0)))
        eng = box.backend.engine
        assert eng.autoscaler is not None
        latents, _ = corpus()
        for oid, z in enumerate(latents[:8]):
            box.put(oid, latent=z)
        for _ in range(2):
            clock[0] += 1e-3
            box.get_many(list(range(8)))
        s = box.summary()
        assert s["autoscale_windows"] == 2
        assert s["scale_up_events"] >= 1 and eng.autoscaler.events


W_RECIPES = 8            # objects put by recipe (the first 3 demoted)
W_IMAGES = 4             # objects put as uint8 pixels
W_REQUESTS = 64
# The two stacks' fp32 latent means agree within ~3e-6 (absolute), so
# after the cast to fp16 an element differs where the two straddle a
# rounding edge: by one fp16 ulp, or by a few for values near 0 where an
# ulp is smaller than the fp32 difference.  Allowed: 1e-5 plus one ulp per
# element, on at most 2 % of the elements (10 of 3,072 differ here).
LATENT_ATOL = 1e-5
DIFFER_SHARE = 0.02


def write_corpus():
    rng = np.random.default_rng(17)
    images = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
              for _ in range(W_IMAGES)]
    n = W_RECIPES + W_IMAGES
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.choice(n, size=W_REQUESTS, p=p / p.sum())]
    return images, trace


def write_and_serve(box, recipe_cls, images, trace):
    """Recipe and uint8-image puts, three demotions, then the trace in
    windows; returns the per-request signature, pixels, regenerated
    flags and the blobs of the first puts."""
    store = box.backend.store
    blobs = {}
    for oid in range(W_RECIPES):
        box.put(oid, recipe=recipe_cls(seed=100 + oid, height=16, width=16,
                                       scale=0.5))
        blobs[oid] = store.get(oid)
    for i, img in enumerate(images):
        box.put(W_RECIPES + i, image=img)
        blobs[W_RECIPES + i] = store.get(W_RECIPES + i)
    for oid in range(3):
        assert box.demote(oid)
    sig, pixels, regen = [], [], []
    for s in range(0, len(trace), WINDOW):
        for r in box.get_many(trace[s:s + WINDOW]):
            sig.append((r.hit_class, r.node))
            pixels.append(np.asarray(r.payload))
            regen.append(r.regenerated)
    return sig, pixels, regen, blobs


@pytest.fixture(scope="module")
def written(vaes):
    jv, tv = vaes
    images, trace = write_corpus()
    tbox = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
    return (write_and_serve(jax_box(jv), JaxRecipe, images, trace),
            write_and_serve(tbox, Recipe, images, trace), tbox, trace)


class TestWritePath:
    def test_hit_class_and_node_identical(self, written):
        (jsig, _, jregen, _), (tsig, _, tregen, _), _, trace = written
        assert tsig == jsig
        assert tregen == jregen
        assert sum(tregen) > 0                   # regenerated reads served
        assert {h for h, _ in tsig} >= {"regen_miss", "full_miss"}

    def test_pixels_within_one_lsb(self, written):
        (_, jpx, _, _), (_, tpx, _, _), _, _ = written
        for a, b in zip(jpx, tpx):
            assert a.shape == b.shape == (16, 16, 3) and b.dtype == np.uint8
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1

    def test_latents_within_one_fp16_ulp(self, written):
        (_, _, _, jblobs), (_, _, _, tblobs), _, _ = written
        diff = total = 0
        for oid, jb in jblobs.items():
            a = np.asarray(decompress_latent(jb), np.float16)
            b = np.asarray(decompress_latent(tblobs[oid]), np.float16)
            assert a.shape == b.shape == (8, 8, 4)
            gap = np.abs(a.astype(np.float32) - b.astype(np.float32))
            ulp = np.spacing(np.abs(a)).astype(np.float32)
            assert (gap <= LATENT_ATOL + ulp).all()
            diff += int((a != b).sum())
            total += a.size
        assert diff <= DIFFER_SHARE * total

    def test_regeneration_bit_exact(self, written):
        """Every regenerated blob is the blob of the object's first put,
        byte for byte (the property that makes recipes a durability
        class)."""
        _, (_, _, _, blobs), tbox, _ = written
        store = tbox.backend.store
        for oid in range(3):
            if store.get(oid) is not None:       # read (so regenerated)
                assert store.get(oid) == blobs[oid]

    def test_regenerated_pixels_equal_the_first_read(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        box.put(5, recipe=Recipe(seed=21, height=16, width=16, scale=0.5))
        blob = box.backend.store.get(5)
        before = box.get(5)
        assert box.demote(5) and box.backend.store.get(5) is None
        after = box.get(5)
        assert after.hit_class == "regen_miss" and after.regenerated
        assert after.latency_ms["regen"] > 0
        assert box.backend.store.get(5) == blob
        np.testing.assert_array_equal(before.payload, after.payload)

    def test_promote_restores_the_durable_class(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        box.put(6, recipe=Recipe(seed=6, height=16, width=16))
        blob = box.backend.store.get(6)
        assert not box.promote(6)                # not demoted: no-op
        assert box.demote(6)
        assert box.stat(6).demoted and box.stat(6).rung_name == "recipe"
        assert box.promote(6)
        st = box.stat(6)
        assert not st.demoted and st.durable_bytes == len(blob)
        assert box.backend.store.get(6) == blob
        assert box.get(6).hit_class == "full_miss"

    def test_image_put_encodes_display_bytes(self, vaes):
        """A uint8 put stores the latent of ``pixels / 127.5 - 1``, the
        same as a float put of those values."""
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=torch_cfg(), device="cpu")
        img = np.random.default_rng(8).integers(0, 256, (16, 16, 3),
                                                dtype=np.uint8)
        box.put(1, image=img)
        box.put(2, image=img.astype(np.float32) / 127.5 - 1.0)
        store = box.backend.store
        assert store.get(1) == store.get(2)
        assert box.put(3, image=img).stored_bytes == len(store.get(3))

    def test_float32_pixels_match_the_jax_box(self, vaes):
        jv, tv = vaes
        tbox = LatentBox.engine(vae=tv, config=torch_cfg(
            pixel_format="float32"), device="cpu")
        jbox = jax_box(jv, pixel_format="float32")
        latents, trace = corpus()
        for box in (jbox, tbox):
            for oid, z in enumerate(latents[:6]):
                box.put(oid, latent=z)
        ids = [0, 1, 2, 0, 3, 4, 5, 1]
        jres, tres = jbox.get_many(ids), tbox.get_many(ids)
        for j, t in zip(jres, tres):
            assert (t.hit_class, t.node) == (j.hit_class, j.node)
            assert t.payload.dtype == np.float32
            assert t.payload.shape == (16, 16, 3)
            np.testing.assert_allclose(t.payload, np.asarray(j.payload),
                                       atol=1e-4, rtol=1e-4)
        assert tbox.summary()["pixel_format"] == "float32"


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

"""The port's engine through the serving runtime on the CPU, held to the
JAX package's engine.

* drain-mode conformance: ``serve_stream`` with
  ``RuntimeConfig.conformance()`` classifies every request of a scenario
  trace exactly as the reference engine's stream does, with pixels within
  +-1 LSB, and exactly as the port's own ``serve_window`` in windows of 8,
  with pixels bit-identical;
* a paced stream with QoS and admission on: the runtime's timeline is
  virtual, so outcomes, counters and makespan equal the reference's
  exactly, and its images stay within +-1 LSB;
* engine autoscaling (the reference's ``TestEngineAutoscale`` under an
  injected clock), and a 2-shard engine cluster with ``autoscale=True``
  whose shard count moves while every image stays the unscaled box's;
* the legacy ``EngineConfig`` (``tests/test_store_api.py``'s and
  ``tests/test_system.py``'s cases).

On the demo VAE bridged from the JAX package, at 8x8x4 latents (16x16
images).
"""

import numpy as np
import pytest

import jax
import torch

from repro.compression.latentcodec import compress_latent as jax_compress
from repro.core.latent_store import LatentStore as JaxLatentStore
from repro.core.regen_tier import Recipe as JaxRecipe
from repro.core.tuner import TunerConfig as JaxTunerConfig
from repro.serve import runtime as jax_runtime
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.trace.synth import make_trace as jax_make_trace
from repro.vae.model import demo_vae as jax_demo_vae
from repro_torch.compression.latentcodec import (compress_latent,
                                                 decompress_latent)
from repro_torch.core.autoscale import AutoscaleConfig
from repro_torch.core.latent_store import LatentStore
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig
from repro_torch.serve import runtime
from repro_torch.serve.engine import EngineConfig, ServingEngine
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.trace.synth import make_trace
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)

N_OBJECTS = 24
N_REQUESTS = 160
DEMOTED = (3, 7, 11)
# the conformance cell of tests/conftest.py
CELL = dict(n_nodes=2, cache_bytes_per_node=2e4, image_bytes=768.0,
            latent_bytes=6e2, promote_threshold=2)
# multi_tenant's 160 requests over 2 days arrive about 11 ms apart at this
# factor: past the plant's rate, so admission acts on the batch class
OVERLOAD = 1e5


@pytest.fixture(scope="module")
def vaes():
    jv = jax_demo_vae(seed=0)
    return jv, vae_from_numpy(
        M.DEMO_VAE, jax.tree_util.tree_map(np.asarray, jv.decoder),
        jax.tree_util.tree_map(np.asarray, jv.encoder), device="cpu")


def port_box(tv, shards=1, **kw):
    cfg = StoreConfig(**CELL, tuner=TunerConfig(window=10**9), **kw)
    return fill(LatentBox.engine(vae=tv, config=cfg, shards=shards,
                                 device="cpu"), Recipe)


def ref_box(jv):
    cfg = JaxStoreConfig(**CELL, tuner=JaxTunerConfig(window=10**9))
    return fill(JaxBox.engine(vae=jv, config=cfg), JaxRecipe)


def fill(box, recipe):
    """Recipe puts (so reads regenerate), a few left recipe-only."""
    for oid in range(N_OBJECTS):
        box.put(oid, recipe=recipe(seed=1000 + oid, height=16, width=16))
    for oid in DEMOTED:
        assert box.demote(oid)
    return box


def trace_kw(load_factor=1.0):
    return dict(n_objects=N_OBJECTS, n_requests=N_REQUESTS, span_days=2.0,
                seed=7, load_factor=load_factor)


def windows(box, ids):
    return [r for s in range(0, len(ids), 8)
            for r in box.get_many(ids[s:s + 8])]


def near(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and b.dtype == np.uint8
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1


@pytest.fixture(scope="module", params=["flash_crowd", "multi_tenant"])
def drained(request, vaes):
    jv, tv = vaes
    tr = make_trace(request.param, **trace_kw())
    ids = [int(o) for o in tr.object_ids]
    port = port_box(tv).serve_stream(
        tr, runtime.RuntimeConfig.conformance(keep_payloads=True))
    ref = ref_box(jv).serve_stream(
        jax_make_trace(request.param, **trace_kw()),
        jax_runtime.RuntimeConfig.conformance(keep_payloads=True))
    return ids, port, ref, windows(port_box(tv), ids)


class TestDrainConformance:
    def test_classes_equal_the_reference_engine(self, drained):
        ids, port, ref, _ = drained
        assert port.outcomes == ref.outcomes
        assert port.counters == ref.counters
        assert {h for h, _ in port.outcomes} >= {"image_hit", "full_miss",
                                                 "regen_miss"}

    def test_pixels_within_one_lsb_of_the_reference_engine(self, drained):
        ids, port, ref, _ = drained
        assert sorted(port.payloads) == sorted(ref.payloads) \
            == list(range(len(ids)))
        assert all(near(ref.payloads[k], port.payloads[k])
                   for k in port.payloads)

    def test_stream_is_the_ports_own_window_path_bit_for_bit(self, drained):
        ids, port, _, window = drained
        assert port.outcomes == [(r.hit_class, r.node) for r in window]
        for k, r in enumerate(window):
            np.testing.assert_array_equal(port.payloads[k], r.payload)


def test_paced_qos_stream_equals_the_reference_engine(vaes):
    jv, tv = vaes
    adm = dict(min_backlog=4)
    port = port_box(tv).serve_stream(
        make_trace("multi_tenant", **trace_kw(OVERLOAD)),
        runtime.RuntimeConfig(keep_payloads=True,
                              admission=runtime.AdmissionConfig(**adm)))
    ref = ref_box(jv).serve_stream(
        jax_make_trace("multi_tenant", **trace_kw(OVERLOAD)),
        jax_runtime.RuntimeConfig(keep_payloads=True,
                                  admission=jax_runtime.AdmissionConfig(**adm)))
    assert port.outcomes == ref.outcomes
    assert port.counters == ref.counters
    assert port.makespan_ms == ref.makespan_ms
    assert port.counters["shed"] + port.counters["degraded"] > 0
    assert sorted(port.payloads) == sorted(ref.payloads)
    assert all(near(ref.payloads[k], port.payloads[k])
               for k in port.payloads)


def test_stream_accepts_requests_and_serves_real_pixels(vaes):
    """``tests/test_serving_runtime.py``'s paced engine stream: explicit
    ``Request`` objects 30 ms apart, every one served with an image."""
    _, tv = vaes
    reqs = [runtime.Request(oid=k % N_OBJECTS, arrival_ms=30.0 * k, seq=k)
            for k in range(40)]
    rep = port_box(tv).serve_stream(reqs, runtime_cfg=runtime.RuntimeConfig(
        keep_payloads=True, admission=runtime.AdmissionConfig(enabled=False)))
    assert rep.counters["served"] == 40
    assert all(rep.payloads[k].shape == (16, 16, 3) for k in range(40))


# -- engine autoscaling (tests/test_autoscale.py's TestEngineAutoscale) -----

def autoscale_cfg(clock, **kw):
    return StoreConfig(
        n_nodes=2, cache_bytes_per_node=2e4, image_bytes=768.0,
        latent_bytes=6e2, promote_threshold=10**6,
        tuner=TunerConfig(window=10**9), clock=lambda: clock[0],
        autoscale=True, autoscale_cfg=AutoscaleConfig(
            window=8, cooldown_windows=0, util_high=0.5,
            max_gpus_per_node=4, **kw))


class TestEngineAutoscale:
    def test_engine_controller_scales_on_decode_occupancy(self, vaes):
        _, tv = vaes
        clock = [1_000.0]
        box = LatentBox.engine(vae=tv, config=autoscale_cfg(clock),
                               device="cpu")
        eng = box.backend.engine
        assert eng.autoscaler is not None
        for oid in range(8):
            box.put(oid, recipe=Recipe(seed=1000 + oid, height=16, width=16))
        # real decode wall time against a barely advancing clock:
        # utilization saturates, the controller grows the virtual fleet
        for _ in range(6):
            clock[0] += 1e-3
            box.get_many(list(range(8)))
        s = box.summary()
        assert s["scale_up_events"] >= 1
        assert s["autoscale_gpus_per_node"] > 1
        assert eng.gpus_per_node == s["autoscale_gpus_per_node"]
        assert s["provisioned_gpu_ms"] > 0.0

    def test_engine_disabled_builds_no_controller(self, vaes):
        _, tv = vaes
        box = LatentBox.engine(vae=tv, config=StoreConfig(**CELL),
                               device="cpu")
        assert box.backend.engine.autoscaler is None
        s = box.summary()
        assert "decode_util" in s and "scale_up_events" not in s

    def test_cache_knob_integrates_the_scaled_capacity(self, vaes):
        """A cache move changes the walk's capacity and the provisioned
        cache integral from then on (the scaled bytes, not the
        configured ones)."""
        _, tv = vaes
        clock = [1_000.0]
        box = LatentBox.engine(vae=tv, config=autoscale_cfg(
            clock, gpu_knob=False), device="cpu")
        eng = box.backend.engine
        for oid in range(8):
            box.put(oid, recipe=Recipe(seed=1000 + oid, height=16, width=16))
        clock[0] += 1e-3
        box.get_many(list(range(8)))           # one control window
        assert [e.action for e in eng.autoscaler.events] == ["cache_up"]
        scaled = eng._cache_bytes_per_node
        assert scaled == 2 * 2e4
        assert all(t.cache.capacity == scaled for t in eng.walk.caches)
        before = eng.summary()["provisioned_cache_byte_ms"]
        clock[0] += 1.0                        # one idle second
        after = eng.summary()["provisioned_cache_byte_ms"]
        assert after - before == pytest.approx(1e3 * 2 * scaled)


def test_sharded_engine_cluster_autoscales(vaes):
    """A 2-shard engine cluster with ``autoscale=True``: every shard's
    engine and the cluster build a controller; under an injected clock
    the shard count moves, and every image is the unscaled box's."""
    _, tv = vaes
    clock = [1_000.0]
    cfg = StoreConfig(**CELL, tuner=TunerConfig(window=10**9),
                      clock=lambda: clock[0], autoscale=True,
                      autoscale_cfg=AutoscaleConfig(window=16,
                                                    cooldown_windows=0))
    box = fill(LatentBox.engine(vae=tv, config=cfg, shards=2,
                                device="cpu"), Recipe)
    cluster = box.backend
    assert cluster.autoscaler is not None
    assert all(sh.backend.engine.autoscaler is not None
               for sh in cluster.shards.values())
    ids = [int(o) for o in make_trace("flash_crowd", **trace_kw()).object_ids]
    shards = []
    served = []
    for s in range(0, len(ids), 8):
        clock[0] += 1e-3
        served += box.get_many(ids[s:s + 8])
        shards.append(cluster.n_shards)
    assert len(set(shards)) > 1, shards
    s = box.summary()
    assert s["autoscale_shards"] == cluster.n_shards
    assert s["scale_up_events"] + s["scale_down_events"] >= 1
    plain = {r.oid: r.payload for r in windows(port_box(tv), ids)}
    for r in served:
        np.testing.assert_array_equal(r.payload, plain[r.oid])
    for oid in range(N_OBJECTS):
        assert box.stat(oid) is not None


# -- the legacy EngineConfig ------------------------------------------------

class TestEngineConfig:
    def test_theta_alias_raises(self):
        with pytest.raises(TypeError, match="promote_threshold"):
            EngineConfig(theta=4)

    def test_promote_threshold_drives_spillover_bound(self):
        cfg = EngineConfig(promote_threshold=7)
        assert cfg.store_config(1e3, 1e2).promote_threshold == 7

    def test_engine_config_clock_passes_through(self):
        calls = []
        cfg = EngineConfig(clock=lambda: calls.append(1) or 42.0)
        sc = cfg.store_config(16e3, 13e3)
        assert sc.now_s() == 42.0 and calls
        assert StoreConfig().now_s() > 0           # default = wall clock

    def test_engine_config_matches_the_jax_package(self):
        port = EngineConfig(n_nodes=3, promote_threshold=5)
        ref = JaxEngineConfig(n_nodes=3, promote_threshold=5)
        a, b = port.store_config(3e3, 6e2), ref.store_config(3e3, 6e2)
        for field in ("n_nodes", "cache_bytes_per_node", "alpha0", "tau",
                      "promote_threshold", "image_bytes", "latent_bytes",
                      "adaptive", "decode_buckets", "pixel_format",
                      "weight_dtype", "autotune"):
            assert getattr(a, field) == getattr(b, field), field
        assert (a.tuner.window, a.tuner.step) == (b.tuner.window,
                                                  b.tuner.step)

    def test_engine_end_to_end_matches_the_jax_engine(self, vaes):
        """``tests/test_system.py``'s engine run, with the legacy config
        and explicit sizes, on both packages."""
        jv, tv = vaes
        rng = np.random.default_rng(0)
        latents = [rng.standard_normal((8, 8, 4)).astype(np.float16)
                   for _ in range(30)]
        port_store, ref_store = LatentStore(seed=1), JaxLatentStore(seed=1)
        for oid, z in enumerate(latents):
            port_store.put(oid, compress_latent(z))
            ref_store.put(oid, jax_compress(z))
        kw = dict(n_nodes=2, cache_bytes_per_node=2e5)
        eng = ServingEngine(tv, port_store, EngineConfig(
            tuner=TunerConfig(window=50, step=0.02), **kw),
            image_bytes=3e3, latent_bytes=6e2, device="cpu")
        ref = JaxServingEngine(jv, ref_store, JaxEngineConfig(
            tuner=JaxTunerConfig(window=50, step=0.02), **kw),
            image_bytes=3e3, latent_bytes=6e2)
        ids = rng.zipf(1.4, 300) % 30
        got = [eng.get(int(oid)) for oid in ids]
        want = [ref.get(int(oid)) for oid in ids]
        assert [h for _, h in got] == [h for _, h in want]
        assert all(near(w, g) for (g, _), (w, _) in zip(got, want))
        s = eng.summary()
        assert s["total"] == 300
        assert s["image_hit"] > 0 and s["latent_hit"] > 0
        oid = int(ids[-1])
        z = decompress_latent(port_store.get(oid))
        direct = tv.decode_u8(torch.from_numpy(
            np.asarray(z, np.float32)[None]))[0].numpy()
        np.testing.assert_array_equal(eng.get(oid)[0], direct)

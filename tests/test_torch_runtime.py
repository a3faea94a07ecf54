"""The port's serving runtime, scenario traces and trace replays on the
CPU, held to the JAX package's.

``repro_torch.trace``, ``repro_torch.core.replay`` and
``repro_torch.serve.runtime`` are verbatim copies of the reference's
modules (``tests/test_torch_imports.py`` guards the text), so these
cases drive them through the port's own backends and hold every result
to the reference's exactly: the runtime runs on a simulated clock, so a
stream replay is deterministic.

* every scenario of ``list_scenarios()`` generates the same trace, and
  the same runtime requests, in both packages;
* the port's ``SimBackend.serve_stream`` gives the reference's
  ``outcomes``, ``counters``, ``makespan_ms`` and summary on every
  scenario, in drain mode (where it also classifies like the port's own
  windows of 8) and with QoS and admission on under overload; the same
  on a 2-shard simulated cluster and an autoscaled sim box;
* ``core.replay.replay_scenario``, ``sweep_static_alpha`` and
  ``core.cluster.replay_scenario`` give the reference's summaries.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import cluster as jax_cluster
from repro.core.replay import ReplayConfig as JaxReplayConfig
from repro.core.replay import replay_scenario as jax_replay_scenario
from repro.core.replay import sweep_static_alpha as jax_sweep_static_alpha
from repro.core.autoscale import AutoscaleConfig as JaxAutoscaleConfig
from repro.core.regen_tier import Recipe as JaxRecipe
from repro.core.tuner import TunerConfig as JaxTunerConfig
from repro.serve import runtime as jax_runtime
from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.trace import synth as jax_synth
from repro_torch.core import cluster
from repro_torch.core import replay
from repro_torch.core.autoscale import AutoscaleConfig
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig
from repro_torch.serve import runtime
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.trace import synth

N_OBJECTS = 24
N_REQUESTS = 240
DEMOTED = (3, 7, 11)
SCENARIOS = synth.list_scenarios()
# the conformance cell of tests/conftest.py: caches evict, the tuner
# window never fires
CELL = dict(n_nodes=8, cache_bytes_per_node=2e4, image_bytes=768.0,
            latent_bytes=6e2, promote_threshold=2)
# 240 requests over 2 days at this factor arrive about 7 ms apart: past
# the plant's rate in full buckets, so admission acts on the batch class
OVERLOAD = 1e5


def both_cfgs(autoscale=None, **kw):
    """The same cell as a port and a reference ``StoreConfig``;
    ``autoscale`` (keywords of ``AutoscaleConfig``) turns the controller
    on."""
    port = dict(kw, tuner=TunerConfig(window=10**9))
    ref = dict(kw, tuner=JaxTunerConfig(window=10**9))
    if autoscale is not None:
        port.update(autoscale=True,
                    autoscale_cfg=AutoscaleConfig(**autoscale))
        ref.update(autoscale=True,
                   autoscale_cfg=JaxAutoscaleConfig(**autoscale))
    return StoreConfig(**CELL, **port), JaxStoreConfig(**CELL, **ref)


def filled(box, recipe):
    for oid in range(N_OBJECTS):
        box.put(oid, recipe=recipe(seed=1000 + oid, height=16, width=16))
    for oid in DEMOTED:
        assert box.demote(oid)
    return box


def sim_boxes(shards=1, **kw):
    port, ref = both_cfgs(**kw)
    return (filled(LatentBox.simulated(port, shards=shards), Recipe),
            filled(JaxBox.simulated(ref, shards=shards), JaxRecipe))


def traces(scenario, load_factor=1.0):
    kw = dict(n_objects=N_OBJECTS, n_requests=N_REQUESTS, span_days=2.0,
              seed=7, load_factor=load_factor)
    return synth.make_trace(scenario, **kw), jax_synth.make_trace(scenario,
                                                                  **kw)


def runtime_cfgs(mode):
    """The same runtime configuration in both packages: ``drain`` (the
    conformance schedule) or ``qos`` (weighted-fair tenants, token
    buckets and degrade-mode admission)."""
    if mode == "drain":
        return (runtime.RuntimeConfig.conformance(),
                jax_runtime.RuntimeConfig.conformance())
    kw = dict(qos=True, tenant_weights={0: 2.0, 1: 1.0}, tenant_rate_rps=50.0)
    return (runtime.RuntimeConfig(
                admission=runtime.AdmissionConfig(min_backlog=4), **kw),
            jax_runtime.RuntimeConfig(
                admission=jax_runtime.AdmissionConfig(min_backlog=4), **kw))


def same_report(got, want):
    assert got.outcomes == want.outcomes
    assert got.counters == want.counters
    assert got.makespan_ms == want.makespan_ms
    assert got.summary() == want.summary()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_traces_equal_the_reference(scenario):
    port, ref = traces(scenario)
    for field in ("timestamps", "object_ids", "birth_time", "model_ids",
                  "slo_class"):
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert port.characterize() == ref.characterize()
    assert ([dataclasses.astuple(r) for r in runtime.requests_from_trace(port)]
            == [dataclasses.astuple(r)
                for r in jax_runtime.requests_from_trace(ref)])


@pytest.mark.parametrize("mode", ["drain", "qos"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sim_stream_equals_the_reference(scenario, mode):
    port_box, ref_box = sim_boxes()
    port_tr, ref_tr = traces(scenario, 1.0 if mode == "drain" else OVERLOAD)
    port_cfg, ref_cfg = runtime_cfgs(mode)
    got = port_box.serve_stream(port_tr, runtime_cfg=port_cfg)
    same_report(got, ref_box.serve_stream(ref_tr, runtime_cfg=ref_cfg))
    assert got.counters["served"] + got.counters["shed"] \
        + got.counters["degraded"] == len(port_tr.object_ids)
    if mode == "drain":
        # the conformance guarantee: the port's own windows of 8
        windowed, _ = sim_boxes()
        ids = [int(o) for o in port_tr.object_ids]
        sig = [(r.hit_class, r.node) for s in range(0, len(ids), 8)
               for r in windowed.get_many(ids[s:s + 8])]
        assert got.outcomes == sig


def test_overload_sheds_only_batch_work():
    """The QoS cell above does what it is there for: under overload the
    admission controller acts on batch-class requests, never on
    interactive ones."""
    port_box, _ = sim_boxes()
    port_tr, _ = traces("multi_tenant", OVERLOAD)
    rep = port_box.serve_stream(port_tr, runtime_cfg=runtime_cfgs("qos")[0])
    reqs = runtime.requests_from_trace(port_tr)
    rejected = [r for r, (o, _) in zip(reqs, rep.outcomes)
                if o in ("shed", "degraded")]
    assert rejected
    assert all(r.slo == runtime.SLO_BATCH for r in rejected)


@pytest.mark.parametrize("mode", ["drain", "qos"])
def test_sharded_sim_stream_equals_the_reference(mode):
    port_box, ref_box = sim_boxes(shards=2)
    port_tr, ref_tr = traces("multi_tenant",
                             1.0 if mode == "drain" else OVERLOAD)
    port_cfg, ref_cfg = runtime_cfgs(mode)
    same_report(port_box.serve_stream(port_tr, runtime_cfg=port_cfg),
                ref_box.serve_stream(ref_tr, runtime_cfg=ref_cfg))


def test_autoscaled_sim_stream_equals_the_reference():
    port_box, ref_box = sim_boxes(autoscale=dict(
        window=16, cooldown_windows=0, util_high=0.5, max_gpus_per_node=4))
    port_tr, ref_tr = traces("flash_crowd", OVERLOAD)
    port_cfg, ref_cfg = runtime_cfgs("qos")
    same_report(port_box.serve_stream(port_tr, runtime_cfg=port_cfg),
                ref_box.serve_stream(ref_tr, runtime_cfg=ref_cfg))
    got, want = port_box.summary(), ref_box.summary()
    # eight nodes idle most of the time: the controller gives back cache
    assert got["scale_down_events"] == want["scale_down_events"] >= 1
    for key in ("scale_up_events", "autoscale_windows",
                "autoscale_gpus_per_node", "autoscale_cache_bytes_per_node",
                "provisioned_gpu_ms", "decode_util"):
        assert got[key] == want[key], key


def test_runtime_config_from_store_equals_the_reference():
    port, ref = both_cfgs()
    kw = dict(decode_fixed_ms=1.5, decode_per_image_ms=45.0, regen_ms=51.0)
    assert (dataclasses.asdict(runtime.RuntimeConfig.from_store(port, **kw))
            == dataclasses.asdict(
                jax_runtime.RuntimeConfig.from_store(ref, **kw)))


def replay_tuple(res):
    return (res.as_dict(), [dataclasses.astuple(r) for r in res.history],
            res.window_mean_ms.tolist(), res.window_alpha.tolist())


REPLAY_KNOBS = dict(n_objects=200, n_requests=3_000, span_days=1.0, seed=0)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cache_replay_equals_the_reference(scenario):
    cfg = dict(cache_bytes=40 * 1.4e6, image_bytes=1.4e6,
               latent_bytes=0.28e6)
    got = replay.replay_scenario(scenario, replay.ReplayConfig(
        **cfg, tuner=TunerConfig(window=500, step=0.03)), **REPLAY_KNOBS)
    want = jax_replay_scenario(scenario, JaxReplayConfig(
        **cfg, tuner=JaxTunerConfig(window=500, step=0.03)), **REPLAY_KNOBS)
    assert replay_tuple(got) == replay_tuple(want)


def test_static_alpha_sweep_equals_the_reference():
    ids = synth.make_trace("zipf_drift", **REPLAY_KNOBS).object_ids
    base = dict(cache_bytes=40 * 1.4e6)
    got = replay.sweep_static_alpha(ids, (0.1, 0.5, 0.9),
                                    replay.ReplayConfig(**base))
    want = jax_sweep_static_alpha(ids, (0.1, 0.5, 0.9),
                                  JaxReplayConfig(**base))
    assert sorted(got) == sorted(want)
    for a in got:
        assert replay_tuple(got[a]) == replay_tuple(want[a])


@pytest.mark.parametrize("scenario", ["flash_crowd", "multi_tenant",
                                      "diurnal"])
def test_cluster_replay_scenario_equals_the_reference(scenario):
    knobs = dict(n_objects=150, n_requests=800, span_days=0.2, seed=1)
    cfg = dict(n_nodes=2, cache_bytes_per_node=20 * 1.4e6, adaptive=False)
    log, sim = cluster.replay_scenario(cluster.ClusterConfig(**cfg),
                                       scenario, **knobs)
    jlog, jsim = jax_cluster.replay_scenario(
        jax_cluster.ClusterConfig(**cfg), scenario, **knobs)
    assert log.summarize()["n"] == knobs["n_requests"]
    assert log.summarize() == jlog.summarize()
    assert log.slo_summary() == jlog.slo_summary()

"""The port's sharded, replicated store on the CPU, held to the JAX
package's.

``repro_torch.store.sharding`` is the reference's module with one
classmethod adapted (``ShardedLatentBox.engine`` takes ``device=``;
``tests/test_torch_imports.py`` guards the rest), so these cases drive
it through the port's own engine and simulator backends:

* the port's sharded engine box classifies every request of a shared
  trace exactly as the reference's sharded engine box does, healthy and
  with a shard killed mid-trace, with pixels within +-1 LSB;
* the port's engine and sim boxes classify identically, healthy and with
  one shard dead, and a dead shard's reads fail over to replicas with
  pixels bit-identical to the healthy box's;
* kill, restart and catch-up converge to full replication, in memory and
  on disk; hedged reads fire against a stalled shard without touching
  classification, pixels or decode counts;
* ``add_shard`` and ``remove_shard`` move only the remapped keys, and a
  persistent cluster's topology and replication survive a reopen.

Mirrors ``tests/test_resilience.py`` and ``tests/test_shard_conformance.py``
(their engine and sim cells) on the demo VAE bridged from the JAX
package, at 8x8x4 latents (16x16 images).
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

from repro.core.regen_tier import Recipe as JaxRecipe
from repro.core.tuner import TunerConfig as JaxTunerConfig
from repro.store import FaultPlan as JaxFaultPlan
from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.vae.model import demo_vae as jax_demo_vae
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.store.faults import FaultPlan
from repro_torch.store.replication import HedgeConfig
from repro_torch.store.sharding import ShardedLatentBox
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)

N_OBJECTS = 20
TRACE_LEN = 160
SHARDS = 4
DEMOTED = (3, 7, 11)
# the conformance cell of tests/conftest.py: caches evict, the tuner
# window never fires, so classes depend only on per-node request order
CELL = dict(cache_bytes_per_node=2e4, image_bytes=768.0, latent_bytes=6e2,
            promote_threshold=2)


def cfg(nodes_per_shard=2, **kw):
    return StoreConfig(n_nodes=nodes_per_shard,
                       tuner=TunerConfig(window=10**9), **CELL, **kw)


def trace(n_objects=N_OBJECTS, length=TRACE_LEN, seed=7):
    """A hot head (image tier, hedging) and a uniform tail (durable and
    regeneration paths), shuffled: ``tests/test_resilience.py``'s."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(max(1, n_objects // 4), size=length // 2)
    cold = rng.choice(n_objects, size=length - len(hot))
    seq = np.concatenate([hot, cold])
    rng.shuffle(seq)
    return [int(x) for x in seq]


def latent_of(oid):
    rng = np.random.default_rng(500 + oid)
    return rng.standard_normal((8, 8, 4)).astype(np.float16)


def fill(box, n=N_OBJECTS, demote=DEMOTED, recipe=Recipe):
    """Latent puts, with every fourth object put by recipe; the recipe
    objects in ``demote`` are left recipe-only."""
    for oid in range(n):
        if oid % 4 == 3:
            box.put(oid, recipe=recipe(seed=1000 + oid, height=16, width=16))
        else:
            box.put(oid, latent=latent_of(oid))
    for oid in demote:
        if oid < n:
            assert box.demote(oid)


def serve(box, ids, window=8):
    sig, px = [], []
    for s in range(0, len(ids), window):
        for r in box.get_many(ids[s:s + window]):
            sig.append((r.hit_class, r.node))
            px.append(None if r.payload is None else np.asarray(r.payload))
    return sig, px


@pytest.fixture(scope="module")
def vaes():
    jv = jax_demo_vae(seed=0)
    return jv, vae_from_numpy(
        M.DEMO_VAE, jax.tree_util.tree_map(np.asarray, jv.decoder),
        jax.tree_util.tree_map(np.asarray, jv.encoder), device="cpu")


def engine_box(tv, shards=SHARDS, replication=2, fault_plan=None,
               hedge=None, **kw):
    return LatentBox.engine(vae=tv, config=cfg(**kw), shards=shards,
                            replication=replication, hedge=hedge,
                            fault_plan=fault_plan, device="cpu")


def sim_box(shards=SHARDS, replication=2, fault_plan=None, hedge=None,
            **kw):
    return LatentBox.simulated(cfg(**kw), shards=shards,
                               replication=replication, hedge=hedge,
                               fault_plan=fault_plan)


FAULTS = {"healthy": None, "kill": (1, TRACE_LEN // 3)}


@pytest.fixture(scope="module")
def served(vaes):
    """Signatures and pixels of the port's engine and sim boxes and the
    reference's engine box, each healthy and with shard 1 killed."""
    jv, tv = vaes
    ids = trace()
    out = {}
    for fault, kill in FAULTS.items():
        def plan():                     # a plan is consumed as it fires
            return None if kill is None else FaultPlan.kill(*kill)
        ebox = engine_box(tv, fault_plan=plan())
        sbox = sim_box(fault_plan=plan())
        jbox = JaxBox.engine(
            vae=jv, config=JaxStoreConfig(
                n_nodes=2, tuner=JaxTunerConfig(window=10**9), **CELL),
            shards=SHARDS, replication=2,
            fault_plan=None if kill is None else JaxFaultPlan.kill(*kill))
        fill(ebox)
        fill(sbox)
        fill(jbox, recipe=JaxRecipe)
        for kind, box in (("engine", ebox), ("sim", sbox), ("jax", jbox)):
            sig, px = serve(box, ids)
            out[(kind, fault)] = (sig, px, box.summary())
    return out


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_sharded_engine_classifies_as_the_reference(served, fault):
    sig, px, summ = served[("engine", fault)]
    jsig, jpx, jsumm = served[("jax", fault)]
    assert sig == jsig
    assert len({h for h, _ in sig}) >= 3        # image, latent, durable...
    for key in ("decodes", "failovers", "under_replicated_objects"):
        assert summ[key] == jsumm[key], key
    for a, b in zip(px, jpx):
        assert a.shape == b.shape == (16, 16, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_engine_and_sim_boxes_classify_identically(served, fault):
    assert served[("engine", fault)][0] == served[("sim", fault)][0]
    # a dead shard changes availability, never a request's class
    assert served[("sim", fault)][0] == served[("sim", "healthy")][0]
    s = served[("sim", fault)][2]
    assert s["replication"] == 2
    assert s["dead_shards"] == ([] if fault == "healthy" else [1])
    assert (s["failovers"] > 0) == (fault == "kill")


def test_failover_pixels_bit_identical_to_the_healthy_box(served):
    _, healthy, _ = served[("engine", "healthy")]
    _, hurt, summ = served[("engine", "kill")]
    assert summ["failovers"] > 0 and summ["dead_shards"] == [1]
    for a, b in zip(healthy, hurt):
        np.testing.assert_array_equal(a, b)


def test_unreplicated_dead_shard_raises(vaes):
    _, tv = vaes
    box = engine_box(tv, shards=3, replication=1,
                     fault_plan=FaultPlan.kill(0, 0))
    fill(box, 9, demote=())
    owned = [oid for oid in range(9) if box.backend.shard_of(oid) == 0]
    with pytest.raises(RuntimeError, match="no replicas"):
        box.get_many(owned)


@pytest.mark.parametrize("persistent", [False, True])
def test_kill_restart_catches_up(vaes, tmp_path, persistent):
    """Shard 2 dies at request 40 and restarts at 120: every read is
    answered with the healthy box's pixels, classified as the healthy
    box does until the restart (the revived shard is cache-cold), and
    the revived shard converges to full replication and serves its own
    keys again."""
    _, tv = vaes
    ids = trace()
    plan = FaultPlan.kill_restart(2, 40, 120)
    if persistent:
        box = LatentBox.open(tmp_path / "c", vae=tv,
                             config=cfg(write_behind=True,
                                        segment_bytes=4096.0),
                             shards=SHARDS, replication=2, fault_plan=plan,
                             device="cpu")
    else:
        box = engine_box(tv, fault_plan=plan)
    healthy = engine_box(tv)
    fill(box)
    fill(healthy)
    sig, px = serve(box, ids)
    hsig, hpx = serve(healthy, ids)
    assert sig[:120] == hsig[:120]
    for a, b in zip(px, hpx):
        np.testing.assert_array_equal(a, b)
    s = box.summary()
    assert s["restarts"] == 1 and s["dead_shards"] == []
    assert s["failovers"] > 0 and s["under_replicated_objects"] == 0
    cluster = box.backend
    owned = [oid for oid in range(N_OBJECTS) if cluster.shard_of(oid) == 2]
    assert owned
    for r in box.get_many(owned):
        assert r.hit_class and not r.failover
    if persistent:
        # catch-up was delta-shipped: the next sync ships nothing
        for (f, src), holder in cluster._holders.items():
            assert holder.hwm <= cluster._source_position(src)
            assert not cluster._export_from(
                src, holder.hwm, cluster._designated.get((f, src), set()))
        box.close()


@pytest.mark.parametrize("kind", ["sim", "engine"])
def test_hedged_reads_fire_against_a_stalled_shard(vaes, kind):
    """Shard 0 stalls 400 ms from request 24: hedged reads fire and win,
    and hedging never changes a class, a pixel or the decode count."""
    _, tv = vaes
    ids = trace()
    boxes = []
    for hedge in (HedgeConfig(enabled=False),
                  HedgeConfig(quantile=0.9, min_samples=8)):
        plan = FaultPlan.stall(0, 24, 400.0)
        box = (sim_box(fault_plan=plan, hedge=hedge) if kind == "sim"
               else engine_box(tv, fault_plan=plan, hedge=hedge))
        fill(box, demote=())
        res = []
        for s in range(0, len(ids), 8):
            res += box.get_many(ids[s:s + 8])
        boxes.append((box.summary(), res))
    (off, roff), (on, ron) = boxes
    assert [(r.hit_class, r.node) for r in roff] == \
        [(r.hit_class, r.node) for r in ron]
    assert off["hedges_fired"] == 0
    assert on["hedges_fired"] > 0 and on["hedge_wins"] > 0
    wins = [r for r in ron if r.hedged]
    assert len(wins) == on["hedge_wins"]
    for r in wins:
        assert r.latency_ms["total"] < r.latency_ms["unhedged_total"]
    if kind == "engine":
        assert on["decodes"] == off["decodes"]
        for a, b in zip(roff, ron):
            np.testing.assert_array_equal(a.payload, b.payload)
    else:
        p99 = [float(np.percentile([r.total_ms for r in rs], 99))
               for rs in (roff, ron)]
        assert p99[1] < p99[0]


@pytest.mark.parametrize("op", ["add", "remove"])
def test_reshard_moves_only_remapped_keys(op):
    box = sim_box(replication=1)
    cluster = box.backend
    n = 1000
    for oid in range(n):
        box.put(oid)
    before = {oid: cluster.shard_of(oid) for oid in range(n)}
    if op == "add":
        rep = cluster.add_shard()
        assert rep.n_shards == SHARDS + 1
        assert 0 < rep.moved_fraction <= 2 / rep.n_shards
        moved_to = {rep.shard_id}
    else:
        victim = cluster.shard_ids[-1]
        rep = cluster.remove_shard(victim)
        assert rep.n_shards == SHARDS - 1 and victim not in cluster.shard_ids
        assert rep.n_moved == sum(1 for v in before.values() if v == victim)
        moved_to = set(cluster.shard_ids)
    moved = [oid for oid in range(n) if cluster.shard_of(oid) != before[oid]]
    assert rep.n_moved == len(moved) > 0
    for oid in moved:
        assert cluster.shard_of(oid) in moved_to
        if op == "remove":
            assert before[oid] == victim
    for oid in moved[:50]:
        assert cluster.residency_shards(oid) == [cluster.shard_of(oid)]
    assert len(box.get_many(list(range(n)))) == n


@pytest.mark.parametrize("persistent", [False, True])
def test_engine_pixels_bit_identical_after_migration(vaes, tmp_path,
                                                     persistent):
    """The durable blob moves with the key (on disk: a shipped segment),
    so the new shard decodes the same image, cache-cold."""
    _, tv = vaes
    kw = dict(data_dir=str(tmp_path / "m")) if persistent else {}
    box = engine_box(tv, shards=2, replication=1, **kw)
    cluster = box.backend
    n = 24
    fill(box, n, demote=())
    baseline = {r.oid: r.payload for r in box.get_many(list(range(n)))}
    before = {oid: cluster.shard_of(oid) for oid in range(n)}
    cluster.add_shard()
    moved = [oid for oid in range(n) if cluster.shard_of(oid) != before[oid]]
    assert moved
    for r in box.get_many(moved):
        assert r.hit_class == "full_miss"
        np.testing.assert_array_equal(r.payload, baseline[r.oid])
    box.close()


def test_cluster_meta_survives_reopen(vaes, tmp_path):
    """Topology (shard ids, node slices) and replication come back from
    ``CLUSTER.json``; a reshard before the close is part of it; a wrong
    shard or replica count is refused; a torn meta raises cleanly."""
    _, tv = vaes
    path = tmp_path / "c"

    def reopen(**kw):
        return LatentBox.open(path, vae=tv, config=cfg(), device="cpu",
                              **kw)

    with reopen(shards=SHARDS, replication=2) as box:
        fill(box, demote=())
        box.backend.add_shard()
        topo = {sid: s.node_names for sid, s in box.backend.shards.items()}
        first = {r.oid: r.payload for r in box.get_many(list(range(20)))}
    with pytest.raises(ValueError, match="shards="):
        reopen(shards=SHARDS)
    with pytest.raises(ValueError, match="replication"):
        reopen(shards=SHARDS + 1, replication=3)
    with reopen(shards=SHARDS + 1) as box:
        assert box.backend.replication == 2
        assert {sid: s.node_names
                for sid, s in box.backend.shards.items()} == topo
        assert box.summary()["under_replicated_objects"] == 0
        for r in box.get_many(list(range(20))):
            np.testing.assert_array_equal(r.payload, first[r.oid])
    meta = os.path.join(path, ShardedLatentBox.CLUSTER_META)
    assert json.load(open(meta))["replication"] == 2
    raw = open(meta, "rb").read()
    with open(meta, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="corrupt cluster meta"):
        reopen(shards=SHARDS + 1)


def test_summary_counters_serializable():
    box = sim_box(fault_plan=FaultPlan.kill(1, 40))
    fill(box)
    serve(box, trace(length=120))
    s = box.summary()
    for key in ("replication", "failovers", "hedges_fired", "hedge_wins",
                "under_replicated_objects", "dead_shards", "restarts"):
        assert key in s, key
    json.dumps(s)


def test_sim_serve_stream_names_what_is_left():
    """``SimBackend.serve_stream`` raised naming ROADMAP A 6 until A 6
    ported the serving runtime: it now serves a stream, and on a
    replicated cluster with a shard killed mid-trace the facade replays
    a drain stream as the reference's does, and as the port's own
    windows of 8 (``tests/test_torch_runtime.py`` holds every
    scenario)."""
    from repro.serve import runtime as jax_runtime
    from repro_torch.serve import runtime
    ids = trace()
    port, windowed = (sim_box(fault_plan=FaultPlan.kill(1, 40))
                      for _ in range(2))
    ref = JaxBox.simulated(
        JaxStoreConfig(n_nodes=2, **CELL, tuner=JaxTunerConfig(window=10**9)),
        shards=SHARDS, replication=2, fault_plan=JaxFaultPlan.kill(1, 40))
    for box in (port, windowed):
        fill(box)
    fill(ref, recipe=JaxRecipe)
    plain = LatentBox.simulated(cfg())
    fill(plain)
    rep = plain.backend.serve_stream(
        [runtime.Request(oid=o, arrival_ms=0.0) for o in ids])
    assert rep.counters["served"] == len(ids)
    got = port.serve_stream(
        [runtime.Request(oid=o, arrival_ms=0.0) for o in ids],
        runtime_cfg=runtime.RuntimeConfig.conformance())
    want = ref.serve_stream(
        [jax_runtime.Request(oid=o, arrival_ms=0.0) for o in ids],
        runtime_cfg=jax_runtime.RuntimeConfig.conformance())
    assert got.outcomes == want.outcomes
    assert got.counters == want.counters
    assert got.outcomes == serve(windowed, ids)[0]


def test_lossy_transcode_failover_matches_the_reference(vaes, tmp_path):
    """Lossy demotions transcoded by a compaction, then a dead shard: the
    port serves what the reference serves, healthy and through failover
    (+-1 LSB).  The reference ships no compaction rewrite to replicas
    (ROADMAP C), so a failover may serve a "low" object's rung-0 bytes;
    the objects whose failover image differs from the healthy one are
    the same in both packages, and only such objects."""
    jv, tv = vaes
    ids = list(range(24))
    lossy = ids[::3]
    runs = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            def opened():
                return JaxBox.open(tmp_path / pkg, vae=jv,
                                   config=JaxStoreConfig(n_nodes=2, **CELL),
                                   shards=SHARDS, replication=2)
        else:
            def opened():
                return LatentBox.open(tmp_path / pkg, vae=tv,
                                      config=StoreConfig(n_nodes=2, **CELL),
                                      shards=SHARDS, replication=2,
                                      device="cpu")
        box = opened()
        for oid in ids:
            box.put(oid, latent=latent_of(oid))
        for oid in lossy:
            assert box.demote(oid, "low")
        box.close()                        # seals: the transcodes can run
        box = opened()
        for sh in box.backend.shards.values():
            for _ in range(8):
                sh.backend.store.maybe_compact()
        assert all(box.stat(oid).rung_name == "low" for oid in lossy)
        healthy = {r.oid: r.payload for r in box.get_many(ids)}
        box.backend.kill_shard(1)
        dead = {r.oid: r.payload for r in box.get_many(ids)}
        runs[pkg] = healthy, dead, {o for o in ids
                                    if not np.array_equal(healthy[o],
                                                          dead[o])}
        box.close()
    (jh, jd, jdiff), (th, td, tdiff) = runs["jax"], runs["port"]
    assert tdiff == jdiff
    assert tdiff <= {o for o in lossy if box.backend.shard_of(o) == 1}
    for oid in ids:
        for a, b in ((th[oid], jh[oid]), (td[oid], jd[oid])):
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1

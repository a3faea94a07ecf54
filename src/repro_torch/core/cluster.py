"""Discrete-event simulator of a LatentBox serving cluster (paper §4/§6) —
the latency plant behind the SIMULATOR backend of the ``LatentBox`` API.

The paper's prototype runs Ray actors over real GPUs + S3.  This container
has neither, so the *latency-bearing* plant (GPU queues, store fetches,
network hops) is simulated by a deterministic event loop, while the actual
compute artifacts (VAE decode cost, compressed-latent sizes) come from the
real JAX/Pallas layers: the default ``decode_ms`` is cross-checked against
the decoder's TPU roofline estimate (see ``benchmarks/bench_decode.py``),
and per-object sizes can be fed from the real codec.

Since the store refactor the repo has exactly one tier-walk read path
(:mod:`repro.store.walk`) with two backends of the same facade:
``serve/engine.py`` supplies real jitted decodes, while this module
supplies the plant — :class:`GpuQueue` and
:class:`~repro.core.latent_store.StoreLatencyModel` are consumed by
:class:`repro.store.backends.SimBackend` so the simulated ``LatentBox``
and the classic event loop below share one queueing model.
:class:`ClusterSim` itself remains the multi-configuration harness for the
paper's §6.1 baselines, which need modes the object-store API doesn't
expose:

  ``generation``  full SD pipeline on miss (upper-bound reference)
  ``decode_all``  no cache; every request fetches latent + decodes
  ``imgstore``    PNG LRU per node; miss = full-PNG S3 fetch (no GPU)
  ``lb``          LatentBox: dual-format cache (+ optional adaptive tuner),
                  consistent-hash routing, coalescing, spillover w/ pinning.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.latent_store import DEFAULT_OBJECT_BYTES
from repro_torch.core.dual_cache import (DualFormatCache, FULL_MISS, IMAGE_HIT,
                                   LATENT_HIT)
from repro_torch.core.latent_store import LatentStore, StoreLatencyModel
from repro_torch.core.metrics import RequestLog
from repro_torch.core.policies import LRUCache
from repro_torch.core.router import Router
from repro_torch.core.tuner import MarginalHitTuner, TunerConfig

ARR, FETCH_DONE, DEC_DONE = 0, 1, 2


@dataclasses.dataclass
class ClusterConfig:
    mode: str = "lb"                   # generation|decode_all|imgstore|lb
    n_nodes: int = 3
    gpus_per_node: int = 1
    cache_bytes_per_node: float = 2e9
    #: Pixel-cache entry charge.  The §6.1 ``imgstore`` baseline caches
    #: encoded PNGs (paper's 1.4 MB average); for the ``lb`` modes compare
    #: against the facade's ``StoreConfig``, whose uint8 raw-pixel charge
    #: (H*W*3) is what the serving engine actually pins since the fused
    #: uint8 decode epilogue.
    image_bytes: float = 1.4e6
    latent_bytes: float = DEFAULT_OBJECT_BYTES
    # LB cache policy
    alpha0: float = 0.5
    adaptive: bool = True
    tau: float = 0.10
    promote_threshold: int = 8
    admit_on_miss: str = "latent"      # 'latent' | 'image' (alpha=1 variant)
    tuner: TunerConfig = dataclasses.field(
        default_factory=lambda: TunerConfig(window=50_000))
    # routing
    theta: int = 4
    spillover: bool = True
    coalescing: bool = True
    latent_ship_ms: float = 1.0        # owner -> spill node latent transfer
    # plant
    decode_ms: float = 31.0            # VAE decode (H100-measured / roofline)
    decode_jitter_sigma: float = 0.08  # lognormal jitter on decode time
    generation_ms: float = 3905.0      # 28-step SD3.5 diffusion (paper §6.3.1)
    net_ms: float = 10.0               # node -> router transfer (Fig 7)
    store: StoreLatencyModel = dataclasses.field(default_factory=StoreLatencyModel)
    seed: int = 0


class GpuQueue:
    """Per-node fleet of GPU FIFO queues (the decode plant).

    Two consumption styles share the same state:

    * event-driven (:class:`ClusterSim`): ``start`` schedules on the
      least-loaded GPU, ``finish`` releases it when the DEC_DONE event
      fires;
    * sequential replay (:class:`repro.store.backends.SimBackend`):
      ``release(now)`` retires every decode that completed before ``now``
      as the replay clock advances.
    """

    def __init__(self, n_gpus: int):
        if n_gpus <= 0:
            raise ValueError("need at least one GPU per node")
        self.free_at = [0.0] * n_gpus
        self._done: List[List[float]] = [[] for _ in range(n_gpus)]
        #: Cumulative decode occupancy (ms) across the fleet — the
        #: autoscaler's utilization signal (window deltas of this /
        #: span * n_gpus).
        self.busy_ms = 0.0

    @property
    def n_gpus(self) -> int:
        return len(self.free_at)

    @property
    def outstanding(self) -> List[int]:
        return [len(d) for d in self._done]

    def depth(self) -> int:
        """Queue depth reported to the router: the least-loaded GPU's."""
        return min(self.outstanding)

    def pick(self) -> int:
        return int(np.argmin(self.outstanding))

    def start(self, t: float, duration: float) -> Tuple[int, float]:
        """Enqueue a decode at time ``t``; returns ``(gpu, start_time)``."""
        g = self.pick()
        start = max(t, self.free_at[g])
        self.free_at[g] = start + duration
        self._done[g].append(start + duration)
        self.busy_ms += duration
        return g, start

    def finish(self, gpu: int) -> None:
        """Event-driven release: one decode on ``gpu`` completed."""
        if self._done[gpu]:
            self._done[gpu].pop(0)

    def release(self, now: float) -> None:
        """Sequential release: retire everything completed by ``now``."""
        for d in self._done:
            while d and d[0] <= now:
                d.pop(0)

    def resize(self, n_gpus: int) -> None:
        """Elastically grow or shrink the fleet (the autoscaler's GPU
        knob).  Growth adds idle GPUs.  Shrink folds the removed GPUs'
        in-flight decodes onto the least-loaded survivors so no scheduled
        completion event is ever dropped — work already started finishes,
        only future capacity changes."""
        n_gpus = int(n_gpus)
        if n_gpus <= 0:
            raise ValueError("need at least one GPU per node")
        cur = len(self.free_at)
        if n_gpus > cur:
            self.free_at.extend([0.0] * (n_gpus - cur))
            self._done.extend([[] for _ in range(n_gpus - cur)])
            return
        if n_gpus == cur:
            return
        removed_free = self.free_at[n_gpus:]
        removed_done = self._done[n_gpus:]
        self.free_at = self.free_at[:n_gpus]
        self._done = self._done[:n_gpus]
        for free, done in zip(removed_free, removed_done):
            g = int(np.argmin([len(d) for d in self._done]))
            self._done[g] = sorted(self._done[g] + done)
            self.free_at[g] = max(self.free_at[g], free)


class _Node:
    """One GPU node: dual-format (or LRU) cache + per-GPU FIFO queues."""

    def __init__(self, idx: int, cfg: ClusterConfig):
        self.idx = idx
        self.cfg = cfg
        if cfg.mode in ("imgstore", "generation"):
            self.lru = LRUCache(cfg.cache_bytes_per_node)
            self.cache = None
        elif cfg.mode == "decode_all":
            self.lru = None
            self.cache = None
        else:
            self.lru = None
            alpha0 = cfg.alpha0
            self.cache = DualFormatCache(
                cfg.cache_bytes_per_node, alpha=alpha0, tau=cfg.tau,
                promote_threshold=cfg.promote_threshold,
                image_size_fn=lambda oid: cfg.image_bytes,
                latent_size_fn=lambda oid: cfg.latent_bytes)
        self.tuner: Optional[MarginalHitTuner] = None
        if self.cache is not None and cfg.adaptive:
            self.tuner = MarginalHitTuner(self.cache, cfg.tuner)
        self.gpus = GpuQueue(cfg.gpus_per_node)

    # queue depth the node reports to the router: depth of its least-loaded GPU
    def reported_depth(self) -> int:
        return self.gpus.depth()


class ClusterSim:
    """Event-driven replay of a request trace through the cluster."""

    def __init__(self, cfg: ClusterConfig, store: Optional[LatentStore] = None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.store = store or LatentStore(cfg.store, seed=cfg.seed + 1)
        self.nodes = [_Node(i, cfg) for i in range(cfg.n_nodes)]
        self.node_by_name = {f"node{i}": n for i, n in enumerate(self.nodes)}
        self.router = Router([f"node{i}" for i in range(cfg.n_nodes)],
                             theta=cfg.theta)
        self.log = RequestLog()
        self._seq = itertools.count()

    # -- latency samplers ------------------------------------------------------
    def _decode_time(self) -> float:
        c = self.cfg
        base = c.generation_ms if c.mode == "generation" else c.decode_ms
        if c.decode_jitter_sigma <= 0:
            return base
        return float(base * self.rng.lognormal(0.0, c.decode_jitter_sigma))

    def _fetch_time(self, oid: int, now_ms: float, nbytes: float) -> float:
        return self.store.fetch_ms(oid, now_ms / 1e3, nbytes=nbytes)

    # -- main loop --------------------------------------------------------------
    def run(self, timestamps_ms: np.ndarray, object_ids: np.ndarray,
            limit: Optional[int] = None) -> RequestLog:
        cfg = self.cfg
        n = len(timestamps_ms) if limit is None else min(limit, len(timestamps_ms))
        events: List[Tuple[float, int, int, tuple]] = []
        for i in range(n):
            heapq.heappush(events, (float(timestamps_ms[i]), next(self._seq),
                                    ARR, (int(object_ids[i]),)))
        while events:
            t, _, kind, payload = heapq.heappop(events)
            if kind == ARR:
                self._on_arrival(t, payload[0], events)
            elif kind == FETCH_DONE:
                self._on_fetch_done(t, events, *payload)
            else:
                self._on_decode_done(t, *payload)
        return self.log

    # -- request handling --------------------------------------------------------
    def _on_arrival(self, t: float, oid: int, events: list) -> None:
        cfg = self.cfg
        # 1. coalescing
        if cfg.coalescing and self.router.try_coalesce(oid, (t,)):
            return
        # 2. ownership
        owner_name = self.router.ring.owner(oid)
        node = self.node_by_name[owner_name]

        if cfg.mode == "decode_all":
            self._start_fetch(t, oid, node, node, events, arrival=t)
            return

        if cfg.mode in ("imgstore", "generation"):
            hit = node.lru.access(oid, cfg.image_bytes)
            if hit:
                self._complete(t, oid, arrival=t, outcome=IMAGE_HIT, node=node)
                return
            if cfg.mode == "imgstore":
                fetch = self._fetch_time(oid, t, cfg.image_bytes)
                self.log.add(t, fetch + cfg.net_ms, FULL_MISS,
                             fetch_ms=fetch, net_ms=cfg.net_ms, node=node.idx)
            else:  # generation: run the full diffusion pipeline on a GPU
                self.router.begin_inflight(oid)
                self._schedule_decode(t, oid, node, node, events, arrival=t,
                                      fetch_ms=0.0, spilled=False)
            return

        # LatentBox modes -----------------------------------------------------
        res = node.cache.lookup(oid)
        if node.tuner is not None:
            node.tuner.on_request()
        if res.outcome == IMAGE_HIT:
            self._complete(t, oid, arrival=t, outcome=IMAGE_HIT, node=node)
            return
        # needs a GPU: register in-flight, pick exec node (spillover)
        self.router.begin_inflight(oid)
        exec_node = self._choose_exec(node)
        if res.outcome == LATENT_HIT:
            ship = cfg.latent_ship_ms if exec_node is not node else 0.0
            self._schedule_decode(t + ship, oid, node, exec_node, events,
                                  arrival=t, fetch_ms=0.0,
                                  spilled=exec_node is not node)
        else:  # FULL_MISS
            self._start_fetch(t, oid, node, exec_node, events, arrival=t)

    def _choose_exec(self, owner: _Node) -> _Node:
        cfg = self.cfg
        if not cfg.spillover:
            return owner
        self.router.report_depth(f"node{owner.idx}", owner.reported_depth())
        if owner.reported_depth() > cfg.theta:
            for nd in self.nodes:
                self.router.report_depth(f"node{nd.idx}", nd.reported_depth())
            spill_name = self.router.least_loaded(exclude=f"node{owner.idx}")
            spill = self.node_by_name[spill_name]
            if spill.reported_depth() < owner.reported_depth():
                self.router.n_spillover += 1
                return spill
        return owner

    def _start_fetch(self, t: float, oid: int, owner: _Node, exec_node: _Node,
                     events: list, arrival: float) -> None:
        cfg = self.cfg
        if cfg.mode != "decode_all":
            self.router.begin_inflight(oid)  # idempotent for LB path
        else:
            self.router.begin_inflight(oid)
        fetch = self._fetch_time(oid, t, cfg.latent_bytes)
        heapq.heappush(events, (t + fetch, next(self._seq), FETCH_DONE,
                                (oid, owner.idx, exec_node.idx, arrival, fetch)))

    def _on_fetch_done(self, t: float, events: list, oid: int, owner_idx: int,
                       exec_idx: int, arrival: float, fetch: float) -> None:
        cfg = self.cfg
        owner = self.nodes[owner_idx]
        # admit into the owner's latent tier (cache pinning: entry lives at
        # the hash-determined home regardless of where the decode runs)
        if owner.cache is not None:
            if cfg.admit_on_miss == "latent":
                owner.cache.admit_latent(oid)
            else:
                owner.cache.insert_image(oid)
        if owner.tuner is not None:
            owner.tuner.observe_fetch_ms(fetch)
        self._schedule_decode(t, oid, owner, self.nodes[exec_idx], events,
                              arrival=arrival, fetch_ms=fetch,
                              spilled=exec_idx != owner_idx)

    def _schedule_decode(self, t: float, oid: int, owner: _Node,
                         exec_node: _Node, events: list, arrival: float,
                         fetch_ms: float, spilled: bool) -> None:
        dec = self._decode_time()
        g, start = exec_node.gpus.start(t, dec)
        queue_ms = start - t
        heapq.heappush(events, (start + dec, next(self._seq), DEC_DONE,
                                (oid, owner.idx, exec_node.idx, g, arrival,
                                 fetch_ms, dec, queue_ms, spilled)))

    def _on_decode_done(self, t: float, oid: int, owner_idx: int,
                        exec_idx: int, gpu: int, arrival: float,
                        fetch_ms: float, dec_ms: float, queue_ms: float,
                        spilled: bool) -> None:
        cfg = self.cfg
        exec_node = self.nodes[exec_idx]
        exec_node.gpus.finish(gpu)
        owner = self.nodes[owner_idx]
        if owner.tuner is not None:
            owner.tuner.observe_decode_ms(dec_ms + queue_ms)
        if cfg.mode == "generation":
            owner.lru.insert(oid, cfg.image_bytes)
        outcome = FULL_MISS if fetch_ms > 0 or cfg.mode in (
            "decode_all", "generation") else LATENT_HIT
        done = t + cfg.net_ms
        self.log.add(arrival, done - arrival, outcome, queue_ms=queue_ms,
                     fetch_ms=fetch_ms, decode_ms=dec_ms, net_ms=cfg.net_ms,
                     spilled=spilled, node=exec_idx)
        # coalesced waiters complete with the same decoded result
        for (w_arrival,) in self.router.finish_inflight(oid):
            self.log.add(w_arrival, done - w_arrival, outcome,
                         queue_ms=queue_ms, fetch_ms=fetch_ms,
                         decode_ms=dec_ms, net_ms=cfg.net_ms,
                         spilled=spilled, coalesced=True, node=exec_idx)

    def _complete(self, t: float, oid: int, arrival: float, outcome: str,
                  node: _Node) -> None:
        cfg = self.cfg
        self.log.add(arrival, cfg.net_ms, outcome, net_ms=cfg.net_ms,
                     node=node.idx)


def replay_cluster(cfg: ClusterConfig, timestamps_s: np.ndarray,
                   object_ids: np.ndarray, speedup: float = 1.0,
                   limit: Optional[int] = None,
                   store: Optional[LatentStore] = None) -> Tuple[RequestLog, ClusterSim]:
    """Replay a trace (timestamps in seconds) at ``speedup``x wall-clock."""
    sim = ClusterSim(cfg, store=store)
    ts_ms = np.asarray(timestamps_s, dtype=np.float64) * 1e3 / speedup
    log = sim.run(ts_ms, np.asarray(object_ids), limit=limit)
    return log, sim


def replay_scenario(cfg: ClusterConfig, scenario: str, speedup: float = 1.0,
                    limit: Optional[int] = None,
                    **trace_knobs) -> Tuple[RequestLog, ClusterSim]:
    """Replay a named workload from the scenario suite
    (:func:`repro.trace.synth.make_trace`) through the event-driven
    cluster: ``replay_scenario(cfg, "flash_crowd", n_objects=10_000)``."""
    from repro_torch.trace.synth import make_trace
    tr = make_trace(scenario, **trace_knobs)
    return replay_cluster(cfg, tr.timestamps, tr.object_ids,
                          speedup=speedup, limit=limit)

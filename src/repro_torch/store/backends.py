"""The two backends of the ``LatentBox`` facade (counterpart of the JAX
package's ``store/backends.py``).

Both run the identical :class:`~repro_torch.store.walk.TierWalk` read
path, so they classify a shared trace identically; they differ only in
how payloads and latencies are produced:

* :class:`EngineBackend` -- real compute on ``device`` (default
  ``"cuda"``): encode and decode through the microbatching scheduler
  (``serve/engine.py``), measured wall clock in the latency breakdown,
  true uint8 or float32 pixels in ``GetResult.payload``.
* :class:`SimBackend` -- the discrete latency plant from
  ``core/cluster.py`` (:class:`~repro_torch.core.cluster.GpuQueue` + the
  S3 latency model): no pixels, but queue/fetch/decode/regen milliseconds
  for capacity planning at trace scale.

With ``StoreConfig.data_dir`` both keep their durable tiers in one
segment log under that directory (``store/durable/``), so a reopened box
serves every acknowledged put bit-exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.compression.ladder import RECIPE_RUNG, resolve_rung
from repro_torch.core.cluster import GpuQueue
from repro_torch.core.dual_cache import IMAGE_HIT, LATENT_HIT
from repro_torch.core.latent_store import LatentStore
from repro_torch.core.metrics import RequestLog
from repro_torch.core.regen_tier import Recipe, RegenTierStore
from repro_torch.store.api import (GetResult, ObjectStat, PutResult,
                                   StoreConfig)
from repro_torch.store.durable.backend import SegmentLogBackend
from repro_torch.store.durable.log import SegmentLog
from repro_torch.store.tiers import DurableTier, RecipeTier
from repro_torch.store.walk import TierWalk

MS_PER_MONTH = 30 * 86_400.0 * 1e3


def _open_durable(cfg: StoreConfig
                  ) -> Tuple[LatentStore, RegenTierStore,
                             Optional[SegmentLog]]:
    """Build the durable pair (latent store + regen tier) for one backend.

    Without ``cfg.data_dir`` both are in-memory, exactly the pre-refactor
    behavior.  With it, one :class:`SegmentLog` under ``data_dir`` carries
    BOTH the latent blobs/sizes and the recipe/demotion records; recovery
    replays the log (manifest checkpoint + tail scan) into the two stores
    so a reopened box serves every acknowledged put bit-exact.
    """
    if cfg.data_dir is None:
        return (LatentStore(cfg.store_latency, seed=cfg.seed + 1),
                RegenTierStore(), None)
    log = SegmentLog(cfg.data_dir, segment_bytes=cfg.segment_bytes,
                     fsync=cfg.fsync, checkpoint_every=cfg.checkpoint_every)
    backend = SegmentLogBackend(log,
                                flush_each_put=not cfg.write_behind,
                                compact_live_frac=cfg.compact_live_frac)
    store = LatentStore(cfg.store_latency, seed=cfg.seed + 1,
                        backend=backend)
    regen = RegenTierStore(journal=log)
    for oid, state in log.recipe_states().items():
        regen.restore_state(oid, state)
    return store, regen, log


def _stat(walk: TierWalk, store: LatentStore, regen: RegenTierStore,
          oid: int) -> Optional[ObjectStat]:
    residency = walk.residency(oid)
    if not residency:
        return None
    st = store.stat(oid)
    demoted = regen.is_demoted(oid)
    # ladder position: the durable rung when bytes exist, the recipe rung
    # when demoted to recipe-only, None when the object has no durable class
    rung = st["rung"] if st else (RECIPE_RUNG if demoted else None)
    return ObjectStat(
        oid=oid,
        residency=residency,
        durable_bytes=st["nbytes"] if st else 0.0,
        recipe_bytes=(regen.recipe_of(oid).nbytes
                      if regen.recipe_of(oid) else 0.0),
        pixel_bytes=walk.pixel_bytes_of(oid),
        demoted=demoted,
        rung=rung,
        rung_name=resolve_rung(rung).name if rung is not None else None,
        target_rung=st["target_rung"] if st else None)


class EngineBackend:
    """Real-decode backend: wraps
    :class:`repro_torch.serve.engine.ServingEngine` on ``device``."""

    name = "engine"

    def __init__(self, vae, cfg: Optional[StoreConfig] = None, device=None):
        # deferred import: serve.engine imports the store package too
        from repro_torch.serve.engine import ServingEngine
        self.cfg = cfg or StoreConfig()
        self.store, self.regen, self.durable_log = _open_durable(self.cfg)
        # ServingEngine consumes the StoreConfig directly — no per-field
        # copying that could drift from the simulator backend
        self.engine = ServingEngine(vae, self.store, self.cfg,
                                    recipes=self.regen, device=device)
        self.walk = self.engine.walk

    # -- object lifecycle ---------------------------------------------------
    def put(self, oid: int, image=None, latent=None,
            recipe: Optional[Recipe] = None, nbytes: Optional[float] = None,
            prewarm: bool = False) -> PutResult:
        if image is None and latent is None and recipe is None:
            raise ValueError(
                "the engine backend stores real payloads: pass an image, "
                "a latent, or a recipe (nbytes-only puts are sim-only)")
        stored = self.engine.put(oid, image=image, latent=latent,
                                 recipe=recipe)
        if prewarm:
            self.engine.prewarm(oid)
        return PutResult(oid, float(stored),
                         recipe_bytes=float(recipe.nbytes) if recipe else 0.0,
                         format="latent", prewarmed=prewarm,
                         durable=self._ack())

    def _ack(self) -> bool:
        """Acknowledgement barrier after a mutating call: the recipe
        tier journals RSTATE/RDEL records straight into the log (NOT via
        the per-put-flushing store backend), so the ack must flush the
        log itself or acknowledged recipe/demotion/delete records could
        die in the file buffer.  Returns whether the mutation is durable
        at return (False in memory mode and under write-behind)."""
        if self.durable_log is None or self.cfg.write_behind:
            return False
        self.durable_log.flush()
        return True

    def get_many(self, oids: Sequence[int],
                 timestamps_ms=None) -> List[GetResult]:
        # timestamps are a simulator concept; the engine serves at wall-clock
        tickets = self.engine.serve_window(oids)
        out = []
        for t in tickets:
            total = t.fetch_ms + t.regen_ms + t.decode_ms
            out.append(GetResult(
                oid=t.oid, hit_class=t.outcome, payload=t.img,
                node=t.owner.idx,
                exec_node=t.exec_node.idx if t.exec_node else t.owner.idx,
                spilled=t.spilled, regenerated=t.regen_ms > 0,
                latency_ms={"fetch": t.fetch_ms, "regen": t.regen_ms,
                            "decode": t.decode_ms, "total": total}))
        return out

    def serve_stream(self, requests, runtime_cfg=None):
        """Open-loop stream replay through the event-loop serving runtime,
        feeding the engine's ``DecodeBatcher`` continuously (the
        ``admit``/``dispatch`` path, no fixed windows).  Returns a
        :class:`repro_torch.serve.runtime.StreamReport`."""
        return self.engine.serve_stream(requests, runtime_cfg)

    def pixels_resident(self, oid: int) -> bool:
        return self.walk.pixels_resident(oid)

    def delete(self, oid: int) -> bool:
        found = self.engine.delete(oid)
        self._ack()
        return found

    def demote(self, oid: int, rung=None) -> bool:
        out = self.engine.demote(oid, rung)
        self._ack()
        return out

    def promote(self, oid: int) -> bool:
        out = self.engine.promote(oid)
        self._ack()
        return out

    def stat(self, oid: int) -> Optional[ObjectStat]:
        return _stat(self.walk, self.store, self.regen, oid)

    def flush(self) -> None:
        """Durability barrier: every acknowledged write is on disk after
        this (and the manifest checkpoint bounds the next recovery)."""
        if self.durable_log is not None:
            self.durable_log.flush(manifest=True)

    def close(self) -> None:
        if self.durable_log is not None:
            self.store.close()

    def summary(self) -> Dict:
        out = self.engine.summary()
        if self.durable_log is not None:
            out.update(_durable_summary(self.store))
        return out


def _durable_summary(store: LatentStore) -> Dict:
    """On-disk truth for ``summary()``: real segment bytes, live bytes,
    and cumulative write amplification (1.0 until compaction rewrites)."""
    st = store.backend.stats()
    return {"durable_disk_bytes": float(st["on_disk_bytes"]),
            "durable_live_bytes": float(st["live_bytes"]),
            "durable_segments": int(st["segments"]),
            "write_amplification": float(st["write_amplification"]),
            "segments_compacted": int(st.get("segments_compacted", 0)),
            "reencoded_records": int(st.get("reencoded_records", 0)),
            "reencode_bytes_saved": float(
                st.get("reencode_bytes_saved", 0.0)),
            "pending_rungs": int(st.get("pending_rungs", 0))}


class SimBackend:
    """Latency-plant backend: the same tier walk, no real decode.

    Requests replay sequentially; with no explicit timestamps the replay
    is closed-loop (each request arrives when the previous completed).
    Store-fetch latencies use the per-call seed path, so a request's
    sample depends only on ``(seed, oid, arrival index)`` — reproducible
    under request reordering.
    """

    name = "sim"

    def __init__(self, cfg: Optional[StoreConfig] = None):
        self.cfg = cfg or StoreConfig()
        self.store, self.regen, self.durable_log = _open_durable(self.cfg)
        self.walk = TierWalk(self.cfg, DurableTier(self.store),
                             RecipeTier(self.regen))
        self.gpus = [GpuQueue(self.cfg.gpus_per_node)
                     for _ in self.walk.caches]
        self.clock_ms = 0.0
        self._seq = 0
        self.log = RequestLog()
        # live plant dimensions — never mutate self.cfg (it may be shared
        # across backends/shards); the autoscaler moves these instead
        self.gpus_per_node = int(self.cfg.gpus_per_node)
        self.cache_bytes_per_node = float(self.cfg.cache_bytes_per_node)
        # provisioned-resource time integrals (the $-per-M-req inputs);
        # accumulated lazily against the replay clock, always on
        self._gpu_ms = 0.0
        self._cache_byte_ms = 0.0
        self._acct_mark_ms = 0.0
        self.autoscaler = None
        if self.cfg.autoscale:
            from repro_torch.core.autoscale import (AutoscaleConfig,
                                                    AutoscaleController,
                                                    PlantState)
            from repro_torch.core.cost_model import params_for_store
            acfg = self.cfg.autoscale_cfg or AutoscaleConfig()
            if self.cfg.autoscale_cfg is None:
                import dataclasses as _dc
                acfg = _dc.replace(acfg, params=params_for_store(self.cfg))
            self.autoscaler = AutoscaleController(
                PlantState(self.gpus_per_node, len(self.walk.caches),
                           self.cache_bytes_per_node), acfg)
            # per-window observation marks
            self._as_mark = {"reqs": 0, "clock": 0.0, "busy": 0.0}

    # -- object lifecycle ---------------------------------------------------
    def put(self, oid: int, image=None, latent=None,
            recipe: Optional[Recipe] = None, nbytes: Optional[float] = None,
            prewarm: bool = False) -> PutResult:
        if oid in self.store:           # overwrite: purge cached copies,
            for tier in self.walk.caches:   # mirroring the engine backend
                tier.evict(oid)
        if nbytes is None:
            if latent is not None and hasattr(latent, "nbytes"):
                nbytes = float(latent.nbytes)
            elif isinstance(latent, (bytes, bytearray)):
                nbytes = float(len(latent))
            else:
                nbytes = self.cfg.latent_bytes
        self.store.put_size(oid, float(nbytes))
        if recipe is not None:
            self.regen.put(oid, float(nbytes),
                           now_mo=self.clock_ms / MS_PER_MONTH, recipe=recipe)
        if prewarm:
            owner = self.walk._idx[self.walk.router.ring.owner(oid)]
            self.walk.caches[owner].store(oid, format="image")
        return PutResult(oid, float(nbytes),
                         recipe_bytes=float(recipe.nbytes) if recipe else 0.0,
                         format="size", prewarmed=prewarm,
                         durable=self._ack())

    def _ack(self) -> bool:
        """Same ack barrier as the engine backend: flushes the shared
        log (recipe records bypass the store backend's per-put flush)."""
        if self.durable_log is None or self.cfg.write_behind:
            return False
        self.durable_log.flush()
        return True

    def _decode_time(self, oid: int, seq: int) -> float:
        c = self.cfg
        if c.decode_jitter_sigma <= 0:
            return c.decode_ms
        rng = np.random.default_rng((c.seed, 0xDEC0DE, oid & 0xFFFFFFFF, seq))
        return float(c.decode_ms * rng.lognormal(0.0, c.decode_jitter_sigma))

    def get_many(self, oids: Sequence[int],
                 timestamps_ms: Optional[Sequence[float]] = None
                 ) -> List[GetResult]:
        cfg = self.cfg
        out: List[GetResult] = []
        for k, oid in enumerate(oids):
            if timestamps_ms is not None:
                self.clock_ms = max(self.clock_ms, float(timestamps_ms[k]))
            t = self.clock_ms
            for q in self.gpus:
                q.release(t)
            ticket = self.walk.lookup(
                oid, depth_of=lambda i: self.gpus[i].depth())
            seq = self._seq
            self._seq += 1
            owner_tier = self.walk.caches[ticket.owner]
            lat = {"queue": 0.0, "fetch": 0.0, "decode": 0.0, "regen": 0.0,
                   "net": cfg.net_ms}

            if ticket.hit_class == IMAGE_HIT:
                done = t + cfg.net_ms
            else:
                t_ready = t
                if ticket.needs_fetch:
                    f = self.store.fetch_ms(oid, t / 1e3,
                                            nbytes=cfg.latent_bytes, seq=seq)
                    lat["fetch"] = f
                    t_ready += f
                    if owner_tier.tuner is not None:
                        owner_tier.tuner.observe_fetch_ms(f)
                if ticket.hit_class == LATENT_HIT and ticket.spilled:
                    t_ready += cfg.latent_ship_ms   # owner -> spill transfer
                if ticket.needs_regen:
                    # the generation pipeline (which includes the decode)
                    # occupies the exec GPU; the latent becomes durable again
                    dur = cfg.generation_ms
                    lat["regen"] = dur
                    self.store.put_size(oid, cfg.latent_bytes)
                    self.regen.readmit(oid, cfg.latent_bytes,
                                       now_mo=t / MS_PER_MONTH)
                else:
                    dur = self._decode_time(oid, seq)
                    lat["decode"] = dur
                if ticket.needs_fetch or ticket.needs_regen:
                    self.walk.admit_latent(ticket.owner, oid)
                _, start = self.gpus[ticket.exec_node].start(t_ready, dur)
                lat["queue"] = start - t_ready
                if owner_tier.tuner is not None:
                    if ticket.needs_regen:
                        # regen replaces the durable fetch on the miss
                        # path: same EWMA class as the engine backend
                        owner_tier.tuner.observe_fetch_ms(dur)
                    else:
                        owner_tier.tuner.observe_decode_ms(
                            dur + lat["queue"])
                done = start + dur + cfg.net_ms

            lat["total"] = done - t
            self.log.add(t, done - t, ticket.hit_class,
                         queue_ms=lat["queue"], fetch_ms=lat["fetch"],
                         decode_ms=lat["decode"], net_ms=cfg.net_ms,
                         spilled=ticket.spilled, node=ticket.exec_node)
            if timestamps_ms is None:
                self.clock_ms = done                  # closed-loop replay
            out.append(GetResult(
                oid=int(oid), hit_class=ticket.hit_class, payload=None,
                node=ticket.owner, exec_node=ticket.exec_node,
                spilled=ticket.spilled, regenerated=ticket.needs_regen,
                latency_ms=lat))
        # end-of-window maintenance, mirroring the engine's request loop:
        # write-behind records become durable, then one bounded online
        # compaction step (both no-ops without a segment log)
        self.store.flush()
        self.store.maybe_compact()
        self._account_provisioned()
        if self.autoscaler is not None:
            self._autoscale_step()
        return out

    # -- elastic autoscaling --------------------------------------------------
    def _account_provisioned(self) -> None:
        """Advance the provisioned-resource integrals to the current
        replay clock (GPU-ms and cache-byte-ms actually *held*, busy or
        not — what a bill charges and what the autoscaler trades)."""
        dt = self.clock_ms - self._acct_mark_ms
        if dt <= 0.0:
            return
        self._gpu_ms += dt * sum(q.n_gpus for q in self.gpus)
        self._cache_byte_ms += dt * self.cache_bytes_per_node * len(self.gpus)
        self._acct_mark_ms = self.clock_ms

    def _autoscale_step(self) -> None:
        from repro_torch.core.autoscale import WindowObs
        mark = self._as_mark
        n = len(self.log.latency_ms)
        if n - mark["reqs"] < self.autoscaler.cfg.window:
            return
        span = self.clock_ms - mark["clock"]
        busy = sum(q.busy_ms for q in self.gpus)
        outcomes = np.asarray(self.log.outcome[mark["reqs"]:n])
        queue = np.asarray(self.log.queue_ms[mark["reqs"]:n])
        obs = WindowObs(
            requests=n - mark["reqs"], span_ms=span,
            busy_ms=max(0.0, busy - mark["busy"]),
            decode_frac=float(np.mean(outcomes != 0)) if n > mark["reqs"]
            else 1.0,
            queue_p99_ms=float(np.percentile(queue, 99)) if queue.size
            else 0.0)
        self._as_mark = {"reqs": n, "clock": self.clock_ms, "busy": busy}
        ev = self.autoscaler.step(obs)
        if ev is not None:
            self._apply_scale(ev.state)

    def _apply_scale(self, state) -> None:
        """Actuate a controller decision: integrals are settled at the old
        plant first, then GPU queues resize (in-flight decodes preserved)
        and the tier walk re-splits cache capacity under the tuner's
        current alpha."""
        self._account_provisioned()
        if state.gpus_per_node != self.gpus_per_node:
            self.gpus_per_node = int(state.gpus_per_node)
            for q in self.gpus:
                q.resize(self.gpus_per_node)
        if state.cache_bytes_per_node != self.cache_bytes_per_node:
            self.cache_bytes_per_node = float(state.cache_bytes_per_node)
            self.walk.set_cache_capacity(self.cache_bytes_per_node)

    def serve_stream(self, requests, runtime_cfg=None):
        """Open-loop stream replay through the event-loop serving runtime:
        the scheduler owns the timeline (queue delay, deadlines, QoS) and
        calls ``get_many`` once per dispatched microbatch for
        classification.  Returns a
        :class:`repro_torch.serve.runtime.StreamReport`."""
        from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
        if runtime_cfg is None:
            runtime_cfg = RuntimeConfig.from_store(self.cfg)
        return ServingRuntime.for_target(self, runtime_cfg).run(requests)

    def pixels_resident(self, oid: int) -> bool:
        return self.walk.pixels_resident(oid)

    def delete(self, oid: int) -> bool:
        found = self.walk.delete(oid)
        self._ack()
        return found

    def demote(self, oid: int, rung=None) -> bool:
        out = self.walk.demote(oid, rung)
        self._ack()
        return out

    def promote(self, oid: int) -> bool:
        if not self.regen.is_demoted(oid):
            return False
        self.store.put_size(oid, self.cfg.latent_bytes)
        self.regen.readmit(oid, self.cfg.latent_bytes,
                           now_mo=self.clock_ms / MS_PER_MONTH)
        self._ack()
        return True

    def stat(self, oid: int) -> Optional[ObjectStat]:
        return _stat(self.walk, self.store, self.regen, oid)

    def flush(self) -> None:
        if self.durable_log is not None:
            self.durable_log.flush(manifest=True)

    def close(self) -> None:
        if self.durable_log is not None:
            self.store.close()

    def summary(self) -> Dict:
        out = self.walk.summary()
        out["sim_clock_ms"] = self.clock_ms
        s = self.log.summarize()
        for key in ("mean_ms", "p50_ms", "p95_ms", "p99_ms"):
            if key in s:
                out[key] = s[key]
        # decode-fleet observability (the autoscaler's feedback signal)
        self._account_provisioned()
        busy = float(sum(q.busy_ms for q in self.gpus))
        out["gpu_seconds"] = busy / 1e3
        out["decode_gpus"] = int(sum(q.n_gpus for q in self.gpus))
        out["decode_util"] = busy / self._gpu_ms if self._gpu_ms > 0 else 0.0
        out["provisioned_gpu_ms"] = self._gpu_ms
        out["provisioned_cache_byte_ms"] = self._cache_byte_ms
        if self.autoscaler is not None:
            out.update(self.autoscaler.summary())
        if self.durable_log is not None:
            out.update(_durable_summary(self.store))
        return out

"""``ShardedLatentBox`` — a multi-node LatentBox cluster as one backend.

The paper's fleet serves billions of requests by consistent-hash-placing
objects across independent store nodes; this module scales the single
``LatentBox`` backend the same way.  A sharded box owns S *shard backends*
(each a full :class:`~repro.store.backends.SimBackend` or
:class:`~repro.store.backends.EngineBackend` with its own GPU plant, caches
and tuner state) and routes every facade call to the shard that owns the
object.

The load-bearing design decision is the **global node namespace**: the
cluster has one flat fleet of nodes ``node0 .. node{S*K-1}`` and one global
consistent-hash ring over all of them; shard ``s`` simply *hosts* nodes
``[s*K, (s+1)*K)``, and an object's shard is the shard hosting its
globally-hashed owner node.  Because the owner among any subset of a
consistent-hash ring equals the global owner whenever the global owner is
in that subset, each shard's internal :class:`~repro.store.walk.TierWalk`
(built over its slice of the namespace via ``StoreConfig.node_names``)
resolves every object to exactly the node the *unsharded* fleet would pick.
Two consequences, both locked down by
``tests/test_shard_conformance.py``:

* **conformance** — per-node request subsequences are identical for any
  shard count, so a 1-shard and a 4-shard cluster classify every request
  of every scenario identically (the differential property);
* **bounded resharding** — adding a shard adds K nodes to the global ring,
  so only ~K/(N+K) of keys remap (consistent hashing), far below naive
  mod-N rehashing.

Shard add/remove migrates exactly the remapped keys: durable payload (or
size registration), recipe payload/accounting, and the demoted flag move;
cache warmth intentionally does not (a migrated key restarts cold on its
new shard, as it would in production).

**Replication and fault tolerance** (``replication=R``): each object is
additionally shipped to the next R-1 *distinct shards* along the global
ring (``ring.successors``), which host per-source *replica holders*
(:mod:`repro.store.replication`).  The primary acks as before; followers
are updated write-behind, per mutation.  A dead shard
(:class:`~repro.store.faults.FaultPlan` ``kill``/``partition``) fails its
reads over to a *proxy* backend rebuilt from the live holders plus a
replay of the shard's request journal — so a degraded cluster classifies
every request exactly as the healthy one would, just slower.  Reads whose
primary exceeds an adaptive peer-latency percentile fire a *hedged*
speculative replica fetch (first response wins, decode stays
single-flight).  Dead shards keep their ring nodes: a fault changes
availability, never placement, which is what keeps ``shard_of`` stable and
the differential property intact under failure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from repro_torch.core.dual_cache import FULL_MISS
from repro_torch.core.regen_tier import Recipe
from repro_torch.core.router import ConsistentHashRing, parse_node_index
from repro_torch.store.api import (REGEN_MISS, GetResult, ObjectStat, PutResult,
                             StoreConfig)
from repro_torch.compression.ladder import resolve_rung
from repro_torch.store.durable.segment import (BLOB, RDEL, RSTATE, RUNG, SIZE,
                                         TOMB, scan_records,
                                         unpack_rung_payload,
                                         unpack_size_rung)
from repro_torch.store.faults import FaultEvent, FaultPlan
from repro_torch.store.replication import (HedgeConfig, LogReplicaHolder,
                                     MemoryReplica, pack_state_records)

#: vnode count shared with the walks' internal :class:`Router` rings — the
#: subset-owner property needs identical vnode hashing on every ring.
_VNODES = 128


@dataclasses.dataclass(frozen=True)
class ReshardReport:
    """Key-movement accounting of one shard add/remove."""

    n_keys: int                      # keys tracked before the reshard
    n_moved: int                     # keys whose owner shard changed
    n_shards: int                    # shard count AFTER the reshard
    shard_id: int                    # the added / removed shard

    @property
    def moved_fraction(self) -> float:
        return self.n_moved / self.n_keys if self.n_keys else 0.0


@dataclasses.dataclass
class _Shard:
    """One shard: a full backend hosting a slice of the node namespace."""

    shard_id: int
    backend: Any
    node_names: Tuple[str, ...]


@dataclasses.dataclass
class _Downed:
    """Bookkeeping for one down shard.

    ``frontier`` snapshots, per holder *for* this source, the holder-local
    lsn at the source's last durability barrier (kill) or at the moment of
    partition — restart catch-up ships exactly the records after it back
    to the revived primary.
    """

    kind: str                                    # 'kill' | 'partition'
    backend: Any                                 # intact backend (partition)
    frontier: Dict[Tuple[int, int], int]
    proxy: Any                                   # failover backend or None


_global_node_index = parse_node_index    # names are 'node<global idx>'


class ShardedLatentBox:
    """Consistent-hash placement of objects over N per-shard backends.

    Implements the full backend protocol of the :class:`LatentBox` facade
    (``put/get_many/delete/demote/promote/stat/summary``), so
    ``LatentBox.simulated(cfg, shards=4)`` / ``LatentBox.engine(shards=4)``
    is a drop-in multi-node cluster.  ``config.n_nodes`` is the node count
    *per shard*.

    ``replication=R`` keeps every object on R distinct shards and enables
    failover + hedged reads; ``fault_plan`` scripts deterministic fault
    injection by global request index; ``hedge`` tunes the hedging policy.
    """

    name = "sharded"

    #: topology checkpoint of a persistent cluster (under ``data_dir``):
    #: shard ids, their node slices, and the allocation counters — so a
    #: reopened cluster reconstructs the EXACT hash topology (shard ids
    #: are never reused; node ranges survive earlier removals).
    CLUSTER_META = "CLUSTER.json"

    def __init__(self, backend_factory: Callable[[StoreConfig], Any],
                 n_shards: int, config: Optional[StoreConfig] = None, *,
                 replication: Optional[int] = None,
                 hedge: Optional[HedgeConfig] = None,
                 fault_plan: Optional[FaultPlan] = None):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.cfg = config or StoreConfig()
        if self.cfg.node_names is not None:
            raise ValueError("the sharded box owns the node namespace; "
                             "leave StoreConfig.node_names unset")
        self._factory = backend_factory
        self._nodes_per_shard = self.cfg.n_nodes
        self._next_node = 0
        self._next_shard_id = 0
        self.shards: Dict[int, _Shard] = {}
        self._shard_of_node: Dict[str, int] = {}
        self.ring = ConsistentHashRing([], vnodes=_VNODES)
        self._keys: Dict[int, int] = {}          # oid -> owning shard id
        # -- replication / fault state ---------------------------------------
        self.hedge = hedge or HedgeConfig()
        self.fault_plan = fault_plan or FaultPlan()
        self._holders: Dict[Tuple[int, int], Any] = {}   # (follower, src)
        self._designated: Dict[Tuple[int, int], Set[int]] = {}
        self._dead: Dict[int, _Downed] = {}
        self._stalled: Dict[int, float] = {}             # sid -> extra ms
        self._journal: Dict[int, List[tuple]] = {}       # sid -> cache ops
        self._fwd_seq: Dict[int, int] = {}       # memory-source fwd stream
        self._incarnation: Dict[int, int] = {}   # sid -> restart count
        self._lat_window: Dict[int, deque] = {}  # sid -> recent total_ms
        self._req_index = 0                      # global request counter
        self.failovers = 0
        self.hedges_fired = 0
        self.hedge_wins = 0
        self.restarts = 0
        meta = self._load_meta()
        if meta is not None:
            if n_shards != len(meta["shards"]):
                raise ValueError(
                    f"{self.cfg.data_dir} holds a {len(meta['shards'])}-"
                    f"shard cluster; reopen with shards="
                    f"{len(meta['shards'])} (got {n_shards}) and use "
                    "add_shard/remove_shard to change the topology")
            mrep = int(meta.get("replication", 1))
            if replication is None:
                replication = mrep                   # inherit on reopen
            elif int(replication) != mrep:
                raise ValueError(
                    f"{self.cfg.data_dir} holds a replication={mrep} "
                    f"cluster (got replication={replication})")
            self.replication = int(replication)
            self._next_node = int(meta["next_node"])
            self._next_shard_id = int(meta["next_shard_id"])
            for row in meta["shards"]:
                self._spawn_shard(sid=int(row["shard_id"]),
                                  names=tuple(row["node_names"]))
            self._recover_keys()
            self._reconcile_on_open()
        else:
            self.replication = 1 if replication is None else int(replication)
            for _ in range(n_shards):
                self._spawn_shard()
            self._write_meta()
        if self.replication < 1:
            raise ValueError("replication must be >= 1")
        self._mode = next(iter(self.shards.values())).backend.name
        self._decode_ewma = float(self.cfg.decode_ms)
        # -- elastic shard autoscaling (off by default) -----------------------
        # composition: each shard backend already runs its own gpu/cache
        # controller (same cfg.autoscale flag); the CLUSTER runs a second
        # controller owning ONLY the shard knob, so the two never fight
        # over a dimension.  Scale-down safety is the guard hook: never
        # mid-reshard, never while a shard is dead, never below
        # replication R.
        self._resharding = False
        self.autoscaler = None
        if self.cfg.autoscale:
            from repro_torch.core.autoscale import (AutoscaleConfig,
                                              AutoscaleController, PlantState)
            from repro_torch.core.cost_model import params_for_store
            base = self.cfg.autoscale_cfg or dataclasses.replace(
                AutoscaleConfig(), params=params_for_store(self.cfg))
            acfg = dataclasses.replace(
                base, shard_knob=True, gpu_knob=False, cache_knob=False,
                min_shards=max(base.min_shards, self.replication))
            self.autoscaler = AutoscaleController(
                PlantState(self.cfg.gpus_per_node, self._nodes_per_shard,
                           self.cfg.cache_bytes_per_node,
                           n_shards=self.n_shards),
                acfg, shard_guard=self._scale_down_safe)
            self._as_mark: Dict[str, Any] = {"reqs": 0, "clock": 0.0,
                                             "busy": 0.0, "logs": {}}

    # -- persistent-topology plumbing ----------------------------------------
    def _meta_path(self) -> Optional[str]:
        if self.cfg.data_dir is None:
            return None
        return os.path.join(self.cfg.data_dir, self.CLUSTER_META)

    def _load_meta(self) -> Optional[Dict[str, Any]]:
        p = self._meta_path()
        if p is None:
            return None
        if os.path.exists(p + ".tmp"):
            os.remove(p + ".tmp")     # torn writer; the rename never ran
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except ValueError as e:
            raise ValueError(
                f"corrupt cluster meta {p} ({e}); the meta is written "
                "atomically (fsync + rename), so this means external "
                "truncation/corruption — restore CLUSTER.json before "
                "reopening") from e

    def _write_meta(self) -> None:
        p = self._meta_path()
        if p is None:
            return
        os.makedirs(self.cfg.data_dir, exist_ok=True)
        meta = {"next_node": self._next_node,
                "next_shard_id": self._next_shard_id,
                "nodes_per_shard": self._nodes_per_shard,
                "replication": self.replication,
                "shards": [{"shard_id": sid,
                            "node_names": list(s.node_names)}
                           for sid, s in sorted(self.shards.items())]}
        tmp = p + ".tmp"
        # atomic + durable: a kill at ANY point leaves either the old or
        # the new meta, never a torn one (satellite of the resilience PR)
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def _recover_keys(self) -> None:
        """Rebuild the oid -> shard map from each shard's recovered log
        (objects AND recipe-only entries), so resharding after a reopen
        migrates exactly what the pre-crash cluster would have."""
        for sid, shard in self.shards.items():
            log = getattr(shard.backend, "durable_log", None)
            if log is None:
                continue
            for oid in log.object_oids():
                self._keys[int(oid)] = sid
            for oid in log.recipe_states():
                self._keys[int(oid)] = sid

    # -- constructors --------------------------------------------------------
    @classmethod
    def simulated(cls, n_shards: int,
                  config: Optional[StoreConfig] = None, *,
                  replication: Optional[int] = None,
                  hedge: Optional[HedgeConfig] = None,
                  fault_plan: Optional[FaultPlan] = None
                  ) -> "ShardedLatentBox":
        from repro_torch.store.backends import SimBackend
        return cls(SimBackend, n_shards, config, replication=replication,
                   hedge=hedge, fault_plan=fault_plan)

    @classmethod
    def engine(cls, vae, n_shards: int,
               config: Optional[StoreConfig] = None, *,
               replication: Optional[int] = None,
               hedge: Optional[HedgeConfig] = None,
               fault_plan: Optional[FaultPlan] = None,
               device=None) -> "ShardedLatentBox":
        """All shards share one ``vae`` instance on one ``device``
        (default ``"cuda"``), so every shard decodes through the same
        weights and kernels, as the shards of one process do."""
        from repro_torch.store.backends import EngineBackend
        return cls(lambda cfg: EngineBackend(vae, cfg, device=device),
                   n_shards, config, replication=replication, hedge=hedge,
                   fault_plan=fault_plan)

    # -- topology ------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    @property
    def live_shard_ids(self) -> List[int]:
        return [sid for sid in self.shard_ids if sid not in self._dead]

    @property
    def n_nodes(self) -> int:
        return sum(len(s.node_names) for s in self.shards.values())

    def shard_of(self, oid: int) -> int:
        """The shard hosting this object's globally-hashed owner node.
        Down shards keep their ring nodes — faults change availability,
        never placement — so this is stable across kill/restart."""
        return self._shard_of_node[self.ring.owner(int(oid))]

    def replica_shards(self, oid: int) -> List[int]:
        """The R distinct shards holding this object, primary first — the
        shards hosting the first R distinct-shard nodes along the ring
        walk from the object's hash position."""
        want = min(self.replication, self.n_shards)
        out: List[int] = []
        for node in self.ring.successors(int(oid)):
            sid = self._shard_of_node[node]
            if sid not in out:
                out.append(sid)
                if len(out) >= want:
                    break
        return out

    def _shard_cfg(self, sid: int, names: Tuple[str, ...]) -> StoreConfig:
        # a persistent cluster gives each shard its own segment-log
        # directory under the cluster root (shard ids never reuse, so a
        # re-added shard never inherits a dead shard's segments)
        data_dir = (os.path.join(self.cfg.data_dir, f"shard{sid:03d}")
                    if self.cfg.data_dir is not None else None)
        return dataclasses.replace(self.cfg, node_names=names,
                                   data_dir=data_dir)

    def _spawn_shard(self, sid: Optional[int] = None,
                     names: Optional[Tuple[str, ...]] = None) -> _Shard:
        """Create (or, with explicit ``sid``/``names`` from the topology
        checkpoint, re-attach) one shard backend."""
        if names is None:
            k = self._nodes_per_shard
            names = tuple(f"node{self._next_node + i}" for i in range(k))
            self._next_node += k
        if sid is None:
            sid = self._next_shard_id
            self._next_shard_id += 1
        shard = _Shard(sid, self._factory(self._shard_cfg(sid, names)),
                       names)
        self.shards[sid] = shard
        for n in names:
            self.ring.add_node(n)
            self._shard_of_node[n] = sid
        return shard

    # -- replication plumbing ------------------------------------------------
    def _holder_path(self, follower: int, src: int) -> str:
        return os.path.join(self.cfg.data_dir, f"shard{follower:03d}",
                            f"replica-of-{src:03d}")

    def _holder_for(self, follower: int, src: int):
        key = (follower, src)
        h = self._holders.get(key)
        if h is None:
            if self.cfg.data_dir is not None:
                h = LogReplicaHolder(self._holder_path(follower, src),
                                     segment_bytes=self.cfg.segment_bytes,
                                     fsync=self.cfg.fsync)
            else:
                h = MemoryReplica()
            h.src_inc = self._incarnation.get(src, 0)
            self._holders[key] = h
        return h

    def _acting_backend(self, sid: int):
        """The backend serving this shard's requests right now: the real
        backend, or — while the shard is down — its failover proxy."""
        down = self._dead.get(sid)
        if down is None:
            return self.shards[sid].backend
        if down.proxy is None:
            raise RuntimeError(
                f"shard {sid} is down ({down.kind}) and the cluster has "
                f"no replicas to fail over to "
                f"(replication={self.replication})")
        return down.proxy

    def _acting_or_none(self, sid: int):
        down = self._dead.get(sid)
        if down is None:
            return self.shards[sid].backend
        return down.proxy

    def _source_position(self, sid: int) -> int:
        """Current position of this source's forwarding stream (source lsn
        for log backends, the cluster-kept sequence for memory ones)."""
        src = self._acting_backend(sid)
        slog = getattr(src, "durable_log", None)
        return slog.next_lsn - 1 if slog is not None \
            else self._fwd_seq.get(sid, 0)

    def _export_from(self, src_sid: int, since: int, oids) -> bytes:
        """Raw record image of the given oids' current state from a
        source: lsn-delta from its log when persistent, full state packs
        when memory-backed (``since`` is then ignored — memory sources
        cannot address their history)."""
        src = self._acting_backend(src_sid)
        slog = getattr(src, "durable_log", None)
        if slog is not None:
            return slog.export_delta(since, oids=oids)
        parts = []
        seq = self._fwd_seq.get(src_sid, 0)
        for oid in sorted(int(o) for o in oids):
            if src.store.stat(oid) is None \
                    and src.regen.state_of(oid) is None:
                continue
            parts.append(pack_state_records(oid, src.store, src.regen,
                                            seq + 1))
            seq += 2
        self._fwd_seq[src_sid] = seq
        return b"".join(parts)

    def _forward(self, oid: int, sid: int) -> None:
        """Ship one object's current durable state to its follower
        holders — called after every mutation (put/delete/demote/promote
        and read-path regeneration), so a holder always mirrors the last
        mutation the primary applied."""
        if self.replication <= 1:
            return
        oid = int(oid)
        raw = None
        pos = 0
        for f in self.replica_shards(oid)[1:]:
            if f in self._dead:
                continue              # missed updates re-ship at revival
            h = self._holder_for(f, sid)
            if raw is None:
                raw = self._export_from(sid, 0, {oid})
                pos = self._source_position(sid)
            if raw:
                h.apply_records(raw, pos)
            self._designated.setdefault((f, sid), set()).add(oid)
            if h.kind == "memory":
                h.checkpoint()

    def _checkpoint_source(self, sid: int) -> None:
        """Durability barrier for one source: flush it, then checkpoint
        every live holder that follows it (advancing their
        ``durable_frontier`` is only sound once the source records they
        mirror are on the source's own disk)."""
        src = self._acting_or_none(sid)
        if src is not None:
            flush = getattr(src, "flush", None)
            if flush is not None:
                flush()
        for (f, s2), h in self._holders.items():
            if s2 == sid and f not in self._dead:
                h.checkpoint()

    def _desired_designation(self) -> Dict[Tuple[int, int], Set[int]]:
        want: Dict[Tuple[int, int], Set[int]] = {}
        if self.replication <= 1:
            return want
        for oid, src in self._keys.items():
            for f in self.replica_shards(oid)[1:]:
                want.setdefault((f, src), set()).add(int(oid))
        return want

    def _sync_replicas(self) -> None:
        """Reconcile holders with the desired (follower, source) -> oids
        designation after a topology change: discard de-designated
        objects, drop unwanted holders, full-ship newly designated state.
        Resharding refuses to run while shards are down, so this only
        ever sees a fully live cluster."""
        if self.replication <= 1:
            return
        want = self._desired_designation()
        for key, cur in list(self._designated.items()):
            tgt = want.get(key, set())
            stale = cur - tgt
            h = self._holders.get(key)
            if h is not None:
                for oid in stale:
                    h.discard(oid)
            if stale:
                self._designated[key] = cur & tgt
        for key in [k for k in self._holders if k not in want]:
            h = self._holders.pop(key)
            self._designated.pop(key, None)
            h.close()
            if h.kind == "log":
                shutil.rmtree(h.path, ignore_errors=True)
        for key, tgt in want.items():
            f, src = key
            cur = self._designated.get(key, set())
            h = self._holder_for(f, src)
            new = tgt - cur
            if new:
                raw = self._export_from(src, 0, new)
                if raw:
                    h.apply_records(raw, self._source_position(src))
            h.set_hwm(self._source_position(src))
            h.src_inc = self._incarnation.get(src, 0)
            self._designated[key] = set(tgt)
            h.checkpoint()

    def _reconcile_on_open(self) -> None:
        """Process reopen of a replicated persistent cluster.

        A crash may have cost a primary its unflushed write-behind tail
        while a holder still has that state (forwards are per-mutation),
        and cost a holder records the primary kept.  Equalize both
        directions: ship each holder's post-checkpoint tail back to its
        primary, then each primary's post-hwm delta to the holder, and
        rebase the hwm (the primary's lsn space may have shifted down
        with the truncated tail)."""
        if self.replication <= 1:
            return
        want = self._desired_designation()
        for (f, src), _tgt in want.items():
            h = self._holder_for(f, src)
            raw = h.export_delta(h.durable_frontier, h.live_oids())
            if raw:
                primary = self.shards[src].backend
                for oid in self._apply_shipped(primary, raw):
                    if primary.store.stat(int(oid)) is not None \
                            or primary.regen.state_of(int(oid)) is not None:
                        self._keys[int(oid)] = src
        want = self._desired_designation()   # recovered keys may be new
        for (f, src), tgt in want.items():
            h = self._holder_for(f, src)
            pos = self._source_position(src)
            raw = self._export_from(src, h.hwm, tgt)
            if raw:
                h.apply_records(raw, pos)
            h.set_hwm(self._source_position(src))
            self._designated[(f, src)] = set(tgt)
            h.checkpoint()
        self._sync_replicas()

    def _apply_shipped(self, backend, raw: bytes) -> Set[int]:
        """Apply a shipped raw record image to a backend's durable state
        (no cache side effects); returns the affected oids.  Corrupt
        input raises before any state is applied."""
        affected: Set[int] = set()
        log = getattr(backend, "durable_log", None)
        if log is not None:
            applied = log.ingest_segment(raw)
            for oid, state in applied["recipes"].items():
                backend.regen.restore_state(oid, state)
            for oid in applied["removed_recipes"]:
                backend.regen.forget(int(oid))
            for k in ("objects", "removed_objects", "removed_recipes"):
                affected.update(int(o) for o in applied[k])
            affected.update(int(o) for o in applied["recipes"])
            return affected
        recs, valid_end = scan_records(raw, 0)
        if valid_end != len(raw):
            raise ValueError(
                f"shipped records are corrupt: checksum/framing failure "
                f"at byte {valid_end} of {len(raw)}; nothing applied")
        for r in recs:
            if r.kind == BLOB:
                backend.store.put(r.oid, r.payload)
            elif r.kind == SIZE:
                nbytes, rung = unpack_size_rung(r.payload)
                backend.store.put_size(r.oid, nbytes, rung=rung)
            elif r.kind == RUNG:
                # memory backends apply ladder intents eagerly; a target
                # at/above the current rung is already-applied state
                backend.store.set_target_rung(
                    r.oid, unpack_rung_payload(r.payload))
            elif r.kind == TOMB:
                backend.store.delete(r.oid)
            elif r.kind == RSTATE:
                backend.regen.restore_state(
                    r.oid, json.loads(r.payload.decode()))
            elif r.kind == RDEL:
                backend.regen.forget(r.oid)
            affected.add(int(r.oid))
        return affected

    def _purge_cached(self, backend, oid: int) -> None:
        """Drop every cached trace of one object from a backend (tiers,
        engine payloads, decode memo) — durable state is untouched."""
        for tier in backend.walk.caches:
            tier.evict(oid)
        eng = getattr(backend, "engine", None)
        if eng is not None:
            for node in eng.nodes:
                node.drop_payloads(oid)
            eng.batcher.forget(oid)

    # -- failure injection ---------------------------------------------------
    def _apply_event(self, e: FaultEvent) -> None:
        if e.kind == "kill":
            self.kill_shard(e.shard_id)
        elif e.kind == "partition":
            self.partition_shard(e.shard_id)
        elif e.kind in ("restart", "heal"):
            self.restart_shard(e.shard_id)
        elif e.kind == "stall":
            self.stall_shard(e.shard_id, e.stall_ms)

    def stall_shard(self, sid: int, stall_ms: float) -> None:
        """Inject ``stall_ms`` of extra latency into every answer from
        this shard (0 clears) — the one-slow-replica scenario."""
        if sid not in self.shards:
            raise KeyError(f"no shard {sid}")
        if stall_ms > 0:
            self._stalled[sid] = float(stall_ms)
        else:
            self._stalled.pop(sid, None)

    def kill_shard(self, sid: int) -> None:
        """The shard process dies: its unflushed write-behind tail is
        lost (``SegmentLog.abandon`` — memory shards lose everything),
        as are the replica holders it hosted.  Reads fail over to a
        proxy rebuilt from the surviving holders."""
        self._down(sid, "kill")

    def partition_shard(self, sid: int) -> None:
        """The shard is unreachable but intact: no data loss, but reads
        fail over exactly as for a kill until :meth:`restart_shard`."""
        self._down(sid, "partition")

    def _down(self, sid: int, kind: str) -> None:
        if sid not in self.shards:
            raise KeyError(f"no shard {sid}")
        if sid in self._dead:
            raise ValueError(f"shard {sid} is already down")
        backend = self.shards[sid].backend
        # snapshot, per holder following this source, the holder-local
        # frontier restart catch-up will ship back from: for a kill only
        # source-durable records survive on the source, so everything
        # after the durable frontier may be the lost tail; a partition
        # loses nothing, only the updates made while unreachable.
        frontier = {}
        for (f, src), h in self._holders.items():
            if src == sid and f not in self._dead:
                frontier[(f, src)] = (h.durable_frontier if kind == "kill"
                                      else h.frontier)
        if kind == "kill":
            log = getattr(backend, "durable_log", None)
            if log is not None:
                log.abandon()         # NOT close(): close would flush
            for key in [k for k in self._holders if k[0] == sid]:
                h = self._holders.pop(key)
                h.abandon()
                if h.kind == "memory":
                    self._designated.pop(key, None)
            kept = None
        else:
            kept = backend
        proxy = self._build_proxy(sid) if self.replication > 1 else None
        self._dead[sid] = _Downed(kind=kind, backend=kept,
                                  frontier=frontier, proxy=proxy)
        self._stalled.pop(sid, None)

    def restart_shard(self, sid: int) -> None:
        """Revive a down shard: recover from its own log (kill) or rejoin
        intact (partition/heal), catch up on missed state from its peers'
        holders via delta segment shipping, and rebuild the holders it
        hosted.  The revived shard is cache-cold, exactly like a real
        restarted process."""
        down = self._dead.get(sid)
        if down is None:
            raise ValueError(f"shard {sid} is not down")
        shard = self.shards[sid]
        self._incarnation[sid] = self._incarnation.get(sid, 0) + 1
        if down.kind == "partition":
            backend = down.backend
        else:
            backend = self._factory(self._shard_cfg(sid, shard.node_names))
        shard.backend = backend
        del self._dead[sid]
        self.restarts += 1
        persistent = getattr(backend, "durable_log", None) is not None
        full = down.kind == "kill" and not persistent
        self._catch_up_primary(sid, backend, down.frontier, full=full)
        # cache-cold on rejoin: a killed shard's caches are empty anyway;
        # a healed partition's are stale (the proxy evolved cache state
        # while it was fenced), so invalidate them wholesale
        for oid, src in self._keys.items():
            if src == sid:
                self._purge_cached(backend, int(oid))
        self._journal[sid] = []       # journal mirrors the fresh backend
        self._resync_after_revival(sid)

    def _catch_up_primary(self, sid: int, backend,
                          frontier: Dict[Tuple[int, int], int],
                          full: bool) -> None:
        """Ship each live holder's post-frontier designated records back
        to the revived primary — the write-behind tail a kill lost, or
        everything a partition missed (``full``: memory-mode kill, ship
        the complete designated state)."""
        for (f, src), h in self._holders.items():
            if src != sid or f in self._dead:
                continue
            desig = self._designated.get((f, src), set())
            if not desig:
                continue
            since = 0 if full else frontier.get((f, src), 0)
            raw = h.export_delta(since, desig)
            if not raw:
                continue
            for oid in self._apply_shipped(backend, raw):
                self._purge_cached(backend, int(oid))
                if backend.store.stat(int(oid)) is not None \
                        or backend.regen.state_of(int(oid)) is not None:
                    self._keys[int(oid)] = sid
        flush = getattr(backend, "flush", None)
        if flush is not None:
            flush()

    def _resync_after_revival(self, sid: int) -> None:
        """After a restart/heal: rebase the stream marks of holders that
        follow this (possibly lsn-shifted) source, and rebuild the
        holders this shard hosts for its peers."""
        if self.replication <= 1:
            return
        inc = self._incarnation.get(sid, 0)
        pos = self._source_position(sid)
        for (f, src), h in self._holders.items():
            if src == sid and f not in self._dead:
                h.set_hwm(pos)        # lsn space may have shifted DOWN
                h.src_inc = inc
                h.checkpoint()
        want = self._desired_designation()
        for (f, src), tgt in want.items():
            if f != sid or src in self._dead or not tgt:
                continue
            h = self._holder_for(f, src)
            cur = self._designated.get((f, src), set())
            src_inc = self._incarnation.get(src, 0)
            # hwm deltas are only meaningful against the same source
            # incarnation AND for continuously designated objects; ship
            # everything else as full current state
            cont = tgt & cur if h.src_inc == src_inc else set()
            spos = self._source_position(src)
            if cont:
                raw = self._export_from(src, h.hwm, cont)
                if raw:
                    h.apply_records(raw, spos)
            new = tgt - cont
            if new:
                raw = self._export_from(src, 0, new)
                if raw:
                    h.apply_records(raw, spos)
            h.set_hwm(self._source_position(src))
            h.src_inc = src_inc
            self._designated[(f, src)] = set(tgt)
            h.checkpoint()

    def _designated_holder_of(self, oid: int, sid: int):
        """The first live holder with this (dead) shard's object."""
        for f in self.replica_shards(oid)[1:]:
            if f in self._dead:
                continue
            h = self._holders.get((f, sid))
            if h is not None and h.contains_any(oid):
                return h
        return None

    def _build_proxy(self, sid: int):
        """Stand-in backend for a down shard: durable/recipe state from
        the live replica holders, cache state by replaying the shard's
        request journal — so failover reads classify exactly as the dead
        shard would have."""
        shard = self.shards[sid]
        cfg = dataclasses.replace(self.cfg, node_names=shard.node_names,
                                  data_dir=None)
        proxy = self._factory(cfg)
        for oid, src in self._keys.items():
            if src != sid:
                continue
            h = self._designated_holder_of(oid, sid)
            if h is None:
                continue
            oid = int(oid)
            blob = h.blob_of(oid)
            if blob is not None:
                proxy.store.put(oid, blob)
            else:
                sz = h.size_of(oid)
                if sz is not None:
                    proxy.store.put_size(oid, sz)
            st = h.recipe_state_of(oid)
            if st is not None:
                proxy.regen.restore_state(oid, st)
        self._replay_journal(proxy, sid)
        return proxy

    def _replay_journal(self, backend, sid: int) -> None:
        """Re-run the shard's cache-state history against a fresh proxy.

        Ops: ``("g", oid, hit_class, image_nbytes)`` per get, ``("x",
        oid)`` per put-overwrite/delete/demote, ``("pw", oid, nbytes)``
        per prewarm.  Cache transitions depend only on the op sequence
        and entry sizes, both of which the journal carries, so the proxy
        ends bit-identical in classification state."""
        walk = backend.walk
        eng = getattr(backend, "engine", None)
        for op in self._journal.get(sid, ()):
            tag, oid = op[0], int(op[1])
            if tag == "x":
                self._purge_cached(backend, oid)
            elif tag == "pw":
                nb = op[2]
                owner = walk._idx[walk.router.ring.owner(oid)]
                if eng is not None:
                    eng.nodes[owner].cache.insert_image(
                        oid, nbytes=(nb if nb is not None
                                     else self.cfg.image_bytes))
                else:
                    walk.caches[owner].store(oid, format="image")
            else:                     # "g"
                _, _, hit_class, nb = op
                owner = walk._idx[walk.router.ring.owner(oid)]
                tier = walk.caches[owner]
                tier.load(oid)
                if hit_class in (FULL_MISS, REGEN_MISS):
                    walk.admit_latent(owner, oid)
                if nb is not None and tier.cache.contains(oid) == "image":
                    tier.cache.set_image_nbytes(oid, nb)
                walk.counts[hit_class] = walk.counts.get(hit_class, 0) + 1

    # -- elastic resharding --------------------------------------------------
    def _check_reshardable(self) -> None:
        if self._dead:
            raise RuntimeError(
                f"cannot reshard while shards are down: "
                f"{sorted(self._dead)} (restart/heal them first)")

    def add_shard(self) -> ReshardReport:
        """Grow the cluster by one shard (K fresh global nodes); migrates
        exactly the keys whose ring owner moved onto the new nodes."""
        self._check_reshardable()
        self._resharding = True
        try:
            shard = self._spawn_shard()
            moved = self._migrate_remapped()
            self._write_meta()
            self._sync_replicas()
        finally:
            self._resharding = False
        return ReshardReport(n_keys=len(self._keys), n_moved=moved,
                             n_shards=self.n_shards, shard_id=shard.shard_id)

    def remove_shard(self, shard_id: int) -> ReshardReport:
        """Drain and drop one shard: its nodes leave the global ring,
        every key it owned migrates to the key's new owner shard, and
        (persistent clusters) its sealed-and-drained log directory is
        closed and deleted — the drained segments hold only tombstoned
        state, so keeping them would leak dead bytes forever."""
        if shard_id not in self.shards:
            raise KeyError(f"no shard {shard_id}")
        if self.n_shards == 1:
            raise ValueError("cannot remove the last shard")
        self._check_reshardable()
        self._resharding = True
        try:
            victim = self.shards[shard_id]
            for n in victim.node_names:
                self.ring.remove_node(n)
                del self._shard_of_node[n]
            moved = self._migrate_remapped()
            del self.shards[shard_id]
            # holders hosted on the victim close before its directory goes
            for key in [k for k in self._holders if k[0] == shard_id]:
                self._holders.pop(key).close()
                self._designated.pop(key, None)
            close = getattr(victim.backend, "close", None)
            if close is not None:
                close()
            vlog = getattr(victim.backend, "durable_log", None)
            if vlog is not None:
                shutil.rmtree(vlog.path, ignore_errors=True)
            self._stalled.pop(shard_id, None)
            self._journal.pop(shard_id, None)
            self._lat_window.pop(shard_id, None)
            self._write_meta()
            self._sync_replicas()     # drops holders FOR the victim too
        finally:
            self._resharding = False
        return ReshardReport(n_keys=len(self._keys), n_moved=moved,
                             n_shards=self.n_shards, shard_id=shard_id)

    def _migrate_remapped(self) -> int:
        # group the remapped keys into per-(src, dst) migration batches so
        # persistent shards ship each batch as ONE sealed segment instead
        # of per-key copies
        batches: Dict[Tuple[int, int], List[int]] = {}
        for oid, old_sid in list(self._keys.items()):
            new_sid = self.shard_of(oid)
            if new_sid != old_sid:
                batches.setdefault((old_sid, new_sid), []).append(oid)
        moved = 0
        for (old_sid, new_sid), oids in batches.items():
            src = self.shards[old_sid].backend
            dst = self.shards[new_sid].backend
            self._move_batch(oids, src, dst)
            for oid in oids:
                self._keys[oid] = new_sid
            moved += len(oids)
        return moved

    def _move_batch(self, oids: Sequence[int], src, dst) -> None:
        """Move one migration batch between shard backends.

        When both sides are log-structured (persistent cluster), the
        source *seals* the batch — the current blob/size + recipe records
        of every moved key, raw bytes, original payloads — and the
        destination ingests it as one fresh sealed segment file: no
        per-key put path, no decompress/re-encode, one fsync.  The source
        then tombstones the moved keys (dead bytes the next compaction
        step reclaims).  Memory-backed shards keep the per-key move.
        """
        slog = getattr(src, "durable_log", None)
        dlog = getattr(dst, "durable_log", None)
        if slog is None or dlog is None:
            for oid in oids:
                self._move(oid, src, dst)
            return
        applied = dlog.ingest_segment(slog.export_records(oids))
        for oid, state in applied["recipes"].items():
            dst.regen.restore_state(oid, state)
        for oid in oids:
            src.delete(oid)                    # tombstones + cache purge
        src.flush()

    @staticmethod
    def _move(oid: int, src, dst) -> None:
        """Move one object's durable/recipe state between shard backends.

        Cache residency and store warmth do NOT move: the key restarts
        cold at its new home, exactly like a production reshard.
        """
        st = src.store.stat(oid)
        blob = src.store.get(oid)
        recipe: Optional[Recipe] = src.regen.recipe_of(oid)
        recipe_nbytes = src.regen.recipe_bytes_of(oid)
        last_access_mo = src.regen.last_access_mo_of(oid)
        demoted = src.regen.is_demoted(oid)
        nbytes = st["nbytes"] if st else 0.0
        src.delete(oid)
        if st is not None:
            if blob is not None:
                dst.store.put(oid, blob)     # rung travels in the bytes
            else:
                dst.store.put_size(oid, nbytes,
                                   rung=st.get("rung") or 0)
        if recipe_nbytes is not None:
            dst.regen.put(oid, nbytes, recipe=recipe,
                          recipe_nbytes=recipe_nbytes,
                          now_mo=last_access_mo or 0.0)
            if demoted:
                dst.regen.demote(oid)

    # -- backend protocol ----------------------------------------------------
    def put(self, oid: int, image=None, latent=None,
            recipe: Optional[Recipe] = None, nbytes: Optional[float] = None,
            prewarm: bool = False) -> PutResult:
        oid = int(oid)
        sid = self.shard_of(oid)
        backend = self._acting_backend(sid)
        res = backend.put(oid, image=image, latent=latent, recipe=recipe,
                          nbytes=nbytes, prewarm=prewarm)
        self._keys[oid] = sid
        if self.replication > 1:
            jrnl = self._journal.setdefault(sid, [])
            jrnl.append(("x", oid))   # overwrite purge (no-op when fresh)
            if res.prewarmed:
                jrnl.append(("pw", oid,
                             backend.walk.pixel_bytes_of(oid) or None))
            self._forward(oid, sid)
            if res.durable:
                self._checkpoint_source(sid)
        return res

    def get_many(self, oids: Sequence[int],
                 timestamps_ms: Optional[Sequence[float]] = None
                 ) -> List[GetResult]:
        """Serve one request window, splitting it at every fault-plan
        boundary: scheduled events fire *before* the request index they
        name, so an injected run is exactly reproducible."""
        oids = [int(o) for o in oids]
        out: List[Optional[GetResult]] = [None] * len(oids)
        i = 0
        while i < len(oids):
            for e in self.fault_plan.pop_due(self._req_index):
                self._apply_event(e)
            n = len(oids) - i
            nxt = self.fault_plan.next_boundary(self._req_index)
            if nxt is not None:
                n = min(n, nxt - self._req_index)
            ts = (timestamps_ms[i:i + n]
                  if timestamps_ms is not None else None)
            for k, r in enumerate(self._serve_segment(oids[i:i + n], ts)):
                out[i + k] = r
            i += n
            self._req_index += n
        if self.autoscaler is not None:
            self._autoscale_step()
        return out  # type: ignore[return-value]

    # -- cluster-level elastic autoscaling (the shard knob) ------------------
    def _scale_down_safe(self) -> bool:
        """Scale-down safety hook handed to the controller: a shard may
        only be removed from a fully live, quiescent cluster with live
        shards to spare beyond the replication factor."""
        return (not self._dead and not self._resharding
                and self.n_shards > 1
                and len(self.live_shard_ids) > self.replication)

    def _cluster_busy_ms(self) -> float:
        busy = 0.0
        for sid in self.live_shard_ids:
            b = self.shards[sid].backend
            if hasattr(b, "gpus"):                       # sim backend
                busy += sum(q.busy_ms for q in b.gpus)
            else:                                        # engine backend
                busy += b.engine.batcher.busy_ms
        return busy

    def _cluster_clock_ms(self) -> float:
        clocks = [b.clock_ms for sid in self.live_shard_ids
                  if hasattr(b := self.shards[sid].backend, "clock_ms")]
        if clocks:
            return max(clocks)
        return self.cfg.now_s() * 1e3                    # engine: wall clock

    def _autoscale_step(self) -> None:
        from repro_torch.core.autoscale import WindowObs
        mark = self._as_mark
        if self._req_index - mark["reqs"] < self.autoscaler.cfg.window:
            return
        if self._dead or self._resharding:
            return                     # observe only a quiescent cluster
        clock = self._cluster_clock_ms()
        busy = self._cluster_busy_ms()
        # queue-delay tail over the window: per-shard log tails since each
        # shard's last mark (engine shards have no plant log -> no signal)
        samples: List[float] = []
        log_marks: Dict[int, int] = {}
        for sid in self.live_shard_ids:
            log = getattr(self.shards[sid].backend, "log", None)
            if log is None:
                continue
            n = len(log.queue_ms)
            samples.extend(log.queue_ms[mark["logs"].get(sid, 0):n])
            log_marks[sid] = n
        obs = WindowObs(
            requests=self._req_index - mark["reqs"],
            span_ms=max(0.0, clock - mark["clock"]),
            # busy can regress when a shard (and its counters) was removed
            busy_ms=max(0.0, busy - mark["busy"]),
            decode_frac=1.0,
            queue_p99_ms=(float(np.percentile(np.asarray(samples), 99))
                          if samples else 0.0))
        self._as_mark = {"reqs": self._req_index, "clock": clock,
                         "busy": busy, "logs": log_marks}
        ev = self.autoscaler.step(obs)
        if ev is None:
            return
        if ev.action == "shard_up":
            self.add_shard()
        elif ev.action == "shard_down":
            self.remove_shard(max(self.live_shard_ids))
        # topology changed under the marks: restart the window cleanly
        self._as_mark = {"reqs": self._req_index,
                         "clock": self._cluster_clock_ms(),
                         "busy": self._cluster_busy_ms(), "logs": {}}
        # keep the controller's plant in lockstep with reality (an action
        # other than the shard knob cannot happen here, but be exact)
        if self.autoscaler.state.n_shards != self.n_shards:
            self.autoscaler.state = dataclasses.replace(
                self.autoscaler.state, n_shards=self.n_shards)

    def _serve_segment(self, oids: List[int],
                       timestamps_ms) -> List[GetResult]:
        """Scatter one fault-free stretch of requests to the acting shard
        backends (order preserved within each shard), gather back into
        request order with node indices remapped into the global
        namespace, then apply the resilience post-passes: stall latency,
        hedging, journaling, and regeneration forwarding."""
        replicated = self.replication > 1
        groups: Dict[int, List[int]] = {}
        for k, oid in enumerate(oids):
            groups.setdefault(self.shard_of(oid), []).append(k)
        out: List[Optional[GetResult]] = [None] * len(oids)
        for sid, idxs in groups.items():
            shard = self.shards[sid]
            down = self._dead.get(sid)
            backend = self._acting_backend(sid)
            sub = [oids[k] for k in idxs]
            ts = ([float(timestamps_ms[k]) for k in idxs]
                  if timestamps_ms is not None else None)
            stall = self._stalled.get(sid, 0.0)
            jrnl = self._journal.setdefault(sid, []) if replicated else None
            win = None
            if replicated:
                win = self._lat_window.setdefault(
                    sid, deque(maxlen=self.hedge.window))
            for k, oid, r in zip(idxs, sub,
                                 backend.get_many(sub, timestamps_ms=ts)):
                r.node = _global_node_index(shard.node_names[r.node])
                if r.exec_node >= 0:
                    r.exec_node = _global_node_index(
                        shard.node_names[r.exec_node])
                if down is not None:
                    r.failover = True
                    self.failovers += 1
                if stall:
                    r.latency_ms["stall"] = stall
                    r.latency_ms["total"] = r.total_ms + stall
                dec = r.latency_ms.get("decode", 0.0)
                if dec > 0.0:
                    self._decode_ewma = 0.9 * self._decode_ewma + 0.1 * dec
                self._maybe_hedge(sid, oid, r)
                if replicated:
                    jrnl.append(("g", oid, r.hit_class,
                                 float(r.payload.nbytes)
                                 if r.payload is not None else None))
                    win.append(r.total_ms)
                    if r.regenerated:
                        # read-path regeneration is a hidden durable
                        # mutation (readmitted latent) — replicate it
                        self._forward(oid, sid)
                out[k] = r
        if replicated:
            for sid in groups:
                self._checkpoint_source(sid)
        return out  # type: ignore[return-value]

    # -- hedged reads --------------------------------------------------------
    def _hedge_delay_ms(self, sid: int) -> Optional[float]:
        """Adaptive hedge delay for reads served by ``sid``: a percentile
        of the OTHER live shards' recent latencies — a stalling shard
        cannot talk the cluster out of hedging against it.  None until
        enough peer samples exist."""
        samples: List[float] = []
        for other, win in self._lat_window.items():
            if other != sid and other not in self._dead:
                samples.extend(win)
        if len(samples) < self.hedge.min_samples:
            return None
        return max(self.hedge.min_delay_ms,
                   float(np.percentile(np.asarray(samples),
                                       100.0 * self.hedge.quantile)))

    def _hedge_fetch_ms(self, oid: int, rep_sid: int, holder) -> float:
        """Cost of the speculative replica fetch leg.  Engine: measured
        wall clock of the actual holder read (the blob really is read —
        hedging is the fetch race).  Sim: a seeded cold-read draw from
        the cluster's store-latency model, deterministic per (oid,
        replica)."""
        if self._mode == "engine":
            t0 = time.perf_counter()
            holder.blob_of(oid)
            return (time.perf_counter() - t0) * 1e3
        m = self.cfg.store_latency
        rng = np.random.default_rng((self.cfg.seed, 0x48ED6E,
                                     int(oid) & 0xFFFFFFFF, rep_sid))
        base = max(float(rng.lognormal(np.log(m.cold_ms), m.sigma)),
                   m.first_byte_floor_ms)
        sz = holder.size_of(oid) or self.cfg.latent_bytes
        return base + sz / (m.bandwidth_mb_s * 1e6) * 1e3

    def _maybe_hedge(self, sid: int, oid: int, r: GetResult) -> None:
        """Post-hoc hedged-read accounting: when the primary's answer
        exceeded the hedge delay, a speculative fetch to the next live
        replica would have been in flight; if the modeled replica path
        beats the primary, the request's latency is the hedged one.
        Only latency changes — the primary still produced the (single)
        decode and all cache transitions, so hedging can never perturb
        classification, pixels, or decode counts."""
        hc = self.hedge
        if (not hc.enabled or self.replication <= 1 or r.failover
                or self.n_shards < 2):
            return
        delay = self._hedge_delay_ms(sid)
        if delay is None or r.total_ms <= delay:
            return
        target, holder = None, None
        for f in self.replica_shards(oid)[1:]:
            if f in self._dead:
                continue
            h = self._holders.get((f, sid))
            if h is not None and h.contains_any(oid):
                target, holder = f, h
                break
        if target is None:
            return
        self.hedges_fired += 1
        fetch = self._hedge_fetch_ms(oid, target, holder)
        decode = r.latency_ms.get("decode", 0.0)
        if decode <= 0.0:             # replica must decode even our hits
            decode = self._decode_ewma
        t_hedge = (delay + hc.net_hop_ms + fetch + decode
                   + r.latency_ms.get("regen", 0.0)
                   + r.latency_ms.get("net", 0.0)
                   + self._stalled.get(target, 0.0))
        if t_hedge < r.total_ms:
            self.hedge_wins += 1
            r.hedged = True
            r.latency_ms["unhedged_total"] = r.total_ms
            r.latency_ms["hedge_fetch"] = fetch
            r.latency_ms["total"] = t_hedge

    # -- remaining backend protocol ------------------------------------------
    def delete(self, oid: int) -> bool:
        oid = int(oid)
        sid = self.shard_of(oid)
        self._keys.pop(oid, None)
        found = self._acting_backend(sid).delete(oid)
        if self.replication > 1:
            self._journal.setdefault(sid, []).append(("x", oid))
            self._forward(oid, sid)   # ships the tombstones
            if not self.cfg.write_behind:
                self._checkpoint_source(sid)
        return found

    def demote(self, oid: int, rung=None) -> bool:
        oid = int(oid)
        sid = self.shard_of(oid)
        found = self._acting_backend(sid).demote(oid, rung)
        if found and self.replication > 1:
            if resolve_rung(rung).is_recipe:
                # recipe demotion drops cached copies cluster-wide; a
                # lossy-rung demotion leaves caches alone by design
                self._journal.setdefault(sid, []).append(("x", oid))
            self._forward(oid, sid)
            if not self.cfg.write_behind:
                self._checkpoint_source(sid)
        return found

    def promote(self, oid: int) -> bool:
        oid = int(oid)
        sid = self.shard_of(oid)
        found = self._acting_backend(sid).promote(oid)
        if found and self.replication > 1:
            self._forward(oid, sid)   # regenerated blob is durable again
            if not self.cfg.write_behind:
                self._checkpoint_source(sid)
        return found

    def stat(self, oid: int) -> Optional[ObjectStat]:
        return self._acting_backend(self.shard_of(oid)).stat(int(oid))

    def pixels_resident(self, oid: int) -> bool:
        """Pure peek: pixel-cache residency on the owning shard's acting
        backend (degrade-mode admission support)."""
        backend = self._acting_backend(self.shard_of(oid))
        probe = getattr(backend, "pixels_resident", None)
        return bool(probe(int(oid))) if probe is not None else False

    def flush(self) -> None:
        for sid in self.shard_ids:
            b = self._acting_or_none(sid)
            flush = getattr(b, "flush", None) if b is not None else None
            if flush is not None:
                flush()
        for (f, src), h in self._holders.items():
            if f not in self._dead and src not in self._dead:
                h.checkpoint()

    def close(self) -> None:
        self.flush()                  # sources durable before holders claim so
        for h in self._holders.values():
            h.close()
        self._holders.clear()
        for sid in self.shard_ids:
            down = self._dead.get(sid)
            if down is None:
                b = self.shards[sid].backend
            elif down.kind == "partition":
                b = down.backend      # intact: a clean close flushes it
            else:
                continue              # killed: its log is already abandoned
            close = getattr(b, "close", None)
            if close is not None:
                close()

    # -- introspection -------------------------------------------------------
    def residency_shards(self, oid: int) -> List[int]:
        """Every shard holding PRIMARY residency for ``oid`` — the
        conformance harness asserts this is at most the one owning shard
        (replica holders are not backend residency)."""
        out = []
        for sid in self.shard_ids:
            b = self._acting_or_none(sid)
            if b is not None and b.stat(int(oid)) is not None:
                out.append(sid)
        return out

    def under_replicated_objects(self) -> int:
        """Objects with fewer live copies (primary backend + designated
        live holders) than ``min(replication, live shards)`` — the
        catch-up acceptance gate: 0 again after every restart."""
        if self.replication <= 1:
            return 0
        n_live = len(self.live_shard_ids)
        n = 0
        for oid, src in self._keys.items():
            oid = int(oid)
            target = min(self.replication, n_live)
            copies = 0
            if src not in self._dead:
                b = self.shards[src].backend
                if b.store.stat(oid) is not None \
                        or b.regen.state_of(oid) is not None:
                    copies += 1
            for f in self.replica_shards(oid)[1:]:
                if f in self._dead:
                    continue
                h = self._holders.get((f, src))
                if h is not None and h.contains_any(oid):
                    copies += 1
            if copies < target:
                n += 1
        return n

    def shard_summaries(self) -> Dict[int, Dict[str, Any]]:
        return {sid: b.summary() for sid in self.shard_ids
                if (b := self._acting_or_none(sid)) is not None}

    _SUMMED = ("image_hit", "latent_hit", "full_miss", "regen_miss",
               "spilled", "total", "cache_resident_bytes", "durable_bytes",
               "recipe_bytes", "decode_batches", "decodes",
               "coalesced_decodes", "decompressions",
               "decompress_memo_hits", "pixel_cached_objects",
               "pixel_cached_bytes",
               # persistent clusters: on-disk truth sums across shard logs
               "durable_disk_bytes", "durable_live_bytes",
               "durable_segments", "segments_compacted",
               # decode-fleet observability + provisioned-cost integrals
               "gpu_seconds", "decode_gpus", "provisioned_gpu_ms",
               "provisioned_cache_byte_ms",
               # per-shard gpu/cache controllers' event counts
               "scale_up_events", "scale_down_events")

    def summary(self) -> Dict[str, Any]:
        """Cluster-level stats: additive counters sum across shards, alpha
        reports per node in global order, hit fractions recompute from the
        summed counts (``shard_summaries()`` keeps the per-shard view).
        Down shards report through their failover proxies (whose journal
        replay preserves the lifetime hit counts)."""
        per = [b.summary() for sid in self.shard_ids
               if (b := self._acting_or_none(sid)) is not None]
        out: Dict[str, Any] = {"n_shards": self.n_shards,
                               "n_nodes": self.n_nodes}
        for key in self._SUMMED:
            vals = [s[key] for s in per if key in s]
            if vals:
                out[key] = type(vals[0])(sum(vals))
        out["alpha"] = [a for s in per for a in s.get("alpha", [])]
        if per and "sim_clock_ms" in per[0]:
            out["sim_clock_ms"] = max(s["sim_clock_ms"] for s in per)
        total = out.get("total", 0)
        if total:
            out["image_hit_frac"] = out["image_hit"] / total
            out["decode_frac"] = 1.0 - out["image_hit_frac"]
        # ratio recomputes from the summed counters (a mean of per-shard
        # ratios would weight empty shards wrong)
        if out.get("pixel_cached_objects"):
            out["pixel_bytes_per_object"] = (
                out["pixel_cached_bytes"] / out["pixel_cached_objects"])
        elif per and "pixel_bytes_per_object" in per[0]:
            out["pixel_bytes_per_object"] = per[0]["pixel_bytes_per_object"]
        # cluster write amplification recomputes from the summed byte
        # counters (a mean of per-shard ratios would weight idle shards
        # wrong, same argument as the hit fractions above)
        logs = [lg for sid in self.shard_ids
                if (b := self._acting_or_none(sid)) is not None
                and (lg := getattr(b, "durable_log", None)) is not None]
        if logs:
            user = sum(lg.user_bytes_written for lg in logs)
            rewrite = sum(lg.rewrite_bytes_written for lg in logs)
            out["write_amplification"] = ((user + rewrite) / user
                                          if user else 1.0)
        # cluster decode utilization recomputes from the summed integrals
        # (time-weighted across resizes; a mean of per-shard utilizations
        # would weight idle shards wrong)
        if out.get("provisioned_gpu_ms"):
            out["decode_util"] = (out.get("gpu_seconds", 0.0) * 1e3
                                  / out["provisioned_gpu_ms"])
        if self.autoscaler is not None:
            # merge the cluster (shard-knob) controller's events into the
            # summed per-shard counters; topology keys come from reality
            cs = self.autoscaler.summary()
            out["scale_up_events"] = (out.get("scale_up_events", 0)
                                      + cs["scale_up_events"])
            out["scale_down_events"] = (out.get("scale_down_events", 0)
                                        + cs["scale_down_events"])
            out["autoscale_shards"] = self.n_shards
            out["autoscale_windows"] = cs["autoscale_windows"]
        out["replication"] = self.replication
        if self.replication > 1 or self._dead or self.fault_plan.fired:
            out["failovers"] = self.failovers
            out["hedges_fired"] = self.hedges_fired
            out["hedge_wins"] = self.hedge_wins
            out["restarts"] = self.restarts
            out["dead_shards"] = sorted(self._dead)
            out["under_replicated_objects"] = self.under_replicated_objects()
            out["replica_disk_bytes"] = int(sum(
                h.disk_bytes for h in self._holders.values()))
        out.update(self._latency_stats())
        return out

    def _latency_stats(self) -> Dict[str, float]:
        """Exact cluster-level latency stats from the union of the acting
        backends' request logs (percentiles cannot be aggregated from
        per-shard summaries).  Empty for backends without a log (engine).
        A killed shard's pre-kill samples die with its process — its
        proxy's log covers the failover era only."""
        lats: List[float] = []
        for sid in self.shard_ids:
            b = self._acting_or_none(sid)
            if b is None:
                continue
            log = getattr(b, "log", None)
            if log is None:
                return {}
            lats.extend(log.latency_ms)
        if not lats:
            return {}
        arr = np.asarray(lats)
        return {"mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p95_ms": float(np.percentile(arr, 95)),
                "p99_ms": float(np.percentile(arr, 99))}

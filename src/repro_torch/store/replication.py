"""Replica holders — the storage side of R-way shard replication.

Placement walks the consistent-hash ring: an object's replica set is the
first R *distinct shards* among ``ring.successors(oid)`` (the first is the
primary, i.e. the owner).  Every non-primary replica shard hosts one
*holder* per source shard it follows — a small write-behind copy of the
source's durable state for exactly the objects designated to that
(follower, source) pair.

Two holder kinds, one interface:

``LogReplicaHolder``
    A :class:`~repro.store.durable.log.SegmentLog` nested under the
    follower shard's directory (``shard00N/replica-of-00M/``) plus an
    atomically replaced ``HWM.json`` sidecar.  Shipped records are applied
    *state-wise with local lsns* — the holder never tries to merge the
    source's lsn space into its own, which makes re-shipping (catch-up
    after downtime, R=3 duplicate deliveries) idempotent by construction:
    a re-applied record is the same current state appended again, never a
    rollback.

``MemoryReplica``
    Dict-backed equivalent for memory-mode clusters (simulation /
    in-memory engine); "lsns" are application indices.

Two watermarks, two directions:

``hwm``
    The *source-stream* position (source lsn for persistent sources, a
    cluster-kept per-source sequence for memory sources) the holder has
    durably seen.  Used when the *holder's* shard comes back: the source
    re-ships ``export_delta(holder.hwm, designated)`` — only the delta.

``durable_frontier``
    The holder's *local* position as of the source's last durability
    barrier.  Snapshotted when the *source* shard is killed: everything
    the holder applied after that point may be exactly the write-behind
    tail the source lost, so restart catch-up ships
    ``holder.export_delta(frontier, designated)`` back to the source.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.store.durable.log import (NS_OBJECT, NS_RECIPE, NS_RUNG,
                                     SegmentLog)
from repro_torch.store.durable.segment import (BLOB, RDEL, RSTATE, RUNG, SIZE,
                                         TOMB, pack_record,
                                         pack_size_payload, scan_records,
                                         unpack_size_payload)

HWM_FILE = "HWM.json"

_NS_OF = {BLOB: NS_OBJECT, SIZE: NS_OBJECT, TOMB: NS_OBJECT,
          RSTATE: NS_RECIPE, RDEL: NS_RECIPE, RUNG: NS_RUNG}


@dataclasses.dataclass(frozen=True)
class HedgeConfig:
    """Hedged-read policy (Dean & Barroso tail-at-scale style).

    A read whose primary exceeds the adaptive *hedge delay* fires a
    speculative fetch to the next replica; the first response wins.  The
    delay is a percentile of the recent latencies of the *other* live
    shards — a shard that stalls cannot talk the cluster out of hedging
    against it.  Hedging races only the durable *fetch* leg: the decode
    stays single-flight, so a won hedge never costs a second decode.
    """

    enabled: bool = True
    quantile: float = 0.95      # hedge delay = this pct of peer latencies
    min_delay_ms: float = 1.0   # floor: never hedge essentially instantly
    window: int = 64            # per-shard latency samples retained
    min_samples: int = 8        # below this, no hedging (delay unknown)
    net_hop_ms: float = 0.25    # modeled extra hop to a non-owner replica


def pack_state_records(oid: int, store, regen, lsn: int) -> bytes:
    """Snapshot one object's current durable state (both namespaces,
    absence shipped as TOMB/RDEL) as a raw segment image — the forwarding
    unit for *memory-mode* sources, which have no
    :meth:`~repro.store.durable.log.SegmentLog.export_delta` to call.
    ``lsn`` is the cluster's per-source forwarding sequence; holders use
    it only as the source-stream high-water mark."""
    oid = int(oid)
    parts = []
    st = store.stat(oid)
    if st is None:
        parts.append(pack_record(lsn, TOMB, oid, b""))
    elif st["has_payload"]:
        parts.append(pack_record(lsn, BLOB, oid, store.get(oid)))
    else:
        parts.append(pack_record(lsn, SIZE, oid,
                                 pack_size_payload(st["nbytes"],
                                                   st.get("rung") or 0)))
    state = regen.state_of(oid)
    if state is None:
        parts.append(pack_record(lsn + 1, RDEL, oid, b""))
    else:
        parts.append(pack_record(
            lsn + 1, RSTATE, oid,
            json.dumps(state, sort_keys=True).encode()))
    return b"".join(parts)


class MemoryReplica:
    """Dict-backed holder: latest (kind, payload) per slot, application
    indices for lsns.  Nothing survives the process — a memory-mode
    restart always re-ships full state, so ``hwm``/``durable_frontier``
    only matter within one process lifetime."""

    kind = "memory"

    def __init__(self):
        # (ns, oid) -> (local_lsn, kind, payload)
        self._slots: Dict[Tuple[int, int], Tuple[int, int, bytes]] = {}
        self._lsn = 0
        self.hwm = 0
        self.durable_frontier = 0
        #: source incarnation this holder last synced against (the cluster
        #: bumps it on every source restart — a mismatch means the source's
        #: lsn space shifted and hwm deltas are meaningless)
        self.src_inc = 0

    # -- write path -----------------------------------------------------------
    def apply_records(self, raw: bytes, source_hwm: int = 0) -> int:
        recs, valid_end = scan_records(raw, 0)
        if valid_end != len(raw):
            raise ValueError(
                f"replica shipment is corrupt: checksum/framing failure at "
                f"byte {valid_end} of {len(raw)}; nothing applied")
        for r in recs:
            self._lsn += 1
            self._slots[(_NS_OF[r.kind], r.oid)] = (self._lsn, r.kind,
                                                    r.payload)
        self.hwm = max(self.hwm, int(source_hwm))
        return len(recs)

    def discard(self, oid: int) -> None:
        """De-designation: record both namespaces as absent (kept as
        tombstone slots so accounting stays uniform with the log holder;
        never shipped — exports always filter by the designated set)."""
        oid = int(oid)
        for ns, kind in ((NS_OBJECT, TOMB), (NS_RECIPE, RDEL)):
            if (ns, oid) in self._slots:
                self._lsn += 1
                self._slots[(ns, oid)] = (self._lsn, kind, b"")

    def checkpoint(self) -> None:
        self.durable_frontier = self._lsn

    def set_hwm(self, pos: int) -> None:
        """Directly (re)base the source-stream mark — used after a full
        reconcile, when the source's lsn space may have *shifted down*
        (crash-truncated tail) and ``max`` would keep a stale mark."""
        self.hwm = int(pos)

    def abandon(self) -> None:                   # memory: kill loses all
        self._slots.clear()
        self._lsn = 0
        self.hwm = 0
        self.durable_frontier = 0

    def close(self) -> None:
        pass

    # -- read path ------------------------------------------------------------
    @property
    def frontier(self) -> int:
        return self._lsn

    def _slot(self, ns: int, oid: int, dead_kind: int):
        s = self._slots.get((ns, int(oid)))
        return None if s is None or s[1] == dead_kind else s

    def has_object(self, oid: int) -> bool:
        return self._slot(NS_OBJECT, oid, TOMB) is not None

    def contains_any(self, oid: int) -> bool:
        return (self._slot(NS_OBJECT, oid, TOMB) is not None
                or self._slot(NS_RECIPE, oid, RDEL) is not None)

    def blob_of(self, oid: int) -> Optional[bytes]:
        s = self._slot(NS_OBJECT, oid, TOMB)
        return s[2] if s is not None and s[1] == BLOB else None

    def size_of(self, oid: int) -> Optional[float]:
        s = self._slot(NS_OBJECT, oid, TOMB)
        if s is None:
            return None
        return float(len(s[2])) if s[1] == BLOB \
            else unpack_size_payload(s[2])

    def recipe_state_of(self, oid: int) -> Optional[Dict[str, Any]]:
        s = self._slot(NS_RECIPE, oid, RDEL)
        return json.loads(s[2].decode()) if s is not None else None

    def object_oids(self) -> Iterator[int]:
        for (ns, oid), (_, kind, _p) in self._slots.items():
            if ns == NS_OBJECT and kind != TOMB:
                yield oid

    def live_oids(self) -> set:
        """Every oid with a live slot in either namespace — the candidate
        set for shipping a holder's state back to a recovering source
        (discarded oids are tombstoned in both namespaces, so they are
        excluded by construction)."""
        out = set()
        for (ns, oid), (_, kind, _p) in self._slots.items():
            if (ns == NS_OBJECT and kind != TOMB) \
                    or (ns == NS_RECIPE and kind != RDEL):
                out.add(oid)
        return out

    def export_delta(self, since_lsn: int, oids=None) -> bytes:
        want = None if oids is None else {int(o) for o in oids}
        picked = sorted(
            (lsn, kind, oid, payload)
            for (ns, oid), (lsn, kind, payload) in self._slots.items()
            if lsn > since_lsn and (want is None or oid in want))
        return b"".join(pack_record(lsn, kind, oid, payload)
                        for lsn, kind, oid, payload in picked)

    @property
    def disk_bytes(self) -> int:
        return 0


class LogReplicaHolder:
    """Persistent holder: a nested :class:`SegmentLog` plus the ``hwm``
    sidecar.  The sidecar is written only at :meth:`checkpoint` (after the
    holder's own flush), so a crash can only *understate* the hwm — the
    source then re-ships a delta the holder already has, and state-wise
    application makes that a no-op rather than a rollback."""

    kind = "log"

    def __init__(self, path: str, *, segment_bytes: float = 4e6,
                 fsync: bool = False):
        self.path = os.path.abspath(str(path))
        self.log = SegmentLog(self.path, segment_bytes=segment_bytes,
                              fsync=fsync)
        hwm, frontier = self._load_sidecar()
        self.hwm = hwm
        # Records at or below the checkpointed frontier were flushed when
        # it was written, so they survived any crash and the recovered log
        # reaches at least that far; records after it are NOT known to be
        # source-durable (the sidecar is older than they are).
        self.durable_frontier = min(frontier, self.log.next_lsn - 1)
        self.src_inc = 0

    def _load_sidecar(self):
        try:
            with open(os.path.join(self.path, HWM_FILE)) as f:
                d = json.load(f)
            return int(d["hwm"]), int(d.get("frontier", 0))
        except (OSError, ValueError, KeyError):
            return 0, 0

    def _write_sidecar(self) -> None:
        tmp = os.path.join(self.path, HWM_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"hwm": self.hwm,
                       "frontier": self.durable_frontier}, f)
            f.flush()
            if self.log.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, HWM_FILE))

    # -- write path -----------------------------------------------------------
    def apply_records(self, raw: bytes, source_hwm: int = 0) -> int:
        recs, valid_end = scan_records(raw, 0)
        if valid_end != len(raw):
            raise ValueError(
                f"replica shipment is corrupt: checksum/framing failure at "
                f"byte {valid_end} of {len(raw)}; nothing applied")
        for r in recs:
            self.log.append(r.kind, r.oid, r.payload)   # local lsn
        self.hwm = max(self.hwm, int(source_hwm))
        return len(recs)

    def discard(self, oid: int) -> None:
        oid = int(oid)
        if self.log._obj_slot(oid) is not None:
            self.log.tombstone(oid)
        if self.log.recipe_state_of(oid) is not None:
            self.log.delete_recipe(oid)

    def checkpoint(self) -> None:
        self.log.flush()
        self.durable_frontier = self.log.next_lsn - 1
        self._write_sidecar()

    def set_hwm(self, pos: int) -> None:
        self.hwm = int(pos)

    def abandon(self) -> None:
        self.log.abandon()

    def close(self) -> None:
        if not self.log.closed:
            self.checkpoint()
            self.log.close()

    # -- read path ------------------------------------------------------------
    @property
    def frontier(self) -> int:
        return self.log.next_lsn - 1

    def has_object(self, oid: int) -> bool:
        return self.log.contains_object(oid)

    def contains_any(self, oid: int) -> bool:
        return (self.log.contains_object(oid)
                or self.log.recipe_state_of(oid) is not None)

    def blob_of(self, oid: int) -> Optional[bytes]:
        return self.log.get_blob(oid)

    def size_of(self, oid: int) -> Optional[float]:
        return self.log.size_of(oid)

    def recipe_state_of(self, oid: int) -> Optional[Dict[str, Any]]:
        return self.log.recipe_state_of(oid)

    def object_oids(self) -> Iterator[int]:
        return self.log.object_oids()

    def live_oids(self) -> set:
        return set(self.log.object_oids()) | set(self.log.recipe_states())

    def export_delta(self, since_lsn: int, oids=None) -> bytes:
        return self.log.export_delta(since_lsn, oids=oids)

    @property
    def disk_bytes(self) -> int:
        return self.log.on_disk_bytes

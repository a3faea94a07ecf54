"""Durable object store (paper: AWS S3) over a pluggable byte backend.

Source of truth for every object.  Since the log-structured-store refactor
this class is a thin façade: *where bytes live* is delegated to a
:class:`~repro.store.durable.backend.DurableBackend` — the in-memory
:class:`~repro.store.durable.backend.MemoryBackend` by default (simulation
conformance; nothing survives the process), or a
:class:`~repro.store.durable.backend.SegmentLogBackend` when the box is
opened on a directory (``LatentBox.open(path)``), in which case every
acknowledged put is an on-disk, checksummed, crash-recoverable record.

What stays here is the store's *performance model* and per-process
bookkeeping: fetch latency the way §6.3.3 characterizes it — cold,
long-tail objects see higher and more variable latency than objects kept
warm by the store's own internal caching layers (the Decode-All effect):

    fetch_ms = lognormal(base)  +  nbytes / effective_bandwidth

with the lognormal median dropping from ``cold_ms`` to ``warm_ms`` when the
object was fetched within ``warm_window_s``.  Warmth and latency epochs are
deliberately NOT durable state: a reopened store serves every byte
bit-exact but starts cold, exactly like a store node rejoining a fleet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

#: The canonical "I don't know this object's size" accounting default —
#: a 0.28 MB compressed SD3.5-class latent (paper Table 1b).  Re-exported
#: as :data:`repro.store.api.DEFAULT_OBJECT_BYTES` (the public name);
#: defined here because ``core`` modules cannot import ``repro.store``
#: at module scope without a cycle.
DEFAULT_OBJECT_BYTES = 0.28e6


@dataclasses.dataclass(frozen=True)
class StoreLatencyModel:
    warm_ms: float = 55.0           # lognormal median, recently-touched object
    cold_ms: float = 110.0          # lognormal median, cold object
    sigma: float = 0.35             # lognormal shape (tail heaviness)
    bandwidth_mb_s: float = 30.0    # effective single-stream S3 throughput
    warm_window_s: float = 600.0    # store-side warmth horizon
    first_byte_floor_ms: float = 15.0


class LatentStore:
    """Object store: id -> payload bytes (or just a size for simulation)."""

    def __init__(self, latency: Optional[StoreLatencyModel] = None,
                 seed: int = 0, backend=None):
        self.latency = latency or StoreLatencyModel()
        if backend is None:
            # deferred: repro.store imports this module at its own top level
            from repro_torch.store.durable.backend import MemoryBackend
            backend = MemoryBackend()
        self.backend = backend
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._last_fetch_s: Dict[int, float] = {}
        self._epoch: Dict[int, int] = {}    # bumped on delete: re-put objects
        #                                     draw from a fresh latency stream
        self.n_fetches = 0
        self.bytes_fetched = 0.0

    # -- durable writes --------------------------------------------------------
    def put(self, oid: int, blob: bytes) -> None:
        self.backend.put_blob(oid, blob)

    def put_size(self, oid: int, nbytes: float, rung: int = 0) -> None:
        """Register an object by size only (simulation mode).  ``rung``
        tags which rate-distortion rung the nominal bytes represent."""
        self.backend.put_size(oid, float(nbytes), int(rung))

    def get(self, oid: int) -> Optional[bytes]:
        return self.backend.get_blob(oid)

    def size_of(self, oid: int,
                default: float = DEFAULT_OBJECT_BYTES) -> float:
        sz = self.backend.size_of(oid)
        return default if sz is None else sz

    @property
    def total_bytes(self) -> float:
        return self.backend.total_bytes

    def __contains__(self, oid: int) -> bool:
        return self.backend.contains(oid)

    # -- rate-distortion ladder --------------------------------------------------
    def rung_of(self, oid: int) -> Optional[int]:
        """Ladder rung the object's durable bytes sit at (None: absent)."""
        return self.backend.rung_of(oid)

    def target_rung_of(self, oid: int) -> Optional[int]:
        """Pending demotion target (segment-log backend only), or None."""
        return self.backend.target_rung_of(oid)

    def set_target_rung(self, oid: int, rung: int) -> bool:
        """Demote the object to a colder rung: eager on the memory
        backend, piggybacked on the next compaction pass on the log."""
        return self.backend.set_target_rung(oid, int(rung))

    # -- durability hooks --------------------------------------------------------
    def flush(self) -> None:
        """Crash-durability barrier (no-op on the memory backend)."""
        self.backend.flush()

    def maybe_compact(self) -> int:
        """One bounded online-compaction step (no-op in memory)."""
        return self.backend.maybe_compact()

    def close(self) -> None:
        self.backend.close()

    # -- lifecycle ---------------------------------------------------------------
    def delete(self, oid: int) -> bool:
        """Remove an object's durable payload AND size record (presence is
        ``size or blob``, so a demoted object must lose both to read as
        absent).  Clears ``_last_fetch_s`` too, so a re-created object
        starts cold instead of inheriting warmth from a deleted namesake —
        and bumps the object's latency epoch, so a re-put namesake draws
        from a fresh per-call seed stream instead of replaying the deleted
        object's fetch-latency samples."""
        found = self.backend.delete(oid)
        self._last_fetch_s.pop(oid, None)
        if found:
            self._epoch[oid] = self._epoch.get(oid, 0) + 1
        return found

    def stat(self, oid: int) -> Optional[Dict[str, float]]:
        """Non-mutating metadata probe: never samples the latency RNG and
        never warms the object (unlike :meth:`fetch_ms`)."""
        if oid not in self:
            return None
        return {
            "nbytes": self.size_of(oid),
            "has_payload": self.backend.has_blob(oid),
            "last_fetch_s": self._last_fetch_s.get(oid, float("-inf")),
            "epoch": self._epoch.get(oid, 0),
            "rung": self.backend.rung_of(oid),
            "target_rung": self.backend.target_rung_of(oid),
        }

    # -- modeled fetch ----------------------------------------------------------
    def fetch_ms(self, oid: int, now_s: float,
                 nbytes: Optional[float] = None,
                 seq: Optional[int] = None) -> float:
        """Sample a fetch latency and record the access (warming the object).

        With the default ``seq=None`` samples come from one shared RNG
        stream, so the latency an individual request sees depends on global
        request ordering.  Passing a per-call ``seq`` (e.g. the request's
        trace index) draws from an independent stream keyed on
        ``(store seed, oid epoch, oid, seq)`` instead, making each
        request's sample reproducible under request reordering.  The epoch
        bumps on :meth:`delete`, so deleting and re-putting an object id
        yields fresh (but still reorder-stable) latencies rather than a
        replay of the dead object's stream.
        """
        m = self.latency
        warm = (now_s - self._last_fetch_s.get(oid, -np.inf)) <= m.warm_window_s
        median = m.warm_ms if warm else m.cold_ms
        rng = self._rng if seq is None else np.random.default_rng(
            (self._seed, self._epoch.get(oid, 0),
             int(oid) & 0xFFFFFFFF, int(seq)))
        base = float(rng.lognormal(np.log(median), m.sigma))
        base = max(base, m.first_byte_floor_ms)
        size = self.size_of(oid) if nbytes is None else float(nbytes)
        transfer = size / (m.bandwidth_mb_s * 1e6) * 1e3
        self._last_fetch_s[oid] = now_s
        self.n_fetches += 1
        self.bytes_fetched += size
        return base + transfer

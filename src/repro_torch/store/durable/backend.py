"""``DurableBackend`` — the pluggable persistence seam of ``LatentStore``.

:class:`~repro.core.latent_store.LatentStore` keeps what it always owned —
the S3-style latency model, warmth windows, and per-object latency epochs —
and delegates *where bytes live* to one of these backends:

* :class:`MemoryBackend` — the original in-process dicts.  Default, and
  the simulator-conformance substrate: byte-for-byte the pre-refactor
  behavior, nothing survives process exit.
* :class:`SegmentLogBackend` — the engine-grade backend over a
  :class:`~repro.store.durable.log.SegmentLog`: append-only segments,
  checksummed records, manifest-checkpointed recovery, and online
  compaction via an attached :class:`~repro.store.durable.compact.Compactor`.

Both expose the same small protocol (blob/size puts, reads, tombstoning,
iteration, accounting) plus durability hooks (``flush`` / ``maybe_compact``
/ ``close``) that are no-ops in memory — so every caller can drive them
unconditionally.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterator, Optional

from repro_torch.compression.ladder import (RECIPE_RUNG, scaled_nbytes,
                                      transcode_blob)
from repro_torch.compression.latentcodec import blob_rung
from repro_torch.store.durable.compact import Compactor
from repro_torch.store.durable.log import SegmentLog


class DurableBackend(abc.ABC):
    """Byte-custody protocol behind ``LatentStore``."""

    name: str = "durable-backend"
    #: True when an acknowledged put survives process death.
    persistent: bool = False

    @abc.abstractmethod
    def put_blob(self, oid: int, blob: bytes) -> None: ...

    @abc.abstractmethod
    def put_size(self, oid: int, nbytes: float, rung: int = 0) -> None: ...

    @abc.abstractmethod
    def get_blob(self, oid: int) -> Optional[bytes]: ...

    @abc.abstractmethod
    def size_of(self, oid: int) -> Optional[float]: ...

    @abc.abstractmethod
    def has_blob(self, oid: int) -> bool: ...

    @abc.abstractmethod
    def contains(self, oid: int) -> bool: ...

    @abc.abstractmethod
    def delete(self, oid: int) -> bool: ...

    @abc.abstractmethod
    def oids(self) -> Iterator[int]: ...

    @property
    @abc.abstractmethod
    def total_bytes(self) -> float: ...

    # -- rate-distortion ladder ----------------------------------------------
    def rung_of(self, oid: int) -> Optional[int]:
        """Ladder rung the object's durable bytes sit at (None: absent)."""
        return 0 if self.contains(oid) else None

    def target_rung_of(self, oid: int) -> Optional[int]:
        """Pending (not yet applied) demotion target, or None."""
        return None

    def set_target_rung(self, oid: int, rung: int) -> bool:
        """Ask for the object to be re-encoded at a colder rung.  Returns
        False when the backend cannot ladder this object."""
        return False

    # -- durability hooks (no-ops in memory) ---------------------------------
    def flush(self) -> None:
        """Make every acknowledged write crash-durable."""

    def maybe_compact(self) -> int:
        """One bounded online-compaction step; returns segments compacted."""
        return 0

    def close(self) -> None:
        """Seal, checkpoint, and release file handles."""

    def stats(self) -> Dict[str, Any]:
        return {}


class MemoryBackend(DurableBackend):
    """The pre-refactor in-memory dict store (sim-mode conformance).

    Ladder demotion applies *eagerly* here: there is no compactor to
    piggyback on (the deferred-re-encode optimization is a segment-log
    property), so ``set_target_rung`` transcodes the blob — or re-scales
    the size registration — on the spot.  No intent is ever pending.
    """

    name = "memory"
    persistent = False

    def __init__(self) -> None:
        self._blobs: Dict[int, bytes] = {}
        self._sizes: Dict[int, float] = {}
        self._rungs: Dict[int, int] = {}

    @staticmethod
    def _sniff_rung(blob: bytes) -> int:
        try:
            return blob_rung(blob)
        except (ValueError, IndexError):
            return 0

    def put_blob(self, oid: int, blob: bytes) -> None:
        self._blobs[oid] = blob
        self._sizes[oid] = float(len(blob))
        self._rungs[oid] = self._sniff_rung(blob)

    def put_size(self, oid: int, nbytes: float, rung: int = 0) -> None:
        self._sizes[oid] = float(nbytes)
        self._rungs[oid] = int(rung)

    def get_blob(self, oid: int) -> Optional[bytes]:
        return self._blobs.get(oid)

    def size_of(self, oid: int) -> Optional[float]:
        return self._sizes.get(oid)

    def has_blob(self, oid: int) -> bool:
        return oid in self._blobs

    def contains(self, oid: int) -> bool:
        return oid in self._sizes or oid in self._blobs

    def delete(self, oid: int) -> bool:
        found = self.contains(oid)
        self._blobs.pop(oid, None)
        self._sizes.pop(oid, None)
        self._rungs.pop(oid, None)
        return found

    def oids(self) -> Iterator[int]:
        return iter(set(self._sizes) | set(self._blobs))

    @property
    def total_bytes(self) -> float:
        return float(sum(self._sizes.values()))

    def rung_of(self, oid: int) -> Optional[int]:
        if not self.contains(oid):
            return None
        return int(self._rungs.get(oid, 0))

    def set_target_rung(self, oid: int, rung: int) -> bool:
        rung = int(rung)
        cur = self.rung_of(oid)
        if cur is None or rung <= cur or not 0 < rung < RECIPE_RUNG:
            return False
        blob = self._blobs.get(oid)
        if blob is not None:
            try:
                demoted = transcode_blob(blob, rung)
            except (ValueError, TypeError):
                return False             # opaque payload: cannot ladder
            self._blobs[oid] = demoted
            self._sizes[oid] = float(len(demoted))
        else:
            self._sizes[oid] = scaled_nbytes(self._sizes[oid], cur, rung)
        self._rungs[oid] = rung
        return True


class SegmentLogBackend(DurableBackend):
    """Log-structured on-disk backend (the engine default under
    ``StoreConfig.data_dir``).

    ``flush_each_put=True`` acknowledges each put only after its record is
    flushed to the OS (the facade's durable-put contract); the serving
    engine constructs it with ``False`` and instead flushes once per
    request window (write-behind) through :meth:`flush`.
    """

    name = "segment_log"
    persistent = True

    def __init__(self, log: SegmentLog, *, flush_each_put: bool = True,
                 compact_live_frac: float = 0.6):
        self.log = log
        self.flush_each_put = bool(flush_each_put)
        self.compactor = Compactor(log, live_frac_threshold=compact_live_frac)

    @classmethod
    def open(cls, path: str, *, segment_bytes: float = 4e6,
             fsync: bool = False, checkpoint_every: int = 1024,
             flush_each_put: bool = True,
             compact_live_frac: float = 0.6) -> "SegmentLogBackend":
        return cls(SegmentLog(path, segment_bytes=segment_bytes, fsync=fsync,
                              checkpoint_every=checkpoint_every),
                   flush_each_put=flush_each_put,
                   compact_live_frac=compact_live_frac)

    def put_blob(self, oid: int, blob: bytes) -> None:
        self.log.put_blob(oid, blob)
        if self.flush_each_put:
            self.log.flush()

    def put_size(self, oid: int, nbytes: float, rung: int = 0) -> None:
        self.log.put_size(oid, nbytes, rung)
        if self.flush_each_put:
            self.log.flush()

    def get_blob(self, oid: int) -> Optional[bytes]:
        return self.log.get_blob(oid)

    def size_of(self, oid: int) -> Optional[float]:
        return self.log.size_of(oid)

    def has_blob(self, oid: int) -> bool:
        return self.log.has_blob(oid)

    def contains(self, oid: int) -> bool:
        return self.log.contains_object(oid)

    def delete(self, oid: int) -> bool:
        found = self.log.contains_object(oid)
        if found:
            self.log.tombstone(oid)
            if self.flush_each_put:
                self.log.flush()
        return found

    def oids(self) -> Iterator[int]:
        return self.log.object_oids()

    @property
    def total_bytes(self) -> float:
        return self.log.payload_bytes

    def rung_of(self, oid: int) -> Optional[int]:
        return self.log.rung_of(oid)

    def target_rung_of(self, oid: int) -> Optional[int]:
        return self.log.target_rung_of(oid)

    def set_target_rung(self, oid: int, rung: int) -> bool:
        """Record the demotion intent; the attached compactor's next pass
        over the object's segment re-encodes the bytes (piggybacked on
        the rewrite — never a standalone I/O pass)."""
        rung = int(rung)
        cur = self.log.rung_of(oid)
        if cur is None or rung <= cur or not 0 < rung < RECIPE_RUNG:
            return False
        if self.log.target_rung_of(oid) == rung:
            return True                  # idempotent: intent already queued
        self.log.set_target_rung(oid, rung)
        if self.flush_each_put:
            self.log.flush()
        return True

    def flush(self) -> None:
        self.log.flush()

    def maybe_compact(self) -> int:
        return self.compactor.step()

    def close(self) -> None:
        self.log.close()

    def stats(self) -> Dict[str, Any]:
        out = self.log.stats()
        out.update(self.compactor.summary())
        return out

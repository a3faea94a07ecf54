"""``DurableBackend`` — the pluggable persistence seam of ``LatentStore``.

:class:`~repro_torch.core.latent_store.LatentStore` keeps the S3-style
latency model, warmth windows, and per-object latency epochs, and
delegates *where bytes live* to a backend.  This is a copy of the JAX
package's ``store/durable/backend.py`` cut to the in-memory
:class:`MemoryBackend` (the simulation-conformance substrate: nothing
survives process exit).  The segment-log backend waits for the durable
slice of the port.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterator, Optional

from repro_torch.compression.ladder import (RECIPE_RUNG, scaled_nbytes,
                                            transcode_blob)
from repro_torch.compression.latentcodec import blob_rung


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
    """The in-memory dict store (sim-mode conformance).

    Ladder demotion applies *eagerly* here: there is no compactor to
    piggyback on, so ``set_target_rung`` transcodes the blob — or
    re-scales the size registration — on the spot.  No intent is ever
    pending.
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

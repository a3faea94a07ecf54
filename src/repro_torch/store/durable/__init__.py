"""Log-structured durable persistence for LatentBox.

The subsystem that turns the repo's "durable" tier from an in-memory
stand-in into measurable on-disk truth:

* ``segment``   — the checksummed append-only record format;
* ``log``       — :class:`SegmentLog`: segments + index + manifest
                  checkpoints + torn-tail-safe recovery + lsn-preserving
                  rewrites + segment shipping for shard migration;
* ``backend``   — the :class:`DurableBackend` seam behind ``LatentStore``
                  (:class:`MemoryBackend` sim default,
                  :class:`SegmentLogBackend` engine default on disk);
* ``compact``   — :class:`Compactor`: coldest-first online compaction
                  driven from the serving loop.

Entry point for applications: ``LatentBox.open(path)`` (see
``repro.store.facade``), which wires a :class:`SegmentLog` under both the
durable-latent and recipe tiers and guarantees reopen-and-serve-bit-exact
for every acknowledged put.
"""

from repro_torch.store.durable.backend import (DurableBackend, MemoryBackend,
                                         SegmentLogBackend)
from repro_torch.store.durable.compact import CompactionStats, Compactor
from repro_torch.store.durable.log import SegmentLog, Slot
from repro_torch.store.durable.segment import (BLOB, HEADER_BYTES, RDEL, RSTATE,
                                         SIZE, TOMB, Record, pack_record,
                                         scan_records)

__all__ = [
    "DurableBackend", "MemoryBackend", "SegmentLogBackend",
    "SegmentLog", "Slot", "Compactor", "CompactionStats",
    "Record", "pack_record", "scan_records",
    "BLOB", "SIZE", "TOMB", "RSTATE", "RDEL", "HEADER_BYTES",
]

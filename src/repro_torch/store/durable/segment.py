"""On-disk record format of the log-structured durable store.

A segment file is a flat sequence of self-describing records:

    ┌───────┬───────┬───────┬──────┬───────┬───────┬─────────────┐
    │ magic │ crc32 │  lsn  │ kind │  oid  │ plen  │   payload   │
    │  4 B  │  4 B  │  8 B  │ 1 B  │  8 B  │  4 B  │   plen B    │
    └───────┴───────┴───────┴──────┴───────┴───────┴─────────────┘

``crc32`` covers everything after itself (lsn..payload), so a torn tail —
a record the process was writing when it was killed — fails either the
magic check, the length check, or the checksum, and the scanner stops
cleanly at the last intact record.  ``lsn`` is a store-global, strictly
increasing log sequence number: replay applies records in *lsn* order, not
file order, which is what lets compaction rewrite old records into new
segments (keeping their original lsn) without ever changing the outcome of
a recovery scan.

Record kinds (one keyspace per ``oid``, three namespaces):

* durable-object namespace — ``BLOB`` (compressed latent payload),
  ``SIZE`` (size-only registration, simulator mode; payload is one
  little-endian float64 followed by one rung byte — legacy 8-byte
  payloads decode as rung 0), ``TOMB`` (delete/demote tombstone; empty
  payload);
* recipe namespace — ``RSTATE`` (full regen-tier state of one object as
  JSON: recipe fields, accounting bytes, latent residency, last access),
  ``RDEL`` (recipe tombstone);
* ladder namespace — ``RUNG`` (demotion *intent*: payload is one byte,
  the target rate-distortion rung).  The intent is deliberately a
  separate record, not a blob rewrite: the compactor transcodes the
  object's bytes when it next rewrites the segment, so ladder demotion
  never adds its own I/O pass.  An intent is *pending* only while it is
  newer than the object record and targets a colder rung — a fresh put
  (higher lsn) silently invalidates it.

Full-state ``RSTATE`` records (instead of incremental demote/readmit
deltas) make recovery order-free within the namespace: the highest-lsn
record *is* the state.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator, Optional, Tuple

MAGIC = b"LBS1"

#: record kinds — durable-object namespace
BLOB = 1            # payload = compressed latent bytes
SIZE = 2            # payload = struct '<d' accounting size (sim mode)
TOMB = 3            # payload = b'' (delete / demote)
#: record kinds — recipe namespace
RSTATE = 4          # payload = JSON regen-tier state
RDEL = 5            # payload = b''
#: record kinds — ladder namespace
RUNG = 6            # payload = struct '<B' target rate-distortion rung

OBJECT_KINDS = (BLOB, SIZE, TOMB)
RECIPE_KINDS = (RSTATE, RDEL)
LADDER_KINDS = (RUNG,)

_HEADER = struct.Struct("<4sIQBqI")      # magic, crc, lsn, kind, oid, plen
HEADER_BYTES = _HEADER.size
_TAIL = struct.Struct("<QBqI")           # the crc-covered header fields

_SIZE_PAYLOAD = struct.Struct("<d")      # legacy (pre-ladder) SIZE payload
_SIZE_RUNG_PAYLOAD = struct.Struct("<dB")
_RUNG_PAYLOAD = struct.Struct("<B")


def record_bytes(payload_len: int) -> int:
    """Total on-disk bytes of a record with ``payload_len`` payload."""
    return HEADER_BYTES + int(payload_len)


def pack_record(lsn: int, kind: int, oid: int, payload: bytes) -> bytes:
    """Serialize one record (header crc over lsn..payload)."""
    tail = _TAIL.pack(lsn, kind, oid, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(tail)) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, crc, lsn, kind, oid, len(payload)) + payload


def pack_size_payload(nbytes: float, rung: int = 0) -> bytes:
    return _SIZE_RUNG_PAYLOAD.pack(float(nbytes), int(rung) & 0xFF)


def unpack_size_payload(payload: bytes) -> float:
    return float(_SIZE_PAYLOAD.unpack_from(payload)[0])


def unpack_size_rung(payload: bytes) -> Tuple[float, int]:
    """(nbytes, rung) of a SIZE payload; legacy 8-byte payloads -> rung 0."""
    if len(payload) >= _SIZE_RUNG_PAYLOAD.size:
        nbytes, rung = _SIZE_RUNG_PAYLOAD.unpack_from(payload)
        return float(nbytes), int(rung)
    return float(_SIZE_PAYLOAD.unpack_from(payload)[0]), 0


def pack_rung_payload(rung: int) -> bytes:
    return _RUNG_PAYLOAD.pack(int(rung) & 0xFF)


def unpack_rung_payload(payload: bytes) -> int:
    return int(_RUNG_PAYLOAD.unpack_from(payload)[0])


@dataclasses.dataclass(frozen=True)
class Record:
    """One decoded record plus its location inside its segment."""

    offset: int                  # byte offset of the header in the segment
    lsn: int
    kind: int
    oid: int
    payload: bytes

    @property
    def nbytes(self) -> int:
        return record_bytes(len(self.payload))

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


def scan_records(buf: bytes, start: int = 0) -> Tuple[list, int]:
    """Decode records from ``buf[start:]`` until the end or a torn tail.

    Returns ``(records, valid_end)`` where ``valid_end`` is the offset one
    past the last intact record — everything beyond it (bad magic, short
    header, short payload, or checksum mismatch) is an unacknowledged tail
    and must be ignored (and, for the active segment, truncated away).
    """
    out = []
    off = start
    n = len(buf)
    while off + HEADER_BYTES <= n:
        magic, crc, lsn, kind, oid, plen = _HEADER.unpack_from(buf, off)
        if magic != MAGIC:
            break
        end = off + HEADER_BYTES + plen
        if end > n:
            break
        payload = buf[off + HEADER_BYTES:end]
        tail = _TAIL.pack(lsn, kind, oid, plen)
        if zlib.crc32(payload, zlib.crc32(tail)) & 0xFFFFFFFF != crc:
            break
        out.append(Record(off, lsn, kind, oid, payload))
        off = end
    return out, off


def read_payload(f, offset: int, payload_len: int) -> Optional[bytes]:
    """Read one record's payload given its header offset; verifies the
    stored checksum so a corrupt read can never be served as object bytes.
    Returns ``None`` on any mismatch."""
    f.seek(offset)
    raw = f.read(HEADER_BYTES + payload_len)
    recs, _ = scan_records(raw)
    if not recs or len(recs[0].payload) != payload_len:
        return None
    return recs[0].payload


def iter_file_records(path: str, start: int = 0) -> Iterator[Record]:
    """Convenience full-file scan (tools/tests); stops at the torn tail."""
    with open(path, "rb") as f:
        recs, _ = scan_records(f.read(), start)
    yield from recs

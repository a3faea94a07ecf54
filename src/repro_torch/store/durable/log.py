"""``SegmentLog`` — the log-structured persistence engine.

A log is a directory of append-only segment files plus one atomically
replaced ``MANIFEST.json`` checkpoint:

    <dir>/
      seg-00000001.lbx      sealed segment (never written again)
      seg-00000002.lbx      ...
      seg-00000007.lbx      active segment (current append target)
      MANIFEST.json         periodic checkpoint of the in-memory index

Writes append records (``segment.py`` format) to the active segment, which
seals and rolls when it exceeds ``segment_bytes``.  The in-memory index
maps each ``(namespace, oid)`` slot to its current (highest-lsn) record;
superseded records become dead bytes that online compaction reclaims by
rewriting a segment's live records (original lsns preserved) into the
active head and deleting the file.

Recovery (``__init__``) is manifest-first: load the checkpointed index,
then scan only the bytes appended after the checkpoint.  If the manifest
is missing, stale (references a segment compaction has deleted), or
corrupt, fall back to a full scan of every segment — the log never needs
the manifest for correctness, only for reopen speed.  A torn tail on the
highest segment (a record in flight when the process died) is truncated
away; acknowledged records are exactly those whose bytes were flushed, and
every one of them survives.

Durability contract: ``append`` buffers in the OS file; ``flush()`` makes
everything appended so far crash-durable (file flush + optional fsync) —
that is the acknowledgement point.  Callers wanting per-put acks flush per
put (``SegmentLogBackend`` default); the serving engine instead flushes
once per request window (write-behind).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.compression.latentcodec import blob_rung
from repro_torch.store.durable.segment import (BLOB, HEADER_BYTES, RDEL, RSTATE,
                                         RUNG, SIZE, TOMB, Record,
                                         pack_record, pack_rung_payload,
                                         pack_size_payload, read_payload,
                                         record_bytes, scan_records,
                                         unpack_rung_payload,
                                         unpack_size_rung)

MANIFEST = "MANIFEST.json"
MANIFEST_VERSION = 3        # v3: slots carry a ladder-rung field
SEG_PREFIX, SEG_SUFFIX = "seg-", ".lbx"

#: index namespaces: one slot per (namespace, oid)
NS_OBJECT = 0       # BLOB / SIZE / TOMB
NS_RECIPE = 1       # RSTATE / RDEL
NS_RUNG = 2         # RUNG (ladder-demotion intent)

_NS_OF = {BLOB: NS_OBJECT, SIZE: NS_OBJECT, TOMB: NS_OBJECT,
          RSTATE: NS_RECIPE, RDEL: NS_RECIPE, RUNG: NS_RUNG}


def _blob_payload_rung(payload: bytes) -> int:
    """Ladder rung a BLOB payload carries in its own codec header; opaque
    (non-latent-codec) payloads count as rung 0."""
    try:
        return blob_rung(payload)
    except (ValueError, IndexError):
        return 0


def _seg_name(seg_id: int) -> str:
    return f"{SEG_PREFIX}{seg_id:08d}{SEG_SUFFIX}"


def _seg_id(name: str) -> Optional[int]:
    if name.startswith(SEG_PREFIX) and name.endswith(SEG_SUFFIX):
        try:
            return int(name[len(SEG_PREFIX):-len(SEG_SUFFIX)])
        except ValueError:
            return None
    return None


@dataclasses.dataclass
class Slot:
    """The current record of one ``(namespace, oid)`` slot."""

    lsn: int
    kind: int
    seg: int
    offset: int                 # header offset inside the segment
    payload_len: int
    size: float                 # accounting bytes (BLOB: payload len;
    #                             SIZE: stored float; tombstones: 0)
    value: Any = None           # parsed payload for SIZE/RSTATE/RUNG records
    rung: int = 0               # ladder rung the record's bytes encode
    #                             (BLOB: from the codec header; SIZE: from
    #                             the payload's rung byte; else 0)

    @property
    def nbytes(self) -> int:
        return record_bytes(self.payload_len)

    def to_json(self) -> list:
        return [self.lsn, self.kind, self.seg, self.offset,
                self.payload_len, self.size, self.value, self.rung]

    @staticmethod
    def from_json(row: list) -> "Slot":
        return Slot(int(row[0]), int(row[1]), int(row[2]), int(row[3]),
                    int(row[4]), float(row[5]), row[6],
                    int(row[7]) if len(row) > 7 else 0)


class SegmentLog:
    """Append-only segmented log with checksummed records, a checkpointed
    index, torn-tail-safe recovery, and compaction hooks."""

    def __init__(self, path: str, *, segment_bytes: float = 4e6,
                 fsync: bool = False, checkpoint_every: int = 1024):
        self.path = os.path.abspath(str(path))
        os.makedirs(self.path, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        self.checkpoint_every = int(checkpoint_every)

        self.slots: Dict[Tuple[int, int], Slot] = {}
        self._seg_len: Dict[int, int] = {}       # valid bytes per segment
        self._seg_live: Dict[int, int] = {}      # live record bytes per seg
        self._read_handles: Dict[int, Any] = {}
        self._active_id: Optional[int] = None    # lazily created on append
        self._active_f = None
        self._next_seg = 1
        self.next_lsn = 1
        self._appends_since_ckpt = 0
        # write-amplification accounting: user vs compaction-rewrite bytes
        self.user_bytes_written = 0
        self.rewrite_bytes_written = 0
        # ladder accounting: blobs/sizes the compactor re-encoded in place
        self.reencoded_records = 0
        self.reencode_bytes_saved = 0
        self.closed = False
        self.recovery_stats: Dict[str, Any] = {}
        self._recover()

    # -- recovery -------------------------------------------------------------

    def _disk_segments(self) -> List[int]:
        ids = [sid for n in os.listdir(self.path)
               if (sid := _seg_id(n)) is not None]
        return sorted(ids)

    def _load_manifest(self) -> Optional[Dict[str, Any]]:
        p = os.path.join(self.path, MANIFEST)
        try:
            with open(p) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return None
        if m.get("version") != MANIFEST_VERSION:
            return None
        # stale manifest (references a compacted-away segment): discard —
        # a full scan of what's on disk is always correct
        on_disk = set(self._disk_segments())
        if any(int(s) not in on_disk for s in m.get("segments", {})):
            return None
        return m

    def _recover(self) -> None:
        t0 = time.perf_counter()
        seg_ids = self._disk_segments()
        manifest = self._load_manifest()
        scanned_from: Dict[int, int] = {s: 0 for s in seg_ids}
        n_manifest_slots = 0
        if manifest is not None:
            for key, row in manifest["slots"]:
                ns, oid = int(key[0]), int(key[1])
                self._apply_slot((ns, oid), Slot.from_json(row))
                n_manifest_slots += 1
            for s, ln in manifest["segments"].items():
                scanned_from[int(s)] = int(ln)
            self.next_lsn = int(manifest["next_lsn"])
            self.user_bytes_written = int(manifest.get("user_bytes", 0))
            self.rewrite_bytes_written = int(manifest.get("rewrite_bytes", 0))
            self.reencoded_records = int(manifest.get("reencoded", 0))
            self.reencode_bytes_saved = int(
                manifest.get("reencode_saved", 0))
        torn = 0
        n_records = 0
        for sid in seg_ids:
            p = self._seg_path(sid)
            with open(p, "rb") as f:
                buf = f.read()
            start = min(scanned_from.get(sid, 0), len(buf))
            recs, valid_end = scan_records(buf, start)
            self._seg_len[sid] = valid_end
            self._seg_live.setdefault(sid, 0)
            for r in recs:
                self._apply_record(sid, r)
                n_records += 1
            if valid_end < len(buf):
                # torn tail: unacknowledged bytes from the crashed writer.
                # Truncate so the file never accretes garbage mid-stream.
                torn += len(buf) - valid_end
                with open(p, "r+b") as f:
                    f.truncate(valid_end)
        self._next_seg = (seg_ids[-1] + 1) if seg_ids else 1
        self.recovery_stats = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "segments": len(seg_ids),
            "from_manifest": manifest is not None,
            "manifest_slots": n_manifest_slots,
            "scanned_records": n_records,
            "torn_tail_bytes": torn,
        }

    @staticmethod
    def _parse_payload(kind: int, payload: bytes):
        """(size, value, rung) of one record payload, shared by recovery
        replay and the live append path."""
        if kind == SIZE:
            size, rung = unpack_size_rung(payload)
            return size, size, rung
        if kind == BLOB:
            return float(len(payload)), None, _blob_payload_rung(payload)
        if kind == RSTATE:
            return 0.0, json.loads(payload.decode()), 0
        if kind == RUNG:
            return 0.0, unpack_rung_payload(payload), 0
        return 0.0, None, 0                      # TOMB / RDEL

    def _apply_record(self, sid: int, r: Record) -> None:
        if r.lsn >= self.next_lsn:
            self.next_lsn = r.lsn + 1
        size, value, rung = self._parse_payload(r.kind, r.payload)
        slot = Slot(r.lsn, r.kind, sid, r.offset, len(r.payload), size,
                    value, rung)
        self._apply_slot((_NS_OF[r.kind], r.oid), slot)

    def _apply_slot(self, key: Tuple[int, int], slot: Slot) -> None:
        cur = self.slots.get(key)
        if cur is not None:
            if cur.lsn > slot.lsn:               # strictly stale record
                return
            # equal lsn = the same logical record relocated by compaction
            # (or its duplicate surviving a crash between copy and unlink):
            # repoint, never double-count
            self._seg_live[cur.seg] = \
                self._seg_live.get(cur.seg, 0) - cur.nbytes
        self.slots[key] = slot
        self._seg_live[slot.seg] = \
            self._seg_live.get(slot.seg, 0) + slot.nbytes

    def _drop_slot(self, key: Tuple[int, int]) -> None:
        """Retire a slot whose record is being compacted away (stale
        ladder intent): remove it from the index and its live count."""
        s = self.slots.pop(key, None)
        if s is not None:
            self._seg_live[s.seg] = self._seg_live.get(s.seg, 0) - s.nbytes

    # -- append path ----------------------------------------------------------

    def _seg_path(self, sid: int) -> str:
        return os.path.join(self.path, _seg_name(sid))

    def _open_active(self) -> None:
        sid = self._next_seg
        self._next_seg += 1
        self._active_id = sid
        self._active_f = open(self._seg_path(sid), "ab")
        self._seg_len[sid] = 0
        self._seg_live.setdefault(sid, 0)

    def _seal_active(self) -> None:
        if self._active_f is None:
            return
        self._active_f.flush()
        if self.fsync:
            os.fsync(self._active_f.fileno())
        self._active_f.close()
        self._active_f = None
        self._active_id = None

    def append(self, kind: int, oid: int, payload: bytes,
               lsn: Optional[int] = None,
               rewrite: Optional[bool] = None) -> Slot:
        """Append one record and update the index.  ``lsn=None`` assigns
        the next sequence number (user write); compaction passes the
        record's original lsn so replay order is preserved.  ``rewrite``
        overrides the write-amplification attribution: a ladder re-encode
        takes a *new* lsn (it is a different logical record) but is still
        charged to compaction's rewrite budget, not to the user."""
        if self.closed:
            raise ValueError("log is closed")
        if rewrite is None:
            rewrite = lsn is not None
        if lsn is None:
            lsn = self.next_lsn
        self.next_lsn = max(self.next_lsn, lsn + 1)
        if self._active_f is None:
            self._open_active()
        elif self._seg_len[self._active_id] >= self.segment_bytes:
            self._seal_active()
            self._open_active()
        sid = self._active_id
        rec = pack_record(lsn, kind, oid, payload)
        offset = self._seg_len[sid]
        self._active_f.write(rec)
        self._seg_len[sid] = offset + len(rec)
        if rewrite:
            self.rewrite_bytes_written += len(rec)
        else:
            self.user_bytes_written += len(rec)
        size, value, rung = self._parse_payload(kind, payload)
        slot = Slot(lsn, kind, sid, offset, len(payload), size, value, rung)
        self._apply_slot((_NS_OF[kind], oid), slot)
        self._appends_since_ckpt += 1
        if (self.checkpoint_every > 0
                and self._appends_since_ckpt >= self.checkpoint_every):
            self.flush(manifest=True)
        return slot

    # -- durable-object namespace --------------------------------------------

    def put_blob(self, oid: int, blob: bytes) -> Slot:
        return self.append(BLOB, int(oid), bytes(blob))

    def put_size(self, oid: int, nbytes: float, rung: int = 0) -> Slot:
        return self.append(SIZE, int(oid), pack_size_payload(nbytes, rung))

    def tombstone(self, oid: int) -> Slot:
        return self.append(TOMB, int(oid), b"")

    def _obj_slot(self, oid: int) -> Optional[Slot]:
        s = self.slots.get((NS_OBJECT, int(oid)))
        return s if s is not None and s.kind != TOMB else None

    def contains_object(self, oid: int) -> bool:
        return self._obj_slot(oid) is not None

    def has_blob(self, oid: int) -> bool:
        s = self._obj_slot(oid)
        return s is not None and s.kind == BLOB

    def size_of(self, oid: int) -> Optional[float]:
        s = self._obj_slot(oid)
        return None if s is None else s.size

    def get_blob(self, oid: int) -> Optional[bytes]:
        s = self._obj_slot(oid)
        if s is None or s.kind != BLOB:
            return None
        return self._read_slot_payload(s)

    def object_oids(self) -> Iterator[int]:
        for (ns, oid), s in self.slots.items():
            if ns == NS_OBJECT and s.kind != TOMB:
                yield oid

    # -- ladder namespace -----------------------------------------------------

    def rung_of(self, oid: int) -> Optional[int]:
        """Rate-distortion rung the object's durable bytes are encoded at
        (None if the object has no durable record)."""
        s = self._obj_slot(oid)
        return None if s is None else int(s.rung)

    def set_target_rung(self, oid: int, rung: int) -> Slot:
        """Record a ladder-demotion *intent*: the compactor re-encodes the
        object's bytes to ``rung`` when it next rewrites their segment —
        no immediate I/O beyond this one tiny record."""
        return self.append(RUNG, int(oid), pack_rung_payload(rung))

    def target_rung_of(self, oid: int) -> Optional[int]:
        """Pending demotion target for ``oid``, or None.  An intent is
        pending only while it is newer than the object record (a fresh
        put invalidates it) and targets a strictly colder rung."""
        intent = self.slots.get((NS_RUNG, int(oid)))
        if intent is None or intent.kind != RUNG:
            return None
        obj = self._obj_slot(oid)
        if obj is None:
            return None
        if intent.lsn <= obj.lsn or int(intent.value) <= int(obj.rung):
            return None
        return int(intent.value)

    def pending_rungs(self) -> Dict[int, int]:
        """oid -> pending target rung, across the whole log."""
        out = {}
        for (ns, oid), _ in list(self.slots.items()):
            if ns != NS_RUNG:
                continue
            t = self.target_rung_of(oid)
            if t is not None:
                out[oid] = t
        return out

    def pending_segments(self) -> Dict[int, int]:
        """sealed seg_id -> bytes of live object records awaiting ladder
        demotion there (the compactor's re-encode yield estimate)."""
        out: Dict[int, int] = {}
        for oid in self.pending_rungs():
            s = self._obj_slot(oid)
            if s is not None and s.seg != self._active_id:
                out[s.seg] = out.get(s.seg, 0) + s.nbytes
        return out

    # -- recipe namespace -----------------------------------------------------

    def put_recipe_state(self, oid: int, state: Dict[str, Any]) -> Slot:
        return self.append(RSTATE, int(oid),
                           json.dumps(state, sort_keys=True).encode())

    def delete_recipe(self, oid: int) -> Slot:
        return self.append(RDEL, int(oid), b"")

    def recipe_states(self) -> Dict[int, Dict[str, Any]]:
        """oid -> latest RSTATE payload (recovery view of the regen tier)."""
        return {oid: s.value for (ns, oid), s in self.slots.items()
                if ns == NS_RECIPE and s.kind == RSTATE}

    def recipe_state_of(self, oid: int) -> Optional[Dict[str, Any]]:
        s = self.slots.get((NS_RECIPE, int(oid)))
        return s.value if s is not None and s.kind == RSTATE else None

    # -- reads ---------------------------------------------------------------

    def _read_slot_payload(self, s: Slot) -> Optional[bytes]:
        if s.seg == self._active_id and self._active_f is not None:
            self._active_f.flush()               # readable before fsync
        f = self._read_handles.get(s.seg)
        if f is None:
            f = open(self._seg_path(s.seg), "rb")
            self._read_handles[s.seg] = f
        return read_payload(f, s.offset, s.payload_len)

    # -- durability ----------------------------------------------------------

    def flush(self, manifest: bool = False) -> None:
        """Acknowledgement point: every record appended so far becomes
        crash-durable (``fsync=True`` additionally forces the platters)."""
        if self._active_f is not None:
            self._active_f.flush()
            if self.fsync:
                os.fsync(self._active_f.fileno())
        if manifest:
            self.write_manifest()

    def write_manifest(self) -> None:
        """Atomically checkpoint the index (tmp + rename), bounding the
        next recovery's scan to bytes appended after this point."""
        m = {
            "version": MANIFEST_VERSION,
            "next_lsn": self.next_lsn,
            "segments": {str(s): int(ln) for s, ln in self._seg_len.items()},
            "slots": [[[ns, oid], s.to_json()]
                      for (ns, oid), s in self.slots.items()],
            "user_bytes": self.user_bytes_written,
            "rewrite_bytes": self.rewrite_bytes_written,
            "reencoded": self.reencoded_records,
            "reencode_saved": self.reencode_bytes_saved,
        }
        tmp = os.path.join(self.path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(m, f)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, MANIFEST))
        self._appends_since_ckpt = 0

    def close(self) -> None:
        if self.closed:
            return
        self._seal_active()
        self.write_manifest()
        for f in self._read_handles.values():
            f.close()
        self._read_handles.clear()
        self.closed = True

    def abandon(self) -> None:
        """Emulate a process kill in-process: drop the userspace append
        buffer (bytes not yet flushed to the OS are lost, exactly as on
        ``os._exit``), close every handle, write no manifest.  The on-disk
        state is what a real crash would leave — the failure-injection
        harness kills shards this way, then reopens a fresh log to recover.
        """
        if self.closed:
            return
        if self._active_f is not None:
            p = self._seg_path(self._active_id)
            flushed = os.path.getsize(p)         # what the OS already has
            self._active_f.close()               # flushes the tail...
            with open(p, "r+b") as f:
                f.truncate(flushed)              # ...which the kill loses
            self._active_f = None
            self._active_id = None
        for f in self._read_handles.values():
            f.close()
        self._read_handles.clear()
        self.closed = True

    # -- compaction mechanics -------------------------------------------------

    def sealed_segments(self) -> Dict[int, Tuple[int, int]]:
        """seg_id -> (valid_bytes, live_bytes) for every sealed segment."""
        return {sid: (ln, self._seg_live.get(sid, 0))
                for sid, ln in self._seg_len.items()
                if sid != self._active_id}

    def compact_segment(self, sid: int, crash_hook=None,
                        reencode=None) -> Tuple[int, int]:
        """Rewrite ``sid``'s live records into the active head (original
        lsns preserved) and delete the file.  Returns (bytes_rewritten,
        bytes_reclaimed).  Safe order: the copies are appended and flushed
        *before* the victim file is unlinked, so a crash at any point
        leaves either duplicates (deduped by lsn on replay) or the intact
        victim — never a hole.  ``crash_hook`` is a test seam invoked
        between the durable rewrite and the unlink.

        ``reencode(kind, payload, target_rung) -> payload-or-None`` is the
        ladder piggyback: when a live BLOB/SIZE record has a pending
        demotion intent, the compactor transcodes it *during* the rewrite
        it was going to do anyway.  The demoted record takes a new lsn —
        so it supersedes the intent and wins any replay — and a crash
        between copy and unlink leaves the old record intact (the intent
        simply stays pending).  ``None`` from the hook means "copy
        verbatim"."""
        if sid == self._active_id:
            raise ValueError("cannot compact the active segment")
        if sid not in self._seg_len:
            raise KeyError(f"no segment {sid}")
        with open(self._seg_path(sid), "rb") as f:
            recs, _ = scan_records(f.read(), 0)
        rewritten = 0
        for r in recs:
            key = (_NS_OF[r.kind], r.oid)
            cur = self.slots.get(key)
            if cur is None or cur.seg != sid or cur.lsn != r.lsn:
                continue                          # dead record: drop
            if r.kind == RUNG and self.target_rung_of(r.oid) is None:
                self._drop_slot(key)              # stale intent: retire it
                continue
            if r.kind in (BLOB, SIZE) and reencode is not None:
                target = self.target_rung_of(r.oid)
                if target is not None:
                    demoted = reencode(r.kind, r.payload, target)
                    if demoted is not None:
                        self.append(r.kind, r.oid, demoted, rewrite=True)
                        self.reencoded_records += 1
                        self.reencode_bytes_saved += max(
                            0, len(r.payload) - len(demoted))
                        rewritten += record_bytes(len(demoted))
                        continue
                    # the hook declined a *pending* record: the intent is
                    # unsatisfiable (e.g. opaque payload) — retire it so
                    # it cannot re-elect this data for compaction forever
                    self._drop_slot((NS_RUNG, r.oid))
            self.append(r.kind, r.oid, r.payload, lsn=r.lsn)
            rewritten += r.nbytes
        self.flush()                              # copies durable first
        if crash_hook is not None:
            crash_hook()
        reclaimed = self._seg_len.pop(sid)
        self._seg_live.pop(sid, None)
        f = self._read_handles.pop(sid, None)
        if f is not None:
            f.close()
        os.remove(self._seg_path(sid))
        self.write_manifest()                     # never reference the dead file
        return rewritten, reclaimed

    # -- segment shipping (shard migration) -----------------------------------

    def export_records(self, oids) -> bytes:
        """Seal a migration batch: the current object + recipe records of
        ``oids`` as one raw segment image (no decompression, no re-encode)
        ready for :meth:`ingest_segment` on the destination log."""
        parts: List[bytes] = []
        for oid in oids:
            oid = int(oid)
            s = self._obj_slot(oid)
            if s is not None:
                payload = self._read_slot_payload(s)
                if payload is None:
                    raise IOError(f"checksum failure exporting oid {oid}")
                parts.append(pack_record(s.lsn, s.kind, oid, payload))
            rs = self.slots.get((NS_RECIPE, oid))
            if rs is not None and rs.kind == RSTATE:
                parts.append(pack_record(
                    rs.lsn, RSTATE, oid,
                    json.dumps(rs.value, sort_keys=True).encode()))
            # pending ladder intent migrates with the object; it is packed
            # *after* the object record so the destination's re-stamped
            # lsns keep it newer (i.e. still pending).  Stale intents stay
            # behind and die with the source.
            if s is not None and self.target_rung_of(oid) is not None:
                rg = self.slots[(NS_RUNG, oid)]
                parts.append(pack_record(rg.lsn, RUNG, oid,
                                         pack_rung_payload(int(rg.value))))
        return b"".join(parts)

    def export_delta(self, since_lsn: int, oids=None) -> bytes:
        """Replication catch-up image: every *current* slot (both
        namespaces, deletions included as TOMB/RDEL records) with
        ``lsn > since_lsn``, lsn-ordered, as one raw segment image.
        Unlike :meth:`export_records` this ships deletions — a replica
        must learn that an object died.  ``oids`` narrows the export to a
        designated subset (None: everything)."""
        want = None if oids is None else {int(o) for o in oids}
        picked = []
        for (ns, oid), s in self.slots.items():
            if s.lsn <= since_lsn:
                continue
            if want is not None and oid not in want:
                continue
            picked.append((s.lsn, ns, oid, s))
        parts: List[bytes] = []
        for _, ns, oid, s in sorted(picked):
            if s.kind in (TOMB, RDEL):
                payload = b""
            elif s.kind == RSTATE:
                payload = json.dumps(s.value, sort_keys=True).encode()
            elif s.kind == SIZE:
                payload = pack_size_payload(s.size, s.rung)
            elif s.kind == RUNG:
                payload = pack_rung_payload(int(s.value))
            else:
                payload = self._read_slot_payload(s)
                if payload is None:
                    raise IOError(f"checksum failure exporting oid {oid}")
            parts.append(pack_record(s.lsn, s.kind, oid, payload))
        return b"".join(parts)

    def ingest_segment(self, raw: bytes) -> Dict[str, Any]:
        """Adopt a shipped segment as one fresh *sealed* segment file:
        records are re-stamped with local lsns while streaming to disk
        (no per-key put path), then indexed.  Corrupt input (a flipped
        bit fails a record checksum, truncation breaks framing) is
        rejected up front with ``ValueError`` — nothing is applied and no
        segment file is created.  Returns the applied view:
        ``{"objects": [...], "recipes": {...}, "removed_objects": [...],
        "removed_recipes": [...], "segment": sid-or-None}``."""
        recs, valid_end = scan_records(raw, 0)
        if valid_end != len(raw):
            raise ValueError(
                f"shipped segment is corrupt: checksum/framing failure at "
                f"byte {valid_end} of {len(raw)}; nothing applied")
        applied_objects: List[int] = []
        recipes: Dict[int, Dict[str, Any]] = {}
        removed_objects: List[int] = []
        removed_recipes: List[int] = []
        rungs: Dict[int, int] = {}
        if not recs:
            return {"objects": [], "recipes": {}, "removed_objects": [],
                    "removed_recipes": [], "rungs": {}, "segment": None}
        self._seal_active()
        sid = self._next_seg
        self._next_seg += 1
        with open(self._seg_path(sid), "wb") as f:
            off = 0
            self._seg_len[sid] = 0
            self._seg_live.setdefault(sid, 0)
            for r in recs:
                lsn = self.next_lsn
                self.next_lsn += 1
                rec = pack_record(lsn, r.kind, r.oid, r.payload)
                f.write(rec)
                self.user_bytes_written += len(rec)
                self._seg_len[sid] = off + len(rec)
                self._apply_record(sid, Record(off, lsn, r.kind, r.oid,
                                               r.payload))
                off += len(rec)
                if r.kind in (BLOB, SIZE):
                    applied_objects.append(r.oid)
                elif r.kind == RSTATE:
                    recipes[r.oid] = json.loads(r.payload.decode())
                elif r.kind == TOMB:
                    removed_objects.append(r.oid)
                elif r.kind == RDEL:
                    removed_recipes.append(r.oid)
                elif r.kind == RUNG:
                    rungs[r.oid] = unpack_rung_payload(r.payload)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.write_manifest()
        return {"objects": applied_objects, "recipes": recipes,
                "removed_objects": removed_objects,
                "removed_recipes": removed_recipes, "rungs": rungs,
                "segment": sid}

    # -- accounting -----------------------------------------------------------

    @property
    def live_bytes(self) -> int:
        """Bytes of current (non-superseded) records across all segments."""
        return sum(max(v, 0) for v in self._seg_live.values())

    @property
    def on_disk_bytes(self) -> int:
        """Real bytes in segment files (valid prefixes; dead bytes incl.)."""
        return sum(self._seg_len.values())

    @property
    def payload_bytes(self) -> float:
        """Accounting bytes of live durable objects (BLOB payload sizes +
        SIZE registrations) — the logical ``LatentStore.total_bytes``."""
        return float(sum(s.size for (ns, _), s in self.slots.items()
                         if ns == NS_OBJECT and s.kind != TOMB))

    @property
    def write_amplification(self) -> float:
        """(user + compaction rewrite bytes) / user bytes ever appended."""
        if self.user_bytes_written <= 0:
            return 1.0
        return (self.user_bytes_written + self.rewrite_bytes_written) \
            / self.user_bytes_written

    def stats(self) -> Dict[str, Any]:
        return {
            "segments": len(self._seg_len),
            "on_disk_bytes": self.on_disk_bytes,
            "live_bytes": self.live_bytes,
            "payload_bytes": self.payload_bytes,
            "user_bytes_written": self.user_bytes_written,
            "rewrite_bytes_written": self.rewrite_bytes_written,
            "write_amplification": self.write_amplification,
            "reencoded_records": self.reencoded_records,
            "reencode_bytes_saved": self.reencode_bytes_saved,
            "pending_rungs": len(self.pending_rungs()),
            "recovery": dict(self.recovery_stats),
        }

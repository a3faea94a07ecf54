"""Online compaction policy over a :class:`~repro.store.durable.log.SegmentLog`.

The log's append-only discipline turns every overwrite, delete, and
demotion into dead bytes that sit in sealed segments until someone
rewrites the survivors.  :class:`Compactor` is that someone: each
:meth:`step` (called from the serving engine's request loop, between
windows) picks the *coldest* sealed segment — the one with the lowest
live fraction, i.e. the most reclaimable bytes per byte rewritten — and
compacts it if it is below the configured live-fraction threshold.  The
mechanics (lsn-preserving rewrite, crash-safe copy-then-unlink order)
live in :meth:`SegmentLog.compact_segment`; this module owns only the
victim choice, the trigger thresholds, and the accounting.

Rate-distortion ladder demotion piggybacks here: when a live record has
a pending ``RUNG`` intent, the rewrite transcodes it to the target rung
via :func:`ladder_reencode` instead of copying it verbatim — re-encoding
rides along with segment rewrites rather than adding its own I/O pass.
When no segment is under the dead-bytes threshold but sealed segments
hold pending demotions, the compactor picks the one with the most
pending bytes (those bytes are reclaimable by re-encoding, which is the
same economics as reclaiming dead bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.compression.ladder import RECIPE_RUNG, scaled_nbytes, transcode_blob
from repro_torch.store.durable.log import SegmentLog
from repro_torch.store.durable.segment import (BLOB, SIZE, pack_size_payload,
                                         unpack_size_rung)


def ladder_reencode(kind: int, payload: bytes,
                    target: int) -> Optional[bytes]:
    """Default compaction re-encode hook: transcode a BLOB payload down
    the ladder, or re-scale a SIZE registration's nominal bytes.  Returns
    None (= copy verbatim) for anything it cannot or need not demote."""
    if not 0 < int(target) < RECIPE_RUNG:
        return None                      # recipe demotion is not a rewrite
    if kind == BLOB:
        try:
            demoted = transcode_blob(payload, int(target))
        except (ValueError, TypeError):
            return None                  # opaque payload: leave it alone
        return None if demoted is payload else demoted
    if kind == SIZE:
        nbytes, rung = unpack_size_rung(payload)
        if rung >= int(target):
            return None
        return pack_size_payload(scaled_nbytes(nbytes, rung, int(target)),
                                 int(target))
    return None


@dataclasses.dataclass
class CompactionStats:
    runs: int = 0
    segments_compacted: int = 0
    bytes_rewritten: int = 0
    bytes_reclaimed: int = 0


class Compactor:
    """Pick-coldest-first online compaction.

    ``live_frac_threshold``: sealed segments whose live fraction is at or
    below this compact; 1.0 means "any dead byte qualifies", 0.0 disables.
    ``min_segment_bytes`` skips near-empty stub segments whose rewrite
    cost exceeds the bookkeeping win (they still compact under
    :meth:`compact_all`).  ``reencode`` is the ladder piggyback hook
    passed through to :meth:`SegmentLog.compact_segment` (None disables
    demotion-on-compaction; intents then stay pending).
    """

    def __init__(self, log: SegmentLog, *, live_frac_threshold: float = 0.6,
                 min_segment_bytes: int = 0, reencode=ladder_reencode):
        self.log = log
        self.live_frac_threshold = float(live_frac_threshold)
        self.min_segment_bytes = int(min_segment_bytes)
        self.reencode = reencode
        self.stats = CompactionStats()

    def _victim(self) -> Optional[int]:
        best, best_frac = None, None
        for sid, (nbytes, live) in self.log.sealed_segments().items():
            if nbytes <= self.min_segment_bytes or nbytes == 0:
                continue
            frac = max(live, 0) / nbytes
            if frac > self.live_frac_threshold:
                continue
            if best_frac is None or frac < best_frac:
                best, best_frac = sid, frac
        return best

    def _ladder_victim(self) -> Optional[int]:
        """Sealed segment with the most live bytes awaiting demotion —
        re-encoding reclaims those bytes, so it earns a rewrite even when
        the segment's dead fraction alone would not."""
        if self.reencode is None:
            return None
        sealed = self.log.sealed_segments()
        pending = {sid: b for sid, b in self.log.pending_segments().items()
                   if sid in sealed
                   and sealed[sid][0] > self.min_segment_bytes}
        if not pending:
            return None
        return max(pending.items(), key=lambda kv: (kv[1], -kv[0]))[0]

    def step(self, max_segments: int = 1, crash_hook=None) -> int:
        """Compact up to ``max_segments`` cold segments; returns how many
        were compacted (0: nothing under the threshold and no pending
        ladder work — the steady state).  Runs between serving windows,
        so 'online' here means bounded work per call, never a
        stop-the-world sweep."""
        if self.live_frac_threshold <= 0.0:
            return 0
        done = 0
        for _ in range(max_segments):
            sid = self._victim()
            if sid is None:
                sid = self._ladder_victim()
            if sid is None:
                break
            rewritten, reclaimed = self.log.compact_segment(
                sid, crash_hook=crash_hook, reencode=self.reencode)
            self.stats.segments_compacted += 1
            self.stats.bytes_rewritten += rewritten
            self.stats.bytes_reclaimed += reclaimed
            done += 1
        self.stats.runs += 1
        return done

    def compact_all(self) -> int:
        """Rewrite every sealed segment with any dead byte or pending
        ladder demotion (maintenance / pre-ship sweep); returns segments
        compacted."""
        done = 0
        while True:
            victim = None
            pending = (self.log.pending_segments()
                       if self.reencode is not None else {})
            for sid, (nbytes, live) in self.log.sealed_segments().items():
                if nbytes > 0 and (max(live, 0) < nbytes or sid in pending):
                    victim = sid
                    break
            if victim is None:
                return done
            rewritten, reclaimed = self.log.compact_segment(
                victim, reencode=self.reencode)
            self.stats.segments_compacted += 1
            self.stats.bytes_rewritten += rewritten
            self.stats.bytes_reclaimed += reclaimed
            done += 1

    def summary(self) -> Dict[str, float]:
        return {
            "compaction_runs": self.stats.runs,
            "segments_compacted": self.stats.segments_compacted,
            "compaction_bytes_rewritten": self.stats.bytes_rewritten,
            "compaction_bytes_reclaimed": self.stats.bytes_reclaimed,
            "reencoded_records": self.log.reencoded_records,
            "reencode_bytes_saved": self.log.reencode_bytes_saved,
        }

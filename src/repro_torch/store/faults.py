"""Failure injection for the sharded store.

A :class:`FaultPlan` is a deterministic script of shard-level faults keyed
by *global request index* — the cluster counts every request it has ever
served and, at each window boundary the plan splits, applies the events
that have come due.  Driving faults off the request clock (not wall time)
keeps every injected run exactly reproducible, which is what lets the
conformance suite demand bit-identical classification from a degraded
cluster.

Event kinds:

``kill``
    The shard process dies mid-trace.  Persistent shards lose their
    unflushed write-behind tail (``SegmentLog.abandon``), memory shards
    lose everything.  Reads fail over to replica holders.
``restart``
    A previously killed shard comes back: it recovers from its own log,
    then catches up from its peers' replica holders via delta segment
    shipping.
``stall``
    The shard answers, but ``stall_ms`` slower — the one-slow-replica
    scenario hedged reads exist for.  A second ``stall`` event with
    ``stall_ms=0`` clears it.
``partition``
    The shard is unreachable but intact (no data loss); reads fail over
    exactly as for ``kill``.
``heal``
    The partition ends; the shard catches up on the writes it missed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

KINDS = ("kill", "restart", "stall", "partition", "heal")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    shard_id: int
    at_request: int             # fires before serving this global request
    stall_ms: float = 0.0       # only meaningful for kind="stall"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {KINDS})")
        if self.at_request < 0:
            raise ValueError("at_request must be >= 0")


class FaultPlan:
    """An ordered script of :class:`FaultEvent`; the cluster pops events
    as their request index comes due."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._pending: List[FaultEvent] = sorted(
            events, key=lambda e: e.at_request)
        self.fired: List[FaultEvent] = []

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> List[FaultEvent]:
        return list(self._pending)

    def next_boundary(self, after: int) -> Optional[int]:
        """First pending event index > ``after`` (None: no more events) —
        where the cluster must split its serving window."""
        for e in self._pending:
            if e.at_request > after:
                return e.at_request
        return None

    def pop_due(self, request_index: int) -> List[FaultEvent]:
        """Events with ``at_request <= request_index``, in firing order."""
        due = [e for e in self._pending if e.at_request <= request_index]
        if due:
            self._pending = [e for e in self._pending
                             if e.at_request > request_index]
            self.fired.extend(due)
        return due

    # -- convenience constructors ---------------------------------------------
    @staticmethod
    def kill(shard_id: int, at_request: int) -> "FaultPlan":
        return FaultPlan([FaultEvent("kill", shard_id, at_request)])

    @staticmethod
    def kill_restart(shard_id: int, kill_at: int,
                     restart_at: int) -> "FaultPlan":
        return FaultPlan([FaultEvent("kill", shard_id, kill_at),
                          FaultEvent("restart", shard_id, restart_at)])

    @staticmethod
    def stall(shard_id: int, at_request: int, stall_ms: float,
              until_request: Optional[int] = None) -> "FaultPlan":
        ev = [FaultEvent("stall", shard_id, at_request, stall_ms=stall_ms)]
        if until_request is not None:
            ev.append(FaultEvent("stall", shard_id, until_request))
        return FaultPlan(ev)

    @staticmethod
    def partition(shard_id: int, at_request: int,
                  heal_at: Optional[int] = None) -> "FaultPlan":
        ev = [FaultEvent("partition", shard_id, at_request)]
        if heal_at is not None:
            ev.append(FaultEvent("heal", shard_id, heal_at))
        return FaultPlan(ev)

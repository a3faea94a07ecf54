"""Deterministic discrete-event substrate of the serving runtime.

The runtime schedules on a *simulated* clock: every latency-bearing step
(arrival, microbatch service, deadline-forced dispatch) is an event on one
heap, popped in ``(time, insertion order)`` order.  No wall-clock threads
exist anywhere in the loop, so a stream replay is exactly reproducible —
the property every runtime test (and the drain-mode conformance guarantee)
relies on.  The engine backend still performs *real* jitted decodes inside
a dispatch; only the queueing/SLO timeline is virtual.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional, Tuple

#: SLO classes of the serving runtime (paper-adjacent: interactive image
#: traffic needs deadline treatment distinct from bulk/archival reads).
SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH)


@dataclasses.dataclass
class Request:
    """One timestamped request of an open-loop arrival process."""

    oid: int
    arrival_ms: float
    #: Arrival index in the stream (assigned by the runtime when < 0);
    #: report outcomes are keyed on it, so results stay in arrival order
    #: even when QoS reorders service.
    seq: int = -1
    tenant: int = 0
    slo: str = SLO_INTERACTIVE
    #: Absolute completion deadline; ``None`` = filled from the runtime
    #: config's per-class deadline at admission.
    deadline_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}: {self.slo!r}")


class EventLoop:
    """Simulated-clock event loop: a heap of ``(time_ms, seq, callback)``.

    Events scheduled in the past clamp to ``now`` (they fire next, after
    already-queued events at the same instant), so callbacks can never
    move the clock backwards.  Ties break by insertion order — the loop is
    fully deterministic for a fixed schedule.
    """

    def __init__(self, start_ms: float = 0.0):
        self.now: float = float(start_ms)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def at(self, t_ms: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to fire at simulated time ``t_ms``."""
        heapq.heappush(self._heap,
                       (max(float(t_ms), self.now), next(self._counter), fn))

    def after(self, dt_ms: float, fn: Callable[[], None]) -> None:
        self.at(self.now + max(0.0, float(dt_ms)), fn)

    def run(self) -> float:
        """Drain every event; returns the final simulated time (ms)."""
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            fn()
        return self.now

"""Per-tenant QoS primitives: token buckets and weighted-fair queueing.

The central queue of the serving runtime is a :class:`FairQueue` — two
strict-priority bands (``interactive`` dispatches ahead of ``batch``,
the "queue-jump" half of SLO-aware scheduling) and, within a band,
start-time fair queuing (SFQ) across tenants so one tenant's burst cannot
starve another's steady trickle.  A per-tenant :class:`TokenBucket`
(simulated-clock, like everything in the runtime) classifies each arrival
as *conforming* or *over-rate*; over-rate requests are never dropped here
— they queue behind every conforming request of their band, so a tenant
flooding past its contracted rate only ever competes for leftover
capacity.  With ``qos=False`` the whole structure degrades to one global
FIFO, which is what the drain-mode conformance guarantee runs on.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.runtime.events import Request, SLO_BATCH, SLO_INTERACTIVE


class TokenBucket:
    """Classic token bucket on the simulated clock (ms timestamps)."""

    def __init__(self, rate_per_s: float, burst: float,
                 now_ms: float = 0.0):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("token bucket needs positive rate and burst")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last_ms = float(now_ms)

    def _refill(self, now_ms: float) -> None:
        dt_s = max(0.0, now_ms - self._last_ms) / 1e3
        self.tokens = min(self.burst, self.tokens + dt_s * self.rate_per_s)
        self._last_ms = max(self._last_ms, now_ms)

    def available(self, now_ms: float) -> float:
        self._refill(now_ms)
        return self.tokens

    def try_take(self, now_ms: float, n: float = 1.0) -> bool:
        """Consume ``n`` tokens if available; False marks the caller
        over-rate (the request still serves, at background priority)."""
        self._refill(now_ms)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


#: Dispatch bands in strict priority order: conforming interactive first,
#: then over-rate interactive, then batch (conforming before over-rate).
_BANDS = ((SLO_INTERACTIVE, True), (SLO_INTERACTIVE, False),
          (SLO_BATCH, True), (SLO_BATCH, False))


class FairQueue:
    """Two-band weighted-fair central queue of the serving runtime.

    SFQ bookkeeping: each pushed request gets a start tag
    ``S = max(V, tenant_finish)`` and finish tag ``F = S + 1/weight``;
    dequeue picks the band-first minimum-``F`` request and advances the
    virtual time ``V`` to its start tag.  Two backlogged tenants of equal
    weight therefore alternate 1:1 regardless of a 10:1 arrival-rate
    imbalance — the property ``tests/test_serving_runtime.py`` locks in.
    """

    def __init__(self, qos: bool = True,
                 weights: Optional[Dict[int, float]] = None,
                 rate_rps: Optional[float] = None,
                 burst: float = 8.0):
        self.qos = bool(qos)
        self.weights = dict(weights or {})
        self.rate_rps = rate_rps
        self.burst = float(burst)
        self._buckets: Dict[int, TokenBucket] = {}
        self._finish: Dict[int, float] = {}      # per-tenant SFQ finish tag
        self._vtime = 0.0
        self._fifo_seq = 0
        # (finish_tag, push_seq, request) per band
        self._q: Dict[Tuple[str, bool], List[Tuple[float, int, Request]]] = {
            band: [] for band in _BANDS}
        # lazy min-deadline tracking over everything queued
        self._deadlines: List[Tuple[float, int]] = []
        self._queued_seqs: set = set()
        self.n_over_rate = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def n_queued(self, slo: Optional[str] = None) -> int:
        if slo is None:
            return len(self)
        return sum(len(q) for (band_slo, _), q in self._q.items()
                   if band_slo == slo)

    def _bucket(self, tenant: int, now_ms: float) -> Optional[TokenBucket]:
        if self.rate_rps is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.rate_rps, self.burst, now_ms=now_ms)
        return b

    def push(self, req: Request, now_ms: float) -> bool:
        """Enqueue; returns whether the request was rate-conforming."""
        self._fifo_seq += 1
        bucket = self._bucket(req.tenant, now_ms)
        conforming = True if bucket is None else bucket.try_take(now_ms)
        if not conforming:
            self.n_over_rate += 1
        if self.qos:
            w = float(self.weights.get(req.tenant, 1.0))
            start = max(self._vtime, self._finish.get(req.tenant, 0.0))
            finish = start + 1.0 / max(w, 1e-9)
            self._finish[req.tenant] = finish
            band = (req.slo, conforming)
        else:                         # QoS off: one global FIFO
            finish = float(self._fifo_seq)
            band = _BANDS[0]
        heapq.heappush(self._q[band], (finish, self._fifo_seq, req))
        self._queued_seqs.add(req.seq)
        if req.deadline_ms is not None and math.isfinite(req.deadline_ms):
            heapq.heappush(self._deadlines, (req.deadline_ms, req.seq))
        return conforming

    def pop(self) -> Optional[Request]:
        for band in _BANDS:
            q = self._q[band]
            if q:
                finish, _, req = heapq.heappop(q)
                if self.qos:
                    # V advances to the dequeued request's start tag
                    w = float(self.weights.get(req.tenant, 1.0))
                    self._vtime = max(self._vtime, finish - 1.0 / max(w, 1e-9))
                self._queued_seqs.discard(req.seq)
                return req
        return None

    def earliest_deadline(self) -> float:
        """Smallest absolute deadline over everything still queued
        (``inf`` when nothing queued carries a deadline)."""
        while self._deadlines and \
                self._deadlines[0][1] not in self._queued_seqs:
            heapq.heappop(self._deadlines)       # already dispatched
        return self._deadlines[0][0] if self._deadlines else math.inf

"""The concurrent serving runtime: event-loop scheduler over a LatentBox.

This is the layer the paper's production trace implies but the per-window
engine never had: timestamped requests from an *open-loop* arrival process
are admitted into a central per-tenant queue that feeds the decode plant
*continuously* — a microbatch closes when a size bucket fills OR when the
oldest queued deadline's slack forces dispatch, never on a fixed window
boundary.  On top of that loop sit per-tenant QoS (token buckets +
weighted-fair dequeue), SLO classes (``interactive`` vs ``batch`` with
distinct deadlines), and SLO-aware admission control that sheds or
degrades batch-class work under overload instead of letting every class's
tail collapse together.

Determinism: the scheduler runs on a simulated clock
(:class:`~repro.serve.runtime.events.EventLoop`) and a virtual service
model, so a stream replay is bit-reproducible on both backends; the
engine backend still produces *real* pixels inside each dispatch via the
continuous-feed ``admit``/``dispatch`` path of the ``DecodeBatcher``.

Conformance contract (locked in ``tests/test_serving_runtime.py``): with
``RuntimeConfig.conformance()`` — QoS off, admission off, drain-mode
schedule — the runtime dequeues FIFO in full ``max(buckets)`` groups,
which is exactly the legacy ``serve_window`` grouping, so every request
classifies identically to the per-window path and engine pixels are
bit-exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import RequestLog
from repro_torch.serve.runtime.admission import (ADMIT, AdmissionConfig,
                                           AdmissionController, DEFER,
                                           DEGRADE, SHED)
from repro_torch.serve.runtime.events import (EventLoop, Request, SLO_BATCH,
                                        SLO_INTERACTIVE)
from repro_torch.serve.runtime.qos import FairQueue
from repro_torch.store.api import FULL_MISS, IMAGE_HIT, LATENT_HIT, REGEN_MISS


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs of the serving runtime (scheduler + QoS + admission + the
    virtual service model used for deterministic timeline accounting)."""

    #: Microbatch size buckets (mirrors ``StoreConfig.decode_buckets``);
    #: a batch closes as soon as ``max(buckets)`` requests are queued.
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    #: Weighted-fair per-tenant dequeue + token buckets.  Off = global FIFO.
    qos: bool = True
    #: Drain-mode schedule: ignore arrival pacing and deadlines, dequeue
    #: FIFO in full buckets — the legacy ``serve_window`` grouping.
    #: Implies ``qos=False`` and disables admission control.
    drain: bool = False
    # -- SLO classes ---------------------------------------------------------
    interactive_deadline_ms: float = 250.0
    batch_deadline_ms: float = 4000.0
    #: Safety margin subtracted from the deadline-forced dispatch time.
    slack_margin_ms: float = 4.0
    # -- per-tenant QoS ------------------------------------------------------
    tenant_weights: Dict[int, float] = dataclasses.field(default_factory=dict)
    #: Token-bucket contracted rate per tenant (requests/s); ``None``
    #: disables rate classification (every request conforms).
    tenant_rate_rps: Optional[float] = None
    tenant_burst: float = 8.0
    # -- admission control ---------------------------------------------------
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    # -- virtual service model (ms, simulated clock) -------------------------
    net_ms: float = 10.0
    fetch_ms: float = 45.0              # durable fetch (overlapped per batch)
    regen_ms: float = 3905.0            # full generation pipeline on regen
    decode_fixed_ms: float = 12.0       # per-dispatch overhead
    decode_per_image_ms: float = 8.0    # per real decoded image
    #: EWMA smoothing of the measured per-request service time feeding the
    #: admission controller's wait predictions.
    service_ewma: float = 0.3
    #: Keep engine pixels per request in the report (tests only — O(n) RAM).
    keep_payloads: bool = False

    def deadline_budget_of(self, slo: str) -> float:
        return (self.interactive_deadline_ms if slo == SLO_INTERACTIVE
                else self.batch_deadline_ms)

    @property
    def max_bucket(self) -> int:
        return max(self.buckets)

    @classmethod
    def conformance(cls, **kw) -> "RuntimeConfig":
        """Drain-mode config of the conformance guarantee: FIFO full-bucket
        dispatch, no QoS, no admission — classification must equal the
        legacy ``serve_window`` path request-for-request."""
        kw.setdefault("drain", True)
        kw.setdefault("qos", False)
        kw.setdefault("admission", AdmissionConfig(enabled=False))
        return cls(**kw)

    @classmethod
    def from_store(cls, store_cfg, **kw) -> "RuntimeConfig":
        """Derive the service model from a ``StoreConfig``'s plant half so
        runtime timelines and the simulator's latency plant agree on
        nominal costs (decode splits 40/60 into per-dispatch overhead and
        per-image work, which makes an 8-batch ~2.4x cheaper per image
        than singles — the reason microbatching exists)."""
        kw.setdefault("buckets", tuple(store_cfg.decode_buckets))
        kw.setdefault("net_ms", store_cfg.net_ms)
        kw.setdefault("regen_ms", store_cfg.generation_ms)
        kw.setdefault("decode_fixed_ms", 0.4 * store_cfg.decode_ms)
        kw.setdefault("decode_per_image_ms", 0.6 * store_cfg.decode_ms)
        kw.setdefault("fetch_ms", store_cfg.store_latency.warm_ms)
        return cls(**kw)


class FacadeService:
    """Microbatch service over anything with ``get_many`` (a ``LatentBox``
    facade, a bare backend, or the sharded cluster)."""

    def __init__(self, target):
        self.target = target

    def serve(self, oids: Sequence[int]):
        return self.target.get_many(list(oids))

    def pixels_resident(self, oid: int) -> bool:
        probe = getattr(self.target, "pixels_resident", None)
        return bool(probe(oid)) if probe is not None else False


class EngineStreamService:
    """Continuous-feed service over a :class:`ServingEngine`: admissions
    enqueue straight into the real ``DecodeBatcher`` (single-flight
    coalescing included) and one ``dispatch`` flushes the microbatch the
    scheduler closed — no fixed window anywhere."""

    def __init__(self, engine):
        self.engine = engine

    def serve(self, oids: Sequence[int]):
        tickets = [self.engine.admit(oid) for oid in oids]
        self.engine.dispatch()
        return [_Served(t.outcome, t.owner.idx, t.img) for t in tickets]

    def pixels_resident(self, oid: int) -> bool:
        return self.engine.walk.pixels_resident(oid)


@dataclasses.dataclass
class _Served:
    hit_class: str
    node: int
    payload: Any = None


@dataclasses.dataclass
class StreamReport:
    """Outcome of one stream replay through the runtime."""

    log: RequestLog
    #: Per-request ``(hit_class, node)`` in ARRIVAL order (shed requests
    #: report ``("shed", -1)``, degraded ``("degraded", -1)``) — the
    #: drain-mode signature compared against the legacy window path.
    outcomes: List[Tuple[str, int]]
    counters: Dict[str, float]
    makespan_ms: float = 0.0
    #: seq -> decoded pixels (engine + ``keep_payloads`` only).
    payloads: Optional[Dict[int, Any]] = None

    def summary(self) -> Dict[str, Any]:
        out = dict(self.counters)
        out["makespan_ms"] = self.makespan_ms
        out.update(self.log.summarize())
        out.update(self.log.slo_summary())
        return out


def requests_from_trace(trace, tenant_by_model: Optional[bool] = None,
                        default_slo: str = SLO_INTERACTIVE,
                        limit: Optional[int] = None) -> List[Request]:
    """Turn a :class:`~repro.trace.synth.SyntheticTrace` into runtime
    requests.  ``tenant_by_model=None`` auto-detects: scenarios that carry
    per-object SLO classes (``multi_tenant``) use ``model_ids`` as tenant
    ids, everything else is single-tenant.  Per-object ``slo_class``
    (0=interactive, 1=batch) overrides ``default_slo``."""
    slo_arr = getattr(trace, "slo_class", None)
    if tenant_by_model is None:
        tenant_by_model = slo_arr is not None
    ids = trace.object_ids if limit is None else trace.object_ids[:limit]
    ts = trace.timestamps if limit is None else trace.timestamps[:limit]
    reqs = []
    for k, (oid, t) in enumerate(zip(ids, ts)):
        oid = int(oid)
        slo = default_slo
        if slo_arr is not None and slo_arr[oid]:
            slo = SLO_BATCH
        reqs.append(Request(
            oid=oid, arrival_ms=float(t) * 1e3, seq=k,
            tenant=int(trace.model_ids[oid]) if tenant_by_model else 0,
            slo=slo))
    return reqs


class ServingRuntime:
    """Deterministic event-loop scheduler feeding one decode plant."""

    def __init__(self, service, cfg: Optional[RuntimeConfig] = None):
        self.service = service
        self.cfg = cfg or RuntimeConfig()

    @classmethod
    def for_engine(cls, engine, cfg=None) -> "ServingRuntime":
        return cls(EngineStreamService(engine), cfg)

    @classmethod
    def for_target(cls, target, cfg=None) -> "ServingRuntime":
        return cls(FacadeService(target), cfg)

    # -- one replay ----------------------------------------------------------

    def run(self, requests) -> StreamReport:
        cfg = self.cfg
        if hasattr(requests, "object_ids"):       # a SyntheticTrace
            requests = requests_from_trace(requests)
        reqs = self._normalize(requests)

        self.loop = EventLoop()
        self.queue = FairQueue(
            qos=cfg.qos and not cfg.drain,
            weights=cfg.tenant_weights,
            rate_rps=None if cfg.drain else cfg.tenant_rate_rps,
            burst=cfg.tenant_burst)
        adm_cfg = cfg.admission if not cfg.drain \
            else dataclasses.replace(cfg.admission, enabled=False)
        self.admission = AdmissionController(adm_cfg, cfg.deadline_budget_of)
        self.log = RequestLog()
        self.outcomes: List[Tuple[str, int]] = [("", -1)] * len(reqs)
        self.payloads: Optional[Dict[int, Any]] = \
            {} if cfg.keep_payloads else None
        self._deferred: List[Request] = []
        self._arrivals_left = len(reqs)
        self._serving = False
        self._busy_until = 0.0
        self._force_at: Optional[float] = None
        # initial per-request service estimate: a full decode bucket
        self._svc_ewma = (cfg.decode_fixed_ms / cfg.max_bucket
                          + cfg.decode_per_image_ms)
        self.counters: Dict[str, float] = {
            "served": 0, "shed": 0, "degraded": 0, "deferred": 0,
            "dispatches": 0, "forced_dispatches": 0, "full_dispatches": 0,
            "batched_requests": 0, "deadline_misses": 0,
            "qos": float(self.queue.qos),
        }

        for r in reqs:
            self.loop.at(r.arrival_ms, lambda r=r: self._on_arrival(r))
        makespan = self.loop.run()
        self.counters["over_rate_arrivals"] = self.queue.n_over_rate
        return StreamReport(log=self.log, outcomes=self.outcomes,
                            counters=self.counters, makespan_ms=makespan,
                            payloads=self.payloads)

    def _normalize(self, requests: Sequence[Request]) -> List[Request]:
        cfg = self.cfg
        out = []
        for k, r in enumerate(requests):
            seq = r.seq if r.seq >= 0 else k
            arrival = 0.0 if cfg.drain else r.arrival_ms
            deadline = math.inf if cfg.drain else (
                r.deadline_ms if r.deadline_ms is not None
                else arrival + cfg.deadline_budget_of(r.slo))
            out.append(dataclasses.replace(
                r, seq=seq, arrival_ms=arrival, deadline_ms=deadline))
        return out

    # -- event handlers ------------------------------------------------------

    def _on_arrival(self, req: Request) -> None:
        self._arrivals_left -= 1
        decision = self.admission.decide(
            req, queued=len(self.queue),
            predicted_wait_ms=self._predicted_wait())
        if decision == SHED:
            self._record_rejected(req, "shed")
        elif decision == DEGRADE:
            # pixel-cache-only answer: stale-but-displayable now, or shed
            if self.service.pixels_resident(req.oid):
                self._record_rejected(req, "degraded")
            else:
                self._record_rejected(req, "shed")
        elif decision == DEFER:
            self.counters["deferred"] += 1
            self._deferred.append(req)
        else:
            assert decision == ADMIT
            self.queue.push(req, self.loop.now)
        self._maybe_dispatch()

    def _on_free(self) -> None:
        self._serving = False
        self._maybe_dispatch()

    def _on_force(self) -> None:
        self._force_at = None
        self._maybe_dispatch()

    # -- scheduling ----------------------------------------------------------

    def _predicted_wait(self) -> float:
        """Queueing-delay estimate for a request arriving now: remaining
        busy horizon plus the backlog at the measured per-request rate."""
        busy = max(0.0, self._busy_until - self.loop.now) \
            if self._serving else 0.0
        return busy + len(self.queue) * self._svc_ewma

    def _est_service(self, n: int) -> float:
        """Worst-case service estimate for dispatching ``n`` queued
        requests now (durable fetch + a padded decode) — used for the
        deadline-forced dispatch time, so conservative is safe: firing
        early shrinks the batch but never misses the deadline."""
        n = min(n, self.cfg.max_bucket)
        return (self.cfg.fetch_ms + self.cfg.decode_fixed_ms
                + self.cfg.decode_per_image_ms * n)

    def _maybe_dispatch(self) -> None:
        if self._serving:
            return
        if len(self.queue) == 0 and self._deferred:
            # the plant is idle and nothing admitted waits: drain deferred
            # batch work a bucketful at a time
            for r in self._deferred[:self.cfg.max_bucket]:
                self.queue.push(r, self.loop.now)
            del self._deferred[:self.cfg.max_bucket]
        qlen = len(self.queue)
        if qlen == 0:
            return
        if qlen >= self.cfg.max_bucket:           # a size bucket filled
            self._dispatch(self.cfg.max_bucket, forced=False)
            return
        if self.cfg.drain:
            if self._arrivals_left == 0:          # final partial bucket
                self._dispatch(qlen, forced=False)
            return
        t_force = (self.queue.earliest_deadline() - self._est_service(qlen)
                   - self.cfg.net_ms - self.cfg.slack_margin_ms)
        if self._arrivals_left == 0 or self.loop.now >= t_force:
            self._dispatch(qlen, forced=True)
            return
        if math.isfinite(t_force) and (self._force_at is None
                                       or t_force < self._force_at - 1e-9):
            self._force_at = t_force
            self.loop.at(t_force, self._on_force)

    def _dispatch(self, k: int, forced: bool) -> None:
        members = [self.queue.pop() for _ in range(k)]
        results = self.service.serve([m.oid for m in members])
        t0 = self.loop.now
        svc = self._service_ms(results)
        self._serving = True
        self._busy_until = t0 + svc
        self.counters["dispatches"] += 1
        self.counters["batched_requests"] += k
        if forced:
            self.counters["forced_dispatches"] += 1
        if k >= self.cfg.max_bucket:
            self.counters["full_dispatches"] += 1
        for m, r in zip(members, results):
            self._complete(m, r, t0, svc)
        a = self.cfg.service_ewma
        self._svc_ewma = (1 - a) * self._svc_ewma + a * (svc / k)
        self.loop.at(self._busy_until, self._on_free)

    # -- completion / accounting --------------------------------------------

    def _service_ms(self, results) -> float:
        """Virtual service time of one dispatched group: fetches overlap
        (one fetch latency covers the batch), regenerations serialize on
        the plant (the generation pipeline owns the GPU), and the decode
        pays a fixed dispatch cost plus a per-real-image cost."""
        cfg = self.cfg
        n_regen = sum(1 for r in results if r.hit_class == REGEN_MISS)
        n_dec = sum(1 for r in results
                    if r.hit_class in (LATENT_HIT, FULL_MISS))
        svc = 0.0
        if any(r.hit_class == FULL_MISS for r in results):
            svc += cfg.fetch_ms
        svc += n_regen * cfg.regen_ms
        if n_dec:
            svc += cfg.decode_fixed_ms + cfg.decode_per_image_ms * n_dec
        return svc

    def _complete(self, m: Request, r, t0: float, svc: float) -> None:
        cfg = self.cfg
        is_hit = r.hit_class == IMAGE_HIT
        done = t0 + (0.0 if is_hit else svc) + cfg.net_ms
        met = done <= m.deadline_ms
        self.counters["served"] += 1
        if not met:
            self.counters["deadline_misses"] += 1
        self.log.add(
            m.arrival_ms, done - m.arrival_ms, r.hit_class,
            fetch_ms=cfg.fetch_ms if r.hit_class == FULL_MISS else 0.0,
            decode_ms=0.0 if is_hit else (
                cfg.regen_ms if r.hit_class == REGEN_MISS
                else cfg.decode_per_image_ms),
            net_ms=cfg.net_ms, node=r.node,
            queue_delay_ms=t0 - m.arrival_ms, tenant=m.tenant, slo=m.slo,
            deadline_ms=m.deadline_ms, deadline_met=met)
        self.outcomes[m.seq] = (r.hit_class, r.node)
        if self.payloads is not None and r.payload is not None:
            self.payloads[m.seq] = r.payload

    def _record_rejected(self, req: Request, outcome: str) -> None:
        """A request admission refused: ``shed`` (no answer) or
        ``degraded`` (immediate stale pixels, no decode spent)."""
        cfg = self.cfg
        served_now = outcome == "degraded"
        latency = cfg.net_ms if served_now else 0.0
        done = self.loop.now + latency
        met = served_now and done <= req.deadline_ms
        self.counters[outcome] += 1
        if not met:
            self.counters["deadline_misses"] += 1
        self.log.add(req.arrival_ms, latency, outcome,
                     net_ms=cfg.net_ms if served_now else 0.0,
                     queue_delay_ms=0.0, tenant=req.tenant, slo=req.slo,
                     deadline_ms=req.deadline_ms, deadline_met=met)
        self.outcomes[req.seq] = (outcome, -1)

"""SLO-aware admission control: shed or degrade batch work under overload.

Following the web-serving argument of the related work (degrade quality
rather than miss deadlines), the controller never rejects interactive
traffic — it protects the interactive SLO by acting on the *batch* class
as soon as the predicted queueing delay would blow through the deadline
budget.  Three policies:

* ``shed``    — reject the batch request outright (client retries later);
* ``degrade`` — answer immediately from the pixel cache if the object is
  resident (a possibly stale but displayable image, no decode spent);
  shed when it is not;
* ``defer``   — park the request on a side queue that only drains when
  the plant is underloaded (decode deferred, deadline likely missed but
  the work is not lost).

Overload is a *prediction*, not a queue-length threshold: the runtime
feeds the controller its current busy horizon plus an EWMA of measured
per-request service time, and the controller compares the resulting wait
estimate against ``headroom x deadline`` for the arriving class.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serve.runtime.events import Request, SLO_INTERACTIVE

ADMIT, SHED, DEGRADE, DEFER = "admit", "shed", "degrade", "defer"
POLICIES = (SHED, DEGRADE, DEFER)


@dataclasses.dataclass
class AdmissionConfig:
    enabled: bool = True
    policy: str = DEGRADE               # one of POLICIES
    #: Fraction of a class's deadline budget the predicted wait may
    #: consume before its (batch-class) arrivals are shed/degraded.
    headroom: float = 0.7
    #: Never shed while fewer requests than this are queued — a full
    #: microbatch of backlog is normal operation, not overload.
    min_backlog: int = 8

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: "
                             f"{self.policy!r}")


class AdmissionController:
    """Stateless decision point; all load state arrives per call."""

    def __init__(self, cfg: AdmissionConfig, deadline_budget_of):
        """``deadline_budget_of(slo) -> ms``: the class's relative
        deadline (interactive/batch), from the runtime config."""
        self.cfg = cfg
        self._budget_of = deadline_budget_of
        self.counts = {SHED: 0, DEGRADE: 0, DEFER: 0}

    def decide(self, req: Request, queued: int,
               predicted_wait_ms: float) -> str:
        """Admit/shed/degrade/defer one arrival.

        ``predicted_wait_ms`` is the runtime's estimate of how long this
        request would sit in queue (busy horizon + backlog x EWMA service
        time).  Interactive requests always admit — the whole point is to
        confine degradation to the batch class.
        """
        if not self.cfg.enabled or req.slo == SLO_INTERACTIVE:
            return ADMIT
        if queued < self.cfg.min_backlog:
            return ADMIT
        budget = self.cfg.headroom * float(self._budget_of(req.slo))
        if predicted_wait_ms <= budget:
            return ADMIT
        self.counts[self.cfg.policy] += 1
        return self.cfg.policy

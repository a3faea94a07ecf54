"""Concurrent serving runtime: deterministic event-loop scheduler with
per-tenant QoS and SLO-aware admission control (see ``runtime.py``)."""

from repro_torch.serve.runtime.admission import (ADMIT, AdmissionConfig,
                                           AdmissionController, DEFER,
                                           DEGRADE, POLICIES, SHED)
from repro_torch.serve.runtime.events import (EventLoop, Request, SLO_BATCH,
                                        SLO_CLASSES, SLO_INTERACTIVE)
from repro_torch.serve.runtime.qos import FairQueue, TokenBucket
from repro_torch.serve.runtime.runtime import (EngineStreamService, FacadeService,
                                         RuntimeConfig, ServingRuntime,
                                         StreamReport, requests_from_trace)

__all__ = [
    "ADMIT", "SHED", "DEGRADE", "DEFER", "POLICIES",
    "AdmissionConfig", "AdmissionController",
    "EventLoop", "Request", "SLO_BATCH", "SLO_CLASSES", "SLO_INTERACTIVE",
    "FairQueue", "TokenBucket",
    "EngineStreamService", "FacadeService", "RuntimeConfig",
    "ServingRuntime", "StreamReport", "requests_from_trace",
]

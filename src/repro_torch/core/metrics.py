"""Latency/hit metrics accumulators shared by the simulator, the serving
runtime, and the benchmarks."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

OUTCOME_CODES = {"image_hit": 0, "latent_hit": 1, "full_miss": 2,
                 "regen_miss": 3,           # recipe-only object regenerated
                 "shed": 4,                 # admission rejected (no answer)
                 "degraded": 5}             # stale pixel-cache answer
OUTCOME_NAMES = {v: k for k, v in OUTCOME_CODES.items()}
#: Outcomes that produced a (full-quality) serving-path answer; shed and
#: degraded entries are excluded from latency percentiles.
SERVED_MAX_CODE = 3

SLO_CODES = {"interactive": 0, "batch": 1}
SLO_NAMES = {v: k for k, v in SLO_CODES.items()}


@dataclasses.dataclass
class RequestLog:
    """Columnar per-request log (numpy-friendly).

    The serving-runtime columns (``queue_delay_ms``, ``tenant``, ``slo``,
    ``deadline_ms``, ``deadline_met``) default so that closed-loop callers
    (cluster replay, backends) keep their historical ``add`` signature.
    ``queue_ms`` remains the *plant*-side queueing component (GPU queue
    inside the latency model); ``queue_delay_ms`` is the scheduler-side
    delay between arrival and microbatch dispatch.
    """

    arrival_ms: List[float] = dataclasses.field(default_factory=list)
    latency_ms: List[float] = dataclasses.field(default_factory=list)
    outcome: List[int] = dataclasses.field(default_factory=list)
    queue_ms: List[float] = dataclasses.field(default_factory=list)
    fetch_ms: List[float] = dataclasses.field(default_factory=list)
    decode_ms: List[float] = dataclasses.field(default_factory=list)
    net_ms: List[float] = dataclasses.field(default_factory=list)
    spilled: List[bool] = dataclasses.field(default_factory=list)
    coalesced: List[bool] = dataclasses.field(default_factory=list)
    node: List[int] = dataclasses.field(default_factory=list)
    queue_delay_ms: List[float] = dataclasses.field(default_factory=list)
    tenant: List[int] = dataclasses.field(default_factory=list)
    slo: List[int] = dataclasses.field(default_factory=list)
    deadline_ms: List[float] = dataclasses.field(default_factory=list)
    deadline_met: List[bool] = dataclasses.field(default_factory=list)

    def add(self, arrival_ms: float, latency_ms: float, outcome: str,
            queue_ms: float = 0.0, fetch_ms: float = 0.0,
            decode_ms: float = 0.0, net_ms: float = 0.0,
            spilled: bool = False, coalesced: bool = False,
            node: int = -1, queue_delay_ms: float = 0.0,
            tenant: int = 0, slo: str = "interactive",
            deadline_ms: float = math.inf,
            deadline_met: bool = True) -> None:
        self.arrival_ms.append(arrival_ms)
        self.latency_ms.append(latency_ms)
        self.outcome.append(OUTCOME_CODES[outcome])
        self.queue_ms.append(queue_ms)
        self.fetch_ms.append(fetch_ms)
        self.decode_ms.append(decode_ms)
        self.net_ms.append(net_ms)
        self.spilled.append(spilled)
        self.coalesced.append(coalesced)
        self.node.append(node)
        self.queue_delay_ms.append(queue_delay_ms)
        self.tenant.append(tenant)
        self.slo.append(SLO_CODES[slo])
        self.deadline_ms.append(deadline_ms)
        self.deadline_met.append(deadline_met)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {f.name: np.asarray(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def summarize(self) -> Dict[str, float]:
        lat = np.asarray(self.latency_ms)
        out = np.asarray(self.outcome)
        n = len(lat)
        if n == 0:
            return {"n": 0}
        served = out <= SERVED_MAX_CODE   # shed/degraded never decode; their
        #                                   latencies would pollute the tail
        slat = lat[served] if served.any() else lat
        summary = {
            "n": float(n),
            "mean_ms": float(slat.mean()),
            "p50_ms": float(np.percentile(slat, 50)),
            "p95_ms": float(np.percentile(slat, 95)),
            "p99_ms": float(np.percentile(slat, 99)),
            "image_hit_frac": float(np.mean(out == 0)),
            "latent_hit_frac": float(np.mean(out == 1)),
            "full_miss_frac": float(np.mean(out == 2)),
            "regen_miss_frac": float(np.mean(out == 3)),
            "spill_frac": float(np.mean(self.spilled)) if self.spilled else 0.0,
            "coalesced_frac": float(np.mean(self.coalesced)) if self.coalesced else 0.0,
        }
        if (out > SERVED_MAX_CODE).any():
            summary["shed_frac"] = float(np.mean(out == 4))
            summary["degraded_frac"] = float(np.mean(out == 5))
        # Fig 7c/d-style breakdowns
        for code, name in OUTCOME_NAMES.items():
            mask = out == code
            if mask.any():
                for col in ("queue_ms", "fetch_ms", "decode_ms", "net_ms",
                            "latency_ms"):
                    v = np.asarray(getattr(self, col))[mask]
                    summary[f"{name}.{col.replace('_ms', '')}_ms"] = float(v.mean())
        hit_mask = out < 2               # both miss classes (durable, regen)
        #                                  pay the slow path; neither is a hit
        if hit_mask.any():
            summary["hit.queue_ms"] = float(
                np.asarray(self.queue_ms)[hit_mask].mean())
        return summary

    def slo_summary(self) -> Dict[str, float]:
        """Per-SLO-class and per-tenant accounting of a stream replay:
        latency/queue-delay percentiles over served requests plus SLO
        attainment (fraction of the class that met its deadline — shed
        requests count as misses, degraded answers count by whether the
        stale answer landed in budget)."""
        if not self.latency_ms:
            return {}
        out = np.asarray(self.outcome)
        lat = np.asarray(self.latency_ms)
        qd = np.asarray(self.queue_delay_ms)
        met = np.asarray(self.deadline_met)
        slo = np.asarray(self.slo)
        tenant = np.asarray(self.tenant)
        served = out <= SERVED_MAX_CODE
        summary: Dict[str, float] = {}
        for code, name in SLO_NAMES.items():
            cls = slo == code
            if not cls.any():
                continue
            summary[f"{name}.n"] = float(cls.sum())
            summary[f"{name}.slo_attainment"] = float(met[cls].mean())
            summary[f"{name}.shed_frac"] = float(np.mean(out[cls] == 4))
            summary[f"{name}.degraded_frac"] = float(np.mean(out[cls] == 5))
            cs = cls & served
            if cs.any():
                summary[f"{name}.p50_ms"] = float(np.percentile(lat[cs], 50))
                summary[f"{name}.p99_ms"] = float(np.percentile(lat[cs], 99))
                summary[f"{name}.queue_delay_p50_ms"] = float(
                    np.percentile(qd[cs], 50))
                summary[f"{name}.queue_delay_p99_ms"] = float(
                    np.percentile(qd[cs], 99))
        for t in np.unique(tenant):
            ts = tenant == t
            summary[f"tenant{int(t)}.n"] = float(ts.sum())
            summary[f"tenant{int(t)}.slo_attainment"] = float(met[ts].mean())
            tss = ts & served
            if tss.any():
                summary[f"tenant{int(t)}.p99_ms"] = float(
                    np.percentile(lat[tss], 99))
        return summary


def percentiles(values, ps=(50, 95, 99)) -> Dict[str, float]:
    arr = np.asarray(values, dtype=np.float64)
    out = {"mean": float(arr.mean())} if len(arr) else {"mean": float("nan")}
    for p in ps:
        out[f"p{p}"] = float(np.percentile(arr, p)) if len(arr) else float("nan")
    return out

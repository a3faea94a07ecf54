"""Fast cache-only trace replay (paper §6.5's trace-driven simulator).

No queueing plant — each request costs exactly its outcome's latency
(image hit 0, latent hit T_decode, full miss T_decode + T_fetch), matching
the simulation methodology of the paper's sensitivity study (§6.5:
T_decode = 40 ms, T_fetch = 140 ms).  This is what makes multi-million-
request parameter sweeps tractable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dual_cache import (DualFormatCache, FULL_MISS, IMAGE_HIT,
                                   LATENT_HIT)
from repro_torch.core.latent_store import DEFAULT_OBJECT_BYTES
from repro_torch.core.tuner import MarginalHitTuner, TunerConfig, TunerRecord


@dataclasses.dataclass
class ReplayConfig:
    cache_bytes: float = 2e9
    alpha0: float = 0.5
    adaptive: bool = True
    tau: float = 0.10
    promote_threshold: int = 8
    admit_on_miss: str = "latent"
    image_bytes: float = 1.4e6
    latent_bytes: float = DEFAULT_OBJECT_BYTES
    t_decode_ms: float = 40.0
    t_fetch_ms: float = 140.0
    tuner: TunerConfig = dataclasses.field(
        default_factory=lambda: TunerConfig(window=1_000_000))


@dataclasses.dataclass
class ReplayResult:
    n: int
    mean_ms: float
    image_hit_frac: float
    latent_hit_frac: float
    full_miss_frac: float
    decode_trigger_frac: float          # fraction of requests touching a GPU
    alpha_final: float
    history: List[TunerRecord]
    window_mean_ms: np.ndarray          # per-window mean latency
    window_alpha: np.ndarray

    def as_dict(self) -> Dict[str, float]:
        return {
            "n": self.n, "mean_ms": self.mean_ms,
            "image_hit_frac": self.image_hit_frac,
            "latent_hit_frac": self.latent_hit_frac,
            "full_miss_frac": self.full_miss_frac,
            "decode_trigger_frac": self.decode_trigger_frac,
            "alpha_final": self.alpha_final,
        }


def replay(object_ids: np.ndarray, cfg: Optional[ReplayConfig] = None,
           limit: Optional[int] = None) -> ReplayResult:
    cfg = cfg or ReplayConfig()
    cache = DualFormatCache(
        cfg.cache_bytes, alpha=cfg.alpha0, tau=cfg.tau,
        promote_threshold=cfg.promote_threshold,
        image_size_fn=lambda oid: cfg.image_bytes,
        latent_size_fn=lambda oid: cfg.latent_bytes)
    tcfg = dataclasses.replace(cfg.tuner, t_decode_ms=cfg.t_decode_ms,
                               t_fetch_ms=cfg.t_fetch_ms)
    tuner = MarginalHitTuner(cache, tcfg) if cfg.adaptive else None

    ids = np.asarray(object_ids)
    n = len(ids) if limit is None else min(limit, len(ids))
    t_dec, t_fet = cfg.t_decode_ms, cfg.t_fetch_ms
    admit_image = cfg.admit_on_miss == "image"

    total_ms = 0.0
    n_img = n_lat = n_miss = 0
    win_cost = 0.0
    win_n = 0
    window = tcfg.window
    window_means: List[float] = []
    window_alphas: List[float] = []

    lookup = cache.lookup
    admit = cache.insert_image if admit_image else cache.admit_latent
    on_request = tuner.on_request if tuner is not None else None

    for i in range(n):
        oid = int(ids[i])
        res = lookup(oid)
        o = res.outcome
        if o == IMAGE_HIT:
            cost = 0.0
            n_img += 1
        elif o == LATENT_HIT:
            cost = t_dec
            n_lat += 1
        else:
            cost = t_dec + t_fet
            n_miss += 1
            admit(oid)
        total_ms += cost
        win_cost += cost
        win_n += 1
        if on_request is not None:
            rec = on_request()
        else:
            rec = None
        if win_n >= window:
            window_means.append(win_cost / win_n)
            window_alphas.append(cache.alpha)
            win_cost = 0.0
            win_n = 0
        del rec

    if win_n:
        window_means.append(win_cost / win_n)
        window_alphas.append(cache.alpha)

    return ReplayResult(
        n=n, mean_ms=total_ms / max(1, n),
        image_hit_frac=n_img / max(1, n),
        latent_hit_frac=n_lat / max(1, n),
        full_miss_frac=n_miss / max(1, n),
        decode_trigger_frac=(n_lat + n_miss) / max(1, n),
        alpha_final=cache.alpha,
        history=tuner.history if tuner else [],
        window_mean_ms=np.asarray(window_means),
        window_alpha=np.asarray(window_alphas))


def replay_scenario(scenario: str, cfg: Optional[ReplayConfig] = None,
                    limit: Optional[int] = None,
                    **trace_knobs) -> ReplayResult:
    """Replay a named workload from the scenario suite
    (:func:`repro.trace.synth.make_trace`) through the cache-only
    simulator: ``replay_scenario("zipf_drift", n_objects=2_000, ...)``."""
    from repro_torch.trace.synth import make_trace
    tr = make_trace(scenario, **trace_knobs)
    return replay(tr.object_ids, cfg, limit=limit)


def sweep_static_alpha(object_ids: np.ndarray, alphas,
                       base: Optional[ReplayConfig] = None,
                       limit: Optional[int] = None
                       ) -> Dict[float, ReplayResult]:
    """§6.5.2: static-allocation oracle sweep."""
    base = base or ReplayConfig()
    out = {}
    for a in alphas:
        cfg = dataclasses.replace(base, alpha0=float(a), adaptive=False)
        out[float(a)] = replay(object_ids, cfg, limit=limit)
    return out
